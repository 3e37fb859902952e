"""The port's upsample + CE kernels of this checkout against those of
another checkout of the port (each built from its own
``afan_torch/csrc/resize_ce.cu``), on whole maps (no row window), f32 and
bf16 logits, at six geometries: every output bit for bit, on one CUDA card.

    mkdir -p build/parent && git archive HEAD afan_torch | tar -x -C build/parent
    python3 scripts/torch_resize_ce_bits.py build/parent

Each checkout's kernels run in a process of their own, which saves the
outputs under ``build/``.
"""
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CASES = [(4, (192, 192), (768, 768), 19, None),
         (8, (192, 192), (768, 768), 19, None),
         (4, (129, 129), (513, 513), 21, None),
         (2, (33, 65), (129, 257), 5, (1.0, 2.0)),
         (1, (9, 7), (33, 28), 3, None),
         (2, (6, 5), (24, 20), 21, (0.5, 1.5))]
CHILD = r'''
import sys, torch, numpy as np
from afan_torch.ops.kernels import resize_ce as k
out = {}
for i, (b, hw, HW, c, focal) in enumerate(CASES):
    rng = np.random.RandomState(i)
    for dt in (torch.float32, torch.bfloat16):
        lo = torch.from_numpy(rng.randn(b, c, *hw).astype(np.float32)).cuda().to(dt)
        lab = rng.randint(0, c, (b, *HW)).astype(np.int32)
        lab[:, :3, :3] = 255
        lab = torch.from_numpy(lab).cuda()
        g = torch.linspace(0.5, 1.5, b, device="cuda")
        out[f"{i}_{dt}_fwd"] = k.resize_ce_forward(lo, lab, focal).cpu()
        out[f"{i}_{dt}_bwd"] = k.resize_ce_backward(lo, lab, g, focal).cpu()
torch.cuda.synchronize()
torch.save(out, sys.argv[1])
'''


def run(root, path):
    env = dict(os.environ, PYTHONPATH=root)
    code = f"CASES = {CASES!r}\n" + CHILD
    subprocess.run([sys.executable, "-c", code, path], cwd=root, env=env,
                   check=True, timeout=600)


def main():
    import torch
    other = os.path.abspath(sys.argv[1])
    run(other, os.path.join(HERE, "build", "bits_parent.pt"))
    run(HERE, os.path.join(HERE, "build", "bits_child.pt"))
    a = torch.load(os.path.join(HERE, "build", "bits_parent.pt"))
    b = torch.load(os.path.join(HERE, "build", "bits_child.pt"))
    same = {k: bool(torch.equal(a[k], b[k])) for k in a}
    print(same)
    print("all bit-equal:", all(same.values()), len(same), "outputs")
    if not all(same.values()):
        sys.exit(1)


if __name__ == "__main__":
    main()
