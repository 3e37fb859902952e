"""Smoke run of the PyTorch port (afan_torch) on one CUDA card.

Run from the repository root, with one card and no arguments:

    python3 chip_smoke.py

Phases (any failure exits non-zero):
  1. the device: name, power limit, TF32 settings;
  2. build the hand-written CUDA kernels from afan_torch/csrc (nvcc);
  3. hold the greedy-NMS kernel against its plain PyTorch version on the
     card: the reference's golden fixture, uniform and clustered boxes,
     invalid slots, plus_one off, a batched call — keep masks equal;
  4. serve frames through the detection server's FrameBatcher with the
     ResNet-50 Faster R-CNN at full width (seeded random weights, 21 VOC
     classes, canvas 608x1008, max_batch 4), in batches of 1 and 4, and
     check the answers and that the main path launched the kernel;
  5. hold the post-backbone path with the kernel against the same path with
     the plain NMS: proposals and keep masks identical;
  6. time the detect call, the kernel and its plain version with CUDA
     events, and the peak memory.

The line before the last lists each kernel with its launches on the main
path, its largest disagreement with the plain version, its time, the plain
version's time and its bound; the last line is the device summary.
"""
import argparse
import asyncio
import contextlib
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from afan_torch.cli.infer_detect import build_state, preprocess_frame
from afan_torch.cli.serve_websocket import FrameBatcher
from afan_torch.models.frcnn.rpn import generate_proposals
from afan_torch.ops import nms as tnms
from afan_torch.ops.kernels import nms as knms
from afan_torch.train.detect_loop import make_detect_fn

ROOT = os.path.dirname(os.path.abspath(__file__))
FIXTURES = os.path.join(ROOT, "tests", "fixtures")
MIN_SIDE, MAX_SIDE = 600.0, 1000.0
PROB_THRESH = 0.6
MAX_BATCH = 4
# H100 SXM published peaks (NVIDIA data sheet): HBM bytes/s and f32 FLOP/s
# outside the tensor cores. Each IoU test is 16 f32 operations (see
# afan_torch/csrc/nms.cu:over).
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
OPS_PER_IOU = 16


def require(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def sorted_boxes(n, seed, clustered=False):
    rng = np.random.RandomState(seed)
    if clustered:
        centers = rng.rand(8, 2) * 300
        xy = centers[rng.randint(0, 8, n)] + rng.randn(n, 2) * 12
        wh = rng.rand(n, 2) * 120 + 60
    else:
        xy = rng.rand(n, 2) * 1000
        wh = rng.rand(n, 2) * 150 + 4
    boxes = np.concatenate([xy, xy + wh], 1).astype(np.float32)
    return boxes[np.argsort(-rng.rand(n), kind="stable")]


def cuda(a):
    return torch.from_numpy(np.ascontiguousarray(a)).cuda()


def kernel_vs_plain(name, boxes, valid, thr, plus_one, errs):
    """Kernel and plain version on the same (G, N, 4) / (G, N) inputs;
    appends the largest |kernel - plain| over the keep mask to ``errs`` and
    returns the kernel's keep mask after requiring equality."""
    got = knms.nms_sorted_mask(boxes, valid, thr, plus_one)
    want = tnms.nms_sorted_mask_plain(boxes, valid, thr, plus_one)
    torch.cuda.synchronize()
    errs.append(float((got.float() - want.float()).abs().max()))
    require(torch.equal(got, want), f"NMS kernel != plain on {name}")
    print(f"  nms {name}: G={boxes.shape[0]} N={boxes.shape[1]} thr={thr} "
          f"plus_one={plus_one} kept={int(got.sum())} equal")
    return got


@contextlib.contextmanager
def patched_nms(fn):
    """Route afan_torch.ops.nms through ``fn`` instead of the kernel
    wrapper for the duration of the block."""
    saved = tnms.nms_sorted_mask
    tnms.nms_sorted_mask = fn
    try:
        yield
    finally:
        tnms.nms_sorted_mask = saved


def cuda_ms(fn, reps, warmup=2):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def cuda_samples(fn, n, warmup=3):
    """Per-call device times (ms) of ``n`` calls, each between two CUDA
    events."""
    for _ in range(warmup):
        fn()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(n)]
    for start, end in events:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return np.array([s.elapsed_time(e) for s, e in events])


def nms_bound_parts(boxes, valid, keep):
    """The two floors (ms) of the same work on an H100: the bytes the
    function must move (boxes and valid read once, keep written once) over
    HBM bandwidth, and the IoU tests this data needs over the f32 rate. A
    kept box must be tested against every earlier kept box; a suppressed
    valid box needs at least one test."""
    g, n = valid.shape
    nbytes = g * n * (16 + 1 + 1)
    kc = torch.cumsum(keep.to(torch.int64), dim=1)
    tests = int(((kc - 1) * keep).sum()) + int((valid & ~keep).sum())
    return (nbytes / HBM_BYTES_PER_S * 1e3,
            tests * OPS_PER_IOU / F32_OPS_PER_S * 1e3)


async def serve_group(batcher, frames):
    """Enqueue ``frames`` together, then let a worker drain them (one
    batched device call when they fit in max_batch)."""
    subs = [asyncio.create_task(batcher.submit(f)) for f in frames]
    await asyncio.sleep(0)
    worker = asyncio.create_task(batcher.worker())
    try:
        return await asyncio.gather(*subs)
    finally:
        worker.cancel()
        with contextlib.suppress(asyncio.CancelledError):
            await worker


async def serve_all(batcher, groups, zero_frames):
    """Serve each group in turn on one event loop (the batcher's queue
    belongs to the loop that first used it), then ``zero_frames`` at
    prob_thresh 0 → (answers, answers at 0)."""
    answers = []
    for group in groups:
        answers += await serve_group(batcher, group)
    batcher.prob_thresh = 0.0
    try:
        zero = await serve_group(batcher, zero_frames)
    finally:
        batcher.prob_thresh = PROB_THRESH
    return answers, zero[0]


def check_answer(dets, thresh):
    require(isinstance(dets, list), "answer is not a list")
    for box, label, prob in dets:
        require(np.shape(box) == (4,) and np.isfinite(box).all(),
                f"bad box {box}")
        require(1 <= label <= 20, f"label {label} outside 1..20")
        require(prob > thresh, f"prob {prob} not above {thresh}")


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        sys.exit(1)

    # 1. device
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    card = f"{name}, power limit {smi.split(',')[-1].strip()}"
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"[1] device: {name} (x{torch.cuda.device_count()}), torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}")
    print(smi)
    print(f"    cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
          f"cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}")

    # 2. build
    t0 = time.time()
    lib_path = knms.build()
    knms.load_library()
    print(f"[2] built {os.path.relpath(lib_path, ROOT)} in "
          f"{time.time() - t0:.1f} s")

    # 3. kernel vs plain
    print("[3] NMS kernel vs plain version")
    errs = []
    det = np.load(os.path.join(FIXTURES, "nms-large-input.npy"))
    order = np.argsort(-det[:, 4], kind="stable")
    gold = cuda(det[order, :4].astype(np.float32))[None]
    ones = torch.ones(gold.shape[:2], dtype=torch.bool, device="cuda")
    keep = kernel_vs_plain("golden", gold, ones, 0.7, True, errs)
    kept = sorted(order[keep[0].cpu().numpy()].tolist())
    expect = np.load(os.path.join(FIXTURES, "nms-large-output.npy"))
    require(len(kept) == 1934 and kept == sorted(expect.tolist()),
            f"golden fixture kept {len(kept)}, expected 1934")
    public = tnms.nms_mask(cuda(det[:, :4].astype(np.float32)),
                           cuda(det[:, 4].astype(np.float32)), 0.7)
    require(int(public.sum()) == 1934, "nms_mask on the card != 1934 kept")
    for n in (6000, 12000):
        b = cuda(sorted_boxes(n, n))[None]
        ones = torch.ones(b.shape[:2], dtype=torch.bool, device="cuda")
        kernel_vs_plain(f"uniform{n}", b, ones, 0.7, True, errs)
    b = cuda(sorted_boxes(2600, 99, clustered=True))[None]
    ones = torch.ones(b.shape[:2], dtype=torch.bool, device="cuda")
    kernel_vs_plain("clustered", b, ones, 0.5, True, errs)
    keep = kernel_vs_plain("all_invalid", b, ~ones, 0.5, True, errs)
    require(not keep.any(), "all-invalid input kept a box")
    b = cuda(sorted_boxes(6000, 1))[None]
    part = cuda(np.random.RandomState(2).rand(1, 6000) < 0.7)
    keep = kernel_vs_plain("partial_valid", b, part, 0.7, True, errs)
    require(not (keep & ~part).any(), "an invalid slot was kept")
    kernel_vs_plain("no_plus_one", b, torch.ones_like(part), 0.7, False, errs)
    b = cuda(np.stack([sorted_boxes(300, i, clustered=True)
                       for i in range(80)]))
    ones = torch.ones(b.shape[:2], dtype=torch.bool, device="cuda")
    kernel_vs_plain("batched", b, ones, 0.3, True, errs)

    # 4. serve
    print("[4] serve: FrameBatcher, ResNet-50 Faster R-CNN, 21 classes")
    args = argparse.Namespace(backbone="resnet50", checkpoint=None,
                              image_min_side=MIN_SIDE,
                              image_max_side=MAX_SIDE)
    model, canvas_hw = build_state(args, num_classes=21)
    require(next(model.parameters()).is_cuda, "model is not on the card")
    detect_fn = make_detect_fn(model)
    batch_sizes = []

    def recording_detect(images):
        batch_sizes.append(images.shape[0])
        return detect_fn(images)

    batcher = FrameBatcher(recording_detect, canvas_hw, MIN_SIDE, MAX_SIDE,
                           PROB_THRESH, max_batch=MAX_BATCH)
    t0 = time.time()
    batcher.warmup()
    torch.cuda.synchronize()
    print(f"    canvas {canvas_hw}, warmup {time.time() - t0:.1f} s")
    rng = np.random.RandomState(0)
    frames = [rng.rand(480, 640, 3).astype(np.float32) for _ in range(9)]
    groups = [frames[0:1], frames[1:2], frames[2:6], frames[6:8]]
    batch_sizes.clear()
    knms.launches = 0
    t0 = time.time()
    answers, zero = asyncio.run(serve_all(batcher, groups, frames[8:9]))
    torch.cuda.synchronize()
    serve_s = time.time() - t0
    launches = knms.launches
    for dets in answers:
        check_answer(dets, PROB_THRESH)
    check_answer(zero, 0.0)
    require(len(zero) > 0, "no detections at prob_thresh 0")
    require(batch_sizes == [1, 1, 4, 4, 1],
            f"unexpected batch sizes {batch_sizes}")
    require(launches == 2 * len(batch_sizes),
            f"NMS kernel launched {launches} times in "
            f"{len(batch_sizes)} detect calls (expected 2 per call)")
    print(f"    {len(frames)} frames in {serve_s:.2f} s, batch sizes "
          f"{batch_sizes}, detections per frame "
          f"{[len(d) for d in answers]} (>{PROB_THRESH}), {len(zero)} at "
          f"prob_thresh 0; NMS kernel launches {launches}")

    # 5. post-backbone path: kernel vs plain NMS
    print("[5] path with the kernel vs path with the plain NMS")
    canvases = np.stack([preprocess_frame(f, canvas_hw, MIN_SIDE, MAX_SIDE)[0]
                         for f in frames[:MAX_BATCH]])
    x4 = cuda(canvases)
    hw = tuple(canvas_hw)
    recorded = []

    def recording_kernel(boxes, valid, thr, plus_one=True):
        recorded.append((boxes.clone(), valid.clone(), thr, plus_one))
        return knms.nms_sorted_mask(boxes, valid, thr, plus_one)

    def post(features):
        obj, reg = model.rpn(features)
        anchors = model._anchors(hw, tuple(features.shape[2:]))
        props = generate_proposals(anchors, obj, reg, hw[1], hw[0],
                                   model.cfg.eval_pre_nms_top_n,
                                   model.cfg.eval_post_nms_top_n)
        return props + model.detect_from_features(features, hw)

    with torch.inference_mode():
        features = model.features_clean(x4.permute(0, 3, 1, 2))
        with patched_nms(recording_kernel):
            k_out = post(features)
        with patched_nms(tnms.nms_sorted_mask_plain):
            p_out = post(features)
    torch.cuda.synchronize()
    names = ("proposals", "proposal_valid", "boxes", "probs", "keep")
    for nm, a, b in zip(names, k_out, p_out):
        require(torch.equal(a, b), f"{nm} differ between kernel and plain")
    props, pvalid, boxes, probs, keep = k_out
    require(tuple(boxes.shape) == (MAX_BATCH, 300, 21, 4)
            and tuple(probs.shape) == (MAX_BATCH, 300, 21)
            and tuple(keep.shape) == (MAX_BATCH, 300, 21),
            f"detect shapes {boxes.shape} {probs.shape} {keep.shape}")
    require(bool(torch.isfinite(boxes[keep]).all()), "non-finite kept box")
    require(bool(torch.allclose(probs.sum(-1), torch.ones_like(probs[..., 0]),
                                atol=1e-4)), "probs do not sum to 1")
    print(f"    proposals {tuple(props.shape)}, valid per image "
          f"{pvalid.sum(1).tolist()}, kept detections per image "
          f"{keep.sum((1, 2)).tolist()}: identical")
    # recorded: proposal NMS twice (props, detect) then per-class NMS
    main_inputs = [recorded[1], recorded[2]]
    for boxes_in, valid_in, thr, plus_one in main_inputs:
        kernel_vs_plain("main_path", boxes_in, valid_in, thr, plus_one, errs)

    # 6. timing
    print(f"[6] timing on {card}")
    x1 = x4[:1].contiguous()
    with torch.inference_mode():
        for bs, x in ((1, x1), (MAX_BATCH, x4)):
            t = cuda_samples(lambda: model.detect(x), 110)
            print(f"    detect batch {bs}: median {np.median(t):.3f} ms, "
                  f"p90 {np.percentile(t, 90):.3f} ms over {len(t)} calls, "
                  f"{bs * 1e3 / np.median(t):.1f} frames/s ({card})")
        torch.cuda.reset_peak_memory_stats()
        model.detect(x4)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"    peak memory, detect at batch {MAX_BATCH}: {peak:.2f} GiB")
    ms = plain_ms = byte_ms = op_ms = 0.0
    for boxes_in, valid_in, thr, plus_one in main_inputs:
        g, n = valid_in.shape
        k_ms = cuda_ms(lambda: knms.nms_sorted_mask(boxes_in, valid_in, thr,
                                                    plus_one), reps=50)
        p_ms = cuda_ms(lambda: tnms.nms_sorted_mask_plain(
            boxes_in, valid_in, thr, plus_one), reps=3, warmup=1)
        keep_in = knms.nms_sorted_mask(boxes_in, valid_in, thr, plus_one)
        b, o = nms_bound_parts(boxes_in, valid_in, keep_in)
        ms, plain_ms = ms + k_ms, plain_ms + p_ms
        byte_ms, op_ms = byte_ms + b, op_ms + o
        print(f"    nms G={g} N={n} thr={thr}: kernel {k_ms:.4f} ms, plain "
              f"{p_ms:.3f} ms, bound max(bytes {b:.6f}, operations "
              f"{o:.6f}) ms ({card})")
    bound = max(byte_ms, op_ms)
    bound_by = "bytes" if byte_ms >= op_ms else "operations"
    print(f"    nms per detect call at batch {MAX_BATCH}: kernel {ms:.4f} ms, "
          f"plain {plain_ms:.3f} ms, bound {bound:.6f} ms ({bound_by})")
    # random weights keep few proposals; uniform boxes keep most, which
    # lengthens the kernel's sequential scan
    b = cuda(np.stack([sorted_boxes(6000, 10 + i) for i in range(4)]))
    ones = torch.ones(b.shape[:2], dtype=torch.bool, device="cuda")
    kept = int(knms.nms_sorted_mask(b, ones, 0.7).sum())
    k_ms = cuda_ms(lambda: knms.nms_sorted_mask(b, ones, 0.7), reps=20)
    print(f"    nms G=4 N=6000 uniform boxes, {kept} kept: kernel "
          f"{k_ms:.4f} ms ({card})")

    print(json.dumps({"kernels": [{
        "name": "nms", "route": "cuda", "source": "afan_torch/csrc/nms.cu",
        "replaces": "afan/ops/kernels/nms_kernel.py:65",
        "launches": launches, "max_abs_err": max(errs), "ms": ms,
        "plain_ms": plain_ms, "bound_ms": bound, "bound_by": bound_by,
        "library_ms": None}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
