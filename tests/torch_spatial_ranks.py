"""The rank side of ``tests/test_torch_spatial.py``: one process of a data x
spatial mesh on the CPU (gloo). It imports no jax, so that spawned ranks do
not; ``afan_torch.parallel.launch`` runs it in each rank. The A-FAN steps'
rank side is ``tests/torch_dp_ranks.py:run`` with a ``mesh`` in its
payload."""
import torch

from afan_torch.models.deeplab.heads import ASPPPooling, resize_bilinear
from afan_torch.models.resnet import Conv2d, stem_pool
from afan_torch.parallel import mesh as dp
from afan_torch.parallel import spatial
from afan_torch.parallel.mesh import split_rows
from afan_torch.train import segment_loop


def rows(a, n_parts, r, axis=2):
    """Rank ``r``'s rows of ``a`` (``split_rows`` along ``axis``)."""
    sl = split_rows(a.shape[axis], r, n_parts)
    return a[(slice(None),) * axis + (sl,)]


def module_of(case):
    """The case's module, with the parent's weights."""
    p = case["params"]
    if case["kind"] == "conv":
        m = Conv2d(p["cin"], p["cout"], p["k"], stride=p["stride"],
                   padding=(p["k"] // 2) * p["dilation"],
                   dilation=p["dilation"], bias=p["bias"])
    elif case["kind"] == "pooling":
        m = ASPPPooling(p["cin"], p["cout"])
    else:
        return None
    m.load_state_dict({k: torch.from_numpy(v)
                       for k, v in case["state"].items()})
    return m


def apply(case, m, x, out_rows):
    """The case's op on ``x`` (the whole map, or this rank's rows inside a
    row-sharded step, whose output has ``out_rows`` rows)."""
    kind, p = case["kind"], case["params"]
    if kind in ("conv", "pooling"):
        return m(x)
    if kind == "pool":
        return stem_pool(x, "pool")
    if kind == "resize":
        return resize_bilinear(x.to(getattr(torch, p["dtype"])),
                               (out_rows, p["W"]), key="resize")
    raise ValueError(kind)


def op_rank(rank, size, window_cases, op_cases):
    """Every case on this rank's rows, on a 1 x ``size`` mesh: each window
    case's window and its input gradient for the rank's probe; each op
    case's output rows, input gradient and parameter gradients for its
    probe's rows (the site loss: its share and its logits' gradient)."""
    torch.set_num_threads(1)
    mesh = dp.make_mesh_2d(1, size)
    s = mesh.spatial_index
    out = {}
    for case in window_cases:
        x = torch.from_numpy(rows(case["x"], size, s)).requires_grad_(True)
        with spatial.sharded(mesh):
            win = spatial.window_rows(x, case["x"].shape[2],
                                      case["windows"], case["fill"])
            win.backward(torch.from_numpy(case["probes"][s]))
        out[case["name"]] = (win.detach().numpy(), x.grad.numpy())
    for case in op_cases:
        if case["kind"] == "ce":
            lo = torch.from_numpy(rows(case["x"], size, s)).requires_grad_(
                True)
            lab = torch.from_numpy(rows(case["labels"], size, s, axis=1))
            with spatial.sharded(mesh):
                share = segment_loop._site_loss(lab, None, fused=True)(lo)[0]
                share.backward()
            out[case["name"]] = (float(share.detach()), lo.grad.numpy(), {})
            continue
        m = module_of(case)
        if m is not None:
            m.train()
        x = torch.from_numpy(rows(case["x"], size, s)).requires_grad_(True)
        probe = torch.from_numpy(rows(case["probe"], size, s))
        with spatial.sharded(mesh):
            y = apply(case, m, x, probe.shape[2])
            y.backward(probe.to(y.dtype))
        grads = {} if m is None else {
            k: v.grad.numpy() for k, v in m.named_parameters()}
        out[case["name"]] = (y.detach().float().numpy(),
                             x.grad.float().numpy(), grads)
    return out


def one_process(case):
    """An op case on the whole map in one process: output, input gradient,
    parameter gradients (the site loss: the loss and the logits'
    gradient)."""
    if case["kind"] == "ce":
        lo = torch.from_numpy(case["x"]).requires_grad_(True)
        loss = segment_loop._site_loss(torch.from_numpy(case["labels"]),
                                       None, fused=True)(lo)[0]
        loss.backward()
        return float(loss.detach()), lo.grad.numpy(), {}
    m = module_of(case)
    if m is not None:
        m.train()
    x = torch.from_numpy(case["x"]).requires_grad_(True)
    probe = torch.from_numpy(case["probe"])
    y = apply(case, m, x, probe.shape[2])
    y.backward(probe.to(y.dtype))
    grads = {} if m is None else {
        k: v.grad.numpy() for k, v in m.named_parameters()}
    return y.detach().float().numpy(), x.grad.float().numpy(), grads


def draws_rank(rank, data, size, seed, shape):
    """Noise drawn inside a row-sharded step of a ``data x size`` mesh from
    a generator seeded by ``rank_seed``, for this rank's rows of a map of
    ``shape``: its rows of the data row's draw, and the random step
    sizes."""
    torch.set_num_threads(1)
    mesh = dp.make_mesh_2d(data, size)
    gen = torch.Generator().manual_seed(dp.rank_seed(seed, mesh.data_index))
    own = split_rows(shape[2], mesh.spatial_index, size)
    local = shape[:2] + (own.stop - own.start,) + shape[3:]
    with spatial.sharded(mesh):
        noise = spatial.draw_rows(lambda s: torch.rand(s, generator=gen),
                                  local, 2)
        steps = torch.rand((3,), generator=gen)
    return {"coords": (mesh.data_index, mesh.spatial_index),
            "noise": noise.numpy(), "steps": steps.numpy()}


def cli_rank(rank, argv, where):
    """``train_segment.main(argv)`` on this rank (its group already made)
    in the directory ``where``, its scalar log without TensorBoard (whose
    import costs seconds)."""
    import functools
    import os

    from afan_torch.cli import train_segment
    from afan_torch.utils import observe
    os.chdir(where)
    train_segment.ScalarWriter = functools.partial(observe.ScalarWriter,
                                                   use_tensorboard=False)
    return train_segment.main(argv)
