"""The rank side of ``tests/test_torch_dp.py`` and of the A-FAN steps of
``tests/test_torch_spatial.py``: one process of a data-parallel group (or
the one process of a run without a group) builds the port's model from
the given weights, takes its rows of each global batch (with a ``mesh``
in the payload, its block of a data x spatial mesh, each step row-sharded)
and runs the trainer's step. It imports no jax, so that spawned ranks do
not; ``afan_torch.parallel.launch`` runs it in each rank."""
import contextlib

import numpy as np
import torch

from afan_torch.core import attack
from afan_torch.models.deeplab import DeepLab
from afan_torch.models.deeplab.modeling import segmentation_param_groups
from afan_torch.models.frcnn import FasterRCNN, FRCNNConfig
from afan_torch.models.resnet_s import ResNetS
from afan_torch.parallel import mesh as dp
from afan_torch.parallel import spatial
from afan_torch.train import detect_loop, loop, optim, segment_loop


def shard_tree(tree, n):
    """This rank's rows of every tensor of ``tree`` with ``n`` rows."""
    if isinstance(tree, dict):
        return {k: shard_tree(v, n) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(shard_tree(v, n) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(shard_tree(v, n) for v in tree)
    if torch.is_tensor(tree) and tree.dim() and tree.shape[0] == n:
        return dp.shard_batch(tree)
    return tree


def build(section, p):
    """The model, optimizer and step of ``section`` from payload ``p``."""
    if section in ("alfa", "learnable"):
        tm = ResNetS(p["blocks"], p["classes"], p["init_w"])
        tm.load_state_dict(p["state_dict"])
        sched = optim.multistep_warmup_schedule(p["lr"], p["milestones"])
        if section == "learnable":
            opt, sch = optim.learnable_sgd(tm, sched, p["lr"], p["w_lr"],
                                           p["momentum"], p["wd"])
            return tm, opt, loop.make_learnable_step(
                tm, opt, sch, loop.LearnableConfig(**p["cfg"]))
        opt, sch = optim.sgd([{"params": list(tm.parameters())}], sched,
                             p["lr"], p["momentum"], p["wd"])
        return tm, opt, loop.make_alfa_step(tm, opt, sch,
                                            loop.AlfaConfig(**p["cfg"]))
    if section in ("det", "det-rpn"):
        tm = FasterRCNN(FRCNNConfig(**p["frcnn"]))
        tm.load_state_dict(p["state_dict"])
        opt, sch = optim.sgd(detect_loop.detection_param_groups(tm),
                             optim.warmup_multistep_schedule(
                                 p["lr"], [10], 0.1, 1.0 / 3, 5),
                             p["lr"], 0.9, 5e-4)
        return tm, opt, detect_loop.make_afan_det_step(
            tm, opt, sch, detect_loop.DetAfanConfig(**p["cfg"]))
    tm = DeepLab(*p["deeplab"],
                 backbone_remat=p.get("backbone_remat", False))
    tm.load_state_dict(p["state_dict"])
    if p.get("float64"):
        tm.double()
    for m in tm.modules():
        if isinstance(m, torch.nn.Dropout):
            m.p = 0.0
    opt, sch = optim.sgd(segmentation_param_groups(tm),
                         optim.poly_schedule(p["lr"], p["total"]), p["lr"],
                         0.9, 1e-4)
    return tm, opt, segment_loop.make_afan_seg_step(
        tm, opt, sch, segment_loop.SegAfanConfig(**p["cfg"]))


def run(rank, section, p):
    """The steps of ``section`` on this rank's rows of each global batch
    (``p["batches"]``); the metrics of every step (floats), the final state
    dict and the SGD momentum buffers (numpy), and every ascent's
    perturbation (result minus start) on this rank's rows with its step
    size. With ``p["replay"]`` (the global perturbations of another run's
    ascents, in order) each ascent still runs, but the step goes on from
    its start plus the replayed perturbation, and ``ascents`` holds its
    own. With ``p["mesh"] = (data, spatial)`` the ranks form that mesh:
    each takes its block of the batch (its image rows too) and runs each
    step row-sharded; the ascents are then its block's (rows on axis 2).
    With ``p["float64"]`` the segmentation model and images are float64;
    with ``p["backbone_remat"]`` its backbone recomputes its stages."""
    torch.set_num_threads(1)
    mesh = dp.make_mesh_2d(*p["mesh"]) if "mesh" in p else None
    tm, opt, step = build(section, p)
    dp.replicate_state(tm, opt)
    ascents, replay = [], p.get("replay")

    def recorded_pgd(loss_fn, x, **kw):
        out = attack.pgd(loss_fn, x, **kw)
        ascents.append(((out - x).numpy(), float(kw["gamma"])))
        if replay is not None:
            out = x + dp.shard_batch(torch.from_numpy(
                replay[len(ascents) - 1]))
        return out

    for mod in (loop, segment_loop, detect_loop):
        mod.pgd = recorded_pgd
    try:
        metrics = []
        for batch in p["batches"]:
            n = batch["inputs"][0].shape[0]
            inputs = [torch.from_numpy(a) for a in batch["inputs"]]
            if p.get("float64"):
                inputs = [a.double() if a.is_floating_point() else a
                          for a in inputs]
            inputs = [dp.shard_batch(a) if mesh is None
                      else dp.shard_batch_spatial(mesh, a) for a in inputs]
            kw = {}
            if "targets" in batch:
                kw["targets"] = shard_tree(batch["targets"], n)
            with (spatial.sharded(mesh) if mesh is not None
                  else contextlib.nullcontext()):
                out = step(*inputs, **kw)
            metrics.append({k: v.numpy().tolist() for k, v in out.items()})
    finally:
        for mod in (loop, segment_loop, detect_loop):
            mod.pgd = attack.pgd
    momenta = {name: opt.state[prm]["momentum_buffer"].numpy()
               for name, prm in tm.named_parameters()
               if "momentum_buffer" in opt.state.get(prm, {})}
    return {"rank": dp.rank(), "size": dp.world_size(), "metrics": metrics,
            "state": {k: v.numpy() for k, v in tm.state_dict().items()},
            "momenta": momenta, "ascents": ascents}


def runs(rank, section, payloads):
    """:func:`run` of each payload in turn, in one launch."""
    return [run(rank, section, p) for p in payloads]


def bn_rank(rank, x, weight, bias, momentum, update):
    """The global BatchNorm on this rank's rows of ``x`` (NCHW): its output
    rows, the gradients of sum(y * w) for a fixed ``w`` (one per element)
    with respect to this rank's rows, the weight and the bias (summed over
    the ranks), and the running statistics."""
    from afan_torch.models.resnet import BatchNorm, frozen_bn_stats
    torch.set_num_threads(1)
    bn = BatchNorm(x.shape[1], momentum=momentum)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(weight))
        bn.bias.copy_(torch.from_numpy(bias))
    bn.train()
    xs = dp.shard_batch(torch.from_numpy(x)).requires_grad_(True)
    probe = torch.linspace(-1, 1, x.size, dtype=torch.float64).reshape(
        x.shape).float()
    probe = dp.shard_batch(probe)
    if update:
        y = bn(xs)
    else:
        with frozen_bn_stats(bn):
            y = bn(xs)
    (y * probe).sum().backward()
    dp.sum_gradients([bn.weight, bn.bias])
    return {"y": y.detach().numpy(), "gx": xs.grad.numpy(),
            "gw": bn.weight.grad.numpy(), "gb": bn.bias.grad.numpy(),
            "mean": bn.running_mean.numpy(), "var": bn.running_var.numpy()}


def npix_rank(rank, logits, labels):
    """A segmentation site's loss on this rank's rows: its share of the
    loss over the global valid-pixel count, and the share's gradient with
    respect to its logits."""
    torch.set_num_threads(1)
    lo = dp.shard_batch(torch.from_numpy(logits)).requires_grad_(True)
    lab = dp.shard_batch(torch.from_numpy(labels))
    site = segment_loop._site_loss(lab, None, fused=True)
    loss = site(lo)[0]
    loss.backward()
    return {"share": float(loss.detach()), "global": float(dp.global_sum(
        loss.detach())), "grad": lo.grad.numpy(),
        "valid": int((lab != 255).sum())}


def helpers_rank(rank, n, flat_sizes):
    """The mesh helpers in a group: the rank's rows, a broadcast of rank
    0's state and a bucketed gradient sum (the module's bucket size set
    down to 64 bytes in this process, so that the sum takes three)."""
    torch.set_num_threads(1)
    rows = dp.shard_batch(np.arange(n))
    lin = torch.nn.Linear(3, 2)
    with torch.no_grad():
        for prm in lin.parameters():
            prm.fill_(float(rank + 1))
    opt = torch.optim.SGD(lin.parameters(), lr=0.1, momentum=0.9)
    lin(torch.ones(1, 3)).sum().backward()
    opt.step()                      # momentum buffers: rank-dependent
    for prm in lin.parameters():
        opt.state[prm]["momentum_buffer"].fill_(10.0 * (rank + 1))
    dp.replicate_state(lin, opt)
    params = [torch.nn.Parameter(torch.zeros(s)) for s in flat_sizes]
    for i, prm in enumerate(params):
        prm.grad = torch.full((flat_sizes[i],), float(rank + 1) * (i + 1))
    calls = []
    real = torch.distributed.all_reduce

    def counting(t, *a, **k):
        calls.append(t.numel())
        return real(t, *a, **k)
    torch.distributed.all_reduce = counting
    try:
        dp.BUCKET_BYTES = 64
        dp.sum_gradients(params)
    finally:
        torch.distributed.all_reduce = real
    return {"rows": rows.tolist(), "seed": dp.rank_seed(5),
            "weight": lin.weight.detach().numpy(),
            "momentum": opt.state[lin.weight]["momentum_buffer"].numpy(),
            "grads": [prm.grad.numpy() for prm in params],
            "calls": calls}


def raising_rank(rank):
    """Rank 1 raises; rank 0 waits for it in a collective."""
    if rank == 1:
        raise ValueError("rank one fails on purpose")
    torch.distributed.barrier()


def hanging_rank(rank):
    """Never returns within a test's patience."""
    import time
    time.sleep(600)


def slow_rank(rank, seconds):
    """Works longer than the group's collective timeout, outside any
    collective, then meets the other ranks."""
    import time
    time.sleep(seconds)
    torch.distributed.barrier()
    return rank
