"""Data parallelism over the node's cards — the counterpart of
``afan/parallel/mesh.py``.

``afan`` jits each step over a batch sharded on a 1-D device mesh
(``P('data')``) with replicated parameters; under GSPMD every reduction in
the step runs over the global batch, so an N-device step computes the same
function as the 1-device step on the same global batch. The port keeps that
function with one process per card (:mod:`afan_torch.parallel.launch`):

- each rank holds its contiguous rows of the global batch
  (:func:`shard_batch`);
- each rank's loss is its share of the global loss (:func:`share`: the
  local mean over N, or, for segmentation, the local sum over the global
  valid-pixel count, :func:`global_sum`);
- the trainable BatchNorm normalizes with the global batch statistics
  (:mod:`afan_torch.models.resnet`, through :class:`SumOverRanks`, whose
  backward sums the other ranks' gradient terms);
- the parameter gradients are summed over the ranks in flat buckets
  (:func:`sum_gradients`), so every rank takes the same update.

The process group is the one record of the ranks: :func:`world_size`,
:func:`rank` and :func:`is_main` read it, and :func:`resolve_size` counts
the cards that ``--num_devices`` asks for (``afan``'s ``make_mesh``).
Outside a process group every helper is the identity and the code paths
are the single-process ones, bit for bit.

The data x spatial mesh (``--spatial_shards``, ``afan``'s
``make_mesh_2d``) is a :class:`Mesh2D` over the same ranks: rank ``r`` is
``(r // S, r % S)``, each data row of S ranks holds one share of the
global batch and splits its images' rows over its S ranks
(:func:`shard_batch_spatial`), joined by a process group of their own;
the in-step noise is seeded by the data coordinate (:func:`rank_seed`).
The BatchNorm statistics, the pixel count and the gradient sum stay sums
over the whole world, which is both axes. The row-sharded step itself is
:mod:`afan_torch.parallel.spatial`.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Iterable, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

# gradients are summed in flat buckets of at most this many bytes
BUCKET_BYTES = 32 << 20


def data_group():
    """The process group of the data-parallel ranks, or None outside
    one."""
    if dist.is_available() and dist.is_initialized():
        return dist.group.WORLD
    return None


def world_size() -> int:
    return dist.get_world_size() if data_group() is not None else 1


def rank() -> int:
    return dist.get_rank() if data_group() is not None else 0


def is_main() -> bool:
    """Rank 0, the one that writes checkpoints and logs."""
    return rank() == 0


def resolve_size(num_devices: Optional[int],
                 device: Union[str, torch.device]) -> int:
    """The number of data-parallel ranks ``--num_devices`` asks for on
    ``device``. On the card None means every visible card (``afan``'s
    ``make_mesh``), and more cards than are visible raise, naming the
    count (``afan`` would silently take fewer). On the CPU None means one
    process, and N means N processes."""
    if num_devices is not None and num_devices < 1:
        raise ValueError(f"--num_devices {num_devices}: need at least 1")
    if torch.device(device).type != "cuda":
        return 1 if num_devices is None else num_devices
    have = torch.cuda.device_count()
    if num_devices is None:
        return max(have, 1)
    if num_devices > have:
        raise ValueError(f"--num_devices {num_devices} asks for more CUDA "
                         f"devices than the {have} visible")
    return num_devices


@dataclasses.dataclass(frozen=True)
class Mesh2D:
    """A ``data x spatial`` mesh of the ranks: the two sizes, this rank's
    coordinates, and the process group of its data row (its S spatial
    ranks, by global rank), None when S is 1."""
    data: int
    spatial: int
    data_index: int
    spatial_index: int
    spatial_ranks: Tuple[int, ...]
    spatial_group: Any = None

    @property
    def shape(self) -> dict:
        return {"data": self.data, "spatial": self.spatial}

    @property
    def size(self) -> int:
        return self.data * self.spatial


def group_device(group) -> torch.device:
    """Where a collective of ``group`` takes its tensors: the current card
    under NCCL, the host under gloo (which also takes CUDA tensors in its
    reductions, through the host)."""
    if dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def make_mesh_2d(data: int, spatial: int, devices=None) -> Mesh2D:
    """The ``data x spatial`` mesh of this process group's ranks (all of
    them: ``data * spatial`` must be the world size, ``afan``'s message
    otherwise). Every rank must call it, in the same order as its other
    collectives: each creates every data row's group. ``devices`` is
    ``afan``'s argument and unused: a rank's card is its launcher's."""
    n = world_size()
    if data < 1 or spatial < 1 or data * spatial != n:
        raise ValueError(
            f"need {data * spatial} devices for a {data}x{spatial} mesh, "
            f"have {n}")
    r = rank()
    row = r // spatial
    ranks = tuple(range(row * spatial, (row + 1) * spatial))
    group = None
    if spatial > 1:
        for d in range(data):
            g = dist.new_group(list(range(d * spatial, (d + 1) * spatial)))
            if d == row:
                group = g
        # the group's first collective is one every rank takes part in
        dist.all_reduce(torch.zeros(1, device=group_device(group)),
                        group=group)
    return Mesh2D(data, spatial, row, r % spatial, ranks, group)


def check_divisible(batch_size: int, n: int) -> None:
    """The reference's batch divisibility assert over ``n`` ranks
    (`train_aug_final.py:62-65`), with ``afan``'s message."""
    if batch_size % n != 0:
        raise ValueError(
            f"batch size {batch_size} not divisible by {n} devices")


def split_rows(n: int, r: int, size: int) -> slice:
    """Rank ``r``'s contiguous rows of ``n`` among ``size`` ranks: equal
    shares when ``size`` divides ``n`` (``P('data')``), else
    ``np.array_split``'s (evaluation's last batch)."""
    base, extra = divmod(n, size)
    start = r * base + min(r, extra)
    return slice(start, start + base + (r < extra))


def rank_rows(n: int) -> slice:
    """This rank's rows of ``n`` (:func:`split_rows`)."""
    return split_rows(n, rank(), world_size())


def shard_batch(*arrays):
    """This rank's rows of each array's leading (batch) axis; the batch
    must divide by the ranks (:func:`check_divisible`)."""
    out = []
    for a in arrays:
        check_divisible(a.shape[0], world_size())
        out.append(a[rank_rows(a.shape[0])])
    return out[0] if len(out) == 1 else tuple(out)


def shard_rows(mesh: Mesh2D, *arrays):
    """This rank's image rows (axis 1: H of NHWC images and NHW label
    maps) of each array, by its spatial coordinate; the rows must divide
    by the spatial size (``afan``'s ``shard_batch_spatial`` check and
    message)."""
    out = []
    for a in arrays:
        if a.shape[1] % mesh.spatial != 0:
            raise ValueError(
                f"row dim {a.shape[1]} not divisible by {mesh.spatial} "
                f"spatial shards")
        out.append(a[:, split_rows(a.shape[1], mesh.spatial_index,
                                   mesh.spatial)])
    return out[0] if len(out) == 1 else tuple(out)


def shard_batch_spatial(mesh: Mesh2D, *arrays):
    """This rank's block of each global-batch array: its batch rows by
    its data coordinate, then its image rows (axis 1) by its spatial
    coordinate (``afan``'s ``shard_batch_spatial``)."""
    out = []
    for a in arrays:
        check_divisible(a.shape[0], mesh.data)
        out.append(shard_rows(mesh, a[split_rows(a.shape[0],
                                                 mesh.data_index,
                                                 mesh.data)]))
    return out[0] if len(out) == 1 else tuple(out)


def rank_seed(seed: int, index: Optional[int] = None) -> int:
    """The seed of this rank's in-step noise: ``seed`` itself on rank 0
    (so one process draws as before), a distinct one on every other. On a
    data x spatial mesh ``index`` is the rank's data coordinate: the
    spatial ranks of a data row share the seed, draw the row's noise at
    its whole shape and keep their own rows."""
    r = rank() if index is None else index
    return seed if r == 0 else (seed * 1000003 + r * 0x9E3779B1) % (1 << 63)


class SumOverRanks(torch.autograd.Function):
    """All-reduce (sum) with autograd: the backward sums the gradients that
    every rank's loss sends into the result, so each rank gets the
    gradient of the global loss with respect to its own input."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, grad):
        g = grad.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def sum_over_ranks(x: torch.Tensor) -> torch.Tensor:
    """Differentiable sum over the ranks (the identity outside a group)."""
    group = data_group()
    return x if group is None else SumOverRanks.apply(x, group)


def global_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum over the ranks of a detached ``x`` (the identity outside a
    group)."""
    group = data_group()
    if group is None:
        return x
    y = x.detach().clone()
    dist.all_reduce(y, group=group)
    return y


def global_mean(x: torch.Tensor) -> torch.Tensor:
    """The mean over the ranks of a per-rank mean over equal shares: the
    global batch's mean."""
    n = world_size()
    return x if n == 1 else global_sum(x) / n


def share(loss: torch.Tensor) -> torch.Tensor:
    """A rank's share of a mean over the global batch, from the mean over
    its own rows: ``loss / N``, so the shares sum to the global mean."""
    n = world_size()
    return loss if n == 1 else loss / n


def _buckets(tensors: Sequence[torch.Tensor]) -> List[List[torch.Tensor]]:
    out: List[List[torch.Tensor]] = []
    key, size = None, 0
    for t in tensors:
        k = (t.dtype, t.device)
        nbytes = t.numel() * t.element_size()
        if not out or k != key or size + nbytes > BUCKET_BYTES:
            out.append([])
            key, size = k, 0
        out[-1].append(t)
        size += nbytes
    return out


def _flat_collective(tensors: Sequence[torch.Tensor], op) -> None:
    for bucket in _buckets(list(tensors)):
        flat = torch.cat([t.reshape(-1) for t in bucket])
        op(flat)
        o = 0
        for t in bucket:
            n = t.numel()
            t.copy_(flat[o:o + n].view_as(t))
            o += n


def parameters_of(params: Union[torch.optim.Optimizer, Iterable]
                  ) -> List[torch.Tensor]:
    if isinstance(params, torch.optim.Optimizer):
        return [p for g in params.param_groups for p in g["params"]]
    return list(params)


def sum_gradients(params: Union[torch.optim.Optimizer, Iterable]) -> None:
    """Sum every present ``.grad`` over the ranks, in flat buckets of at
    most :data:`BUCKET_BYTES` (one all-reduce each, not one per parameter).
    Every rank must hold gradients for the same parameters; nothing happens
    outside a group."""
    group = data_group()
    if group is None:
        return
    grads = [p.grad for p in parameters_of(params) if p.grad is not None]
    _flat_collective(grads, lambda f: dist.all_reduce(f, group=group))


def replicate_state(module: torch.nn.Module,
                    optimizer: Optional[torch.optim.Optimizer] = None
                    ) -> None:
    """Broadcast rank 0's parameters, buffers and optimizer state to every
    rank (``afan``'s replicated train state)."""
    group = data_group()
    if group is None:
        return
    tensors = [t.data for t in module.parameters()]
    tensors += [b for b in module.buffers()]
    if optimizer is not None:
        for p in parameters_of(optimizer):
            state = optimizer.state.get(p, {})
            tensors += [state[k] for k in sorted(state)
                        if torch.is_tensor(state[k])]
    with torch.no_grad():
        _flat_collective(tensors,
                         lambda f: dist.broadcast(f, 0, group=group))


def gather_objects(obj) -> list:
    """Every rank's ``obj``, in rank order (``[obj]`` outside a group)."""
    group = data_group()
    if group is None:
        return [obj]
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, obj, group=group)
    return out


def sum_numpy(a: np.ndarray) -> np.ndarray:
    """The sum over the ranks of a host array (a confusion matrix, counts)."""
    if data_group() is None:
        return a
    return np.sum(gather_objects(np.asarray(a)), axis=0)
