"""Row sharding of a segmentation step over the spatial axis of a data x
spatial mesh (``--spatial_shards``): the port's counterpart of what GSPMD
does for ``afan``'s ``make_mesh_2d`` step (`afan/parallel/mesh.py:46-51`),
where XLA inserts every halo exchange and every reduction over both mesh
axes by itself. Here each one is written out.

Inside :func:`sharded` every NCHW activation of global height H is held
row-sharded over the S ranks of a data row: rank ``s`` holds the rows
``split_rows(H, s, S)`` (:func:`afan_torch.parallel.mesh.split_rows`), a
share that may be empty when S does not divide H. Every op keeps that
partition on its output. An op whose output rows need other rows of its
input (a convolution taller than 1 or strided, the stem's max pool, a
bilinear upsample, the fused upsample + CE) takes them with
:func:`window_rows`. The image pooling's global mean is a sum over the
group (:func:`spatial_sum`), and noise is drawn at the data row's whole
shape and sliced (:func:`draw_rows`), so the S ranks of a data row draw
alike from a generator seeded alike. Outside the context every op runs
its single-process code, bit for bit.

A value that no op shards by rows (the image pooling's mean, a scalar) is
computed alike on the S ranks of its data row; each rank's loss share
reaches it through its own rows, so a reduction that produced it sums its
gradient over the group, and the parameter gradients, summed over the
world, add the S shares.

The exchanges are point to point (``batch_isend_irecv``), planned from the
global partition, which every rank computes, and from every rank's window,
which every rank computes from the op's geometry; a halo may be longer
than a neighbour's share (the ASPP's rate 18 on a 12-row shard), so any
rank may send to any other. Under gloo, whose point-to-point calls take
host memory, the rows of a CUDA tensor go through host buffers: that is
the backend's transport. Every rank takes part in every exchange, also
one that owns no rows.

Every rank must build the same autograd graph, so that the backward runs
the exchanges in the same order on every rank (the engine runs nodes in
the reverse of their creation): an op with no output rows on a rank keeps
its inputs in the graph through :func:`no_rows`, launching nothing on
the empty tensor.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from .mesh import Mesh2D, group_device, split_rows

Window = Tuple[int, int]


class Sharded:
    """The state of a row-sharded step: the mesh, this rank's spatial
    coordinate, and the global heights the ops have met, by key."""

    def __init__(self, mesh: Mesh2D):
        self.mesh = mesh
        self.size = mesh.spatial
        self.index = mesh.spatial_index
        self.group = mesh.spatial_group
        self.ranks = mesh.spatial_ranks
        self.gloo = dist.get_backend(self.group) == "gloo"
        self.heights: Dict[object, Tuple[int, int]] = {}

    def rows(self, n: int, r: Optional[int] = None) -> slice:
        """Rank ``r``'s (this rank's) rows of a global height ``n``."""
        return split_rows(n, self.index if r is None else r, self.size)

    def global_height(self, key, n_local: int) -> int:
        """The global height of a map whose local height is ``n_local``:
        one all-reduce of the local heights over the group the first time
        ``key`` is met in the context, the cached value after. A key must
        stand for one map geometry within the context (a module does)."""
        hit = self.heights.get(key)
        if hit is not None:
            if hit[0] != n_local:
                raise RuntimeError(f"{key!r} met {n_local} local rows after "
                                   f"{hit[0]}")
            return hit[1]
        t = torch.tensor([n_local], dtype=torch.int64,
                         device=group_device(self.group))
        dist.all_reduce(t, group=self.group)
        n = int(t.item())
        own = self.rows(n)
        if own.stop - own.start != n_local:
            raise RuntimeError(f"{n_local} local rows are not this rank's "
                               f"share {own} of {n}")
        self.heights[key] = (n_local, n)
        return n


_active: Optional[Sharded] = None


def active() -> Optional[Sharded]:
    """The row-sharded step's state, or None outside one."""
    return _active


@contextlib.contextmanager
def sharded(mesh: Mesh2D) -> Iterator[Optional[Sharded]]:
    """Run the block as one row-sharded step on ``mesh`` (a no-op when its
    spatial size is 1: the data-parallel step, bit for bit). The cached
    heights last for the block."""
    global _active
    if mesh.spatial == 1:
        yield None
        return
    prev, _active = _active, Sharded(mesh)
    try:
        yield _active
    finally:
        _active = prev


def _p2p(ctx: Sharded, sends: Sequence[Tuple[torch.Tensor, int]],
         recvs: Sequence[Tuple[tuple, int]], like: torch.Tensor
         ) -> List[torch.Tensor]:
    """Send each ``(tensor, spatial rank)`` and receive a tensor of each
    ``(shape, spatial rank)`` in ``like``'s dtype and device, all posted
    at once. Under gloo a CUDA tensor's rows travel through host
    buffers."""
    if not sends and not recvs:
        return []
    stage = ctx.gloo and like.is_cuda
    host = torch.device("cpu")
    ops, bufs = [], []
    for t, r in sends:
        t = t.to(host) if stage else t.contiguous()
        ops.append(dist.P2POp(dist.isend, t, ctx.ranks[r], ctx.group))
    for shape, r in recvs:
        b = torch.empty(shape, dtype=like.dtype,
                        device=host if stage else like.device)
        bufs.append(b)
        ops.append(dist.P2POp(dist.irecv, b, ctx.ranks[r], ctx.group))
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return [b.to(like.device) for b in bufs] if stage else bufs


def _transfers(ctx: Sharded, n: int, windows: Sequence[Window]):
    """Every ``(src, dst, a, b)``: the global rows [a, b) that spatial rank
    ``src`` owns of height ``n`` and rank ``dst``'s window holds."""
    out = []
    for src in range(ctx.size):
        own = ctx.rows(n, src)
        for dst in range(ctx.size):
            lo, hi = windows[dst]
            a, b = max(lo, own.start), min(hi, own.stop)
            if dst != src and a < b:
                out.append((src, dst, a, b))
    return out


class _WindowRows(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, n, windows, fill):
        sh = _active
        ctx.sh, ctx.n, ctx.windows, ctx.shape = sh, n, windows, x.shape
        lo, hi = windows[sh.index]
        own = sh.rows(n)
        out = x.new_full((x.shape[0], x.shape[1], hi - lo, x.shape[3]),
                         fill)
        a, b = max(lo, own.start), min(hi, own.stop)
        if a < b:
            out[:, :, a - lo:b - lo] = x[:, :, a - own.start:b - own.start]
        sends, recvs, where = [], [], []
        for src, dst, a, b in _transfers(sh, n, windows):
            if src == sh.index:
                sends.append((x[:, :, a - own.start:b - own.start], dst))
            elif dst == sh.index:
                recvs.append(((x.shape[0], x.shape[1], b - a, x.shape[3]),
                              src))
                where.append((a - lo, b - lo))
        for buf, (a, b) in zip(_p2p(sh, sends, recvs, x), where):
            out[:, :, a:b] = buf
        return out

    @staticmethod
    def backward(ctx, g):
        sh, n, windows = ctx.sh, ctx.n, ctx.windows
        lo, hi = windows[sh.index]
        own = sh.rows(n)
        g = g.contiguous()
        gx = g.new_zeros(ctx.shape)
        a, b = max(lo, own.start), min(hi, own.stop)
        if a < b:
            gx[:, :, a - own.start:b - own.start] += g[:, :, a - lo:b - lo]
        sends, recvs, where = [], [], []
        for src, dst, a, b in _transfers(sh, n, windows):
            if dst == sh.index:
                sends.append((g[:, :, a - lo:b - lo], src))
            elif src == sh.index:
                recvs.append(((g.shape[0], g.shape[1], b - a, g.shape[3]),
                              dst))
                where.append((a - own.start, b - own.start))
        for buf, (a, b) in zip(_p2p(sh, sends, recvs, g), where):
            gx[:, :, a:b] += buf
        return gx, None, None, None


def window_rows(x: torch.Tensor, n: int, windows: Sequence[Window],
                fill: float = 0.0) -> torch.Tensor:
    """The global rows ``windows[s]`` = [lo, hi) of the row-sharded NCHW
    ``x`` of global height ``n``, on spatial rank ``s``; rows outside
    [0, n) are ``fill`` (0 for a convolution's padding, -inf for a max
    pool's). Every rank passes every rank's window (``windows`` has one
    per spatial rank), so each knows whom to send which of its rows. The
    backward sends each fetched row's gradient back to its owner, which
    adds it."""
    return _WindowRows.apply(x, n, tuple(tuple(w) for w in windows), fill)


def conv_windows(sh: Sharded, n: int, k: int, stride: int, pad: int,
                 dilation: int) -> Tuple[int, List[Window]]:
    """A convolution's (or pool's) output height over input height ``n``,
    and each rank's input window: the rows its output rows ``o0 .. o1 - 1``
    read, ``o0 * stride - pad`` to ``(o1 - 1) * stride - pad + dilation *
    (k - 1)``; an empty window where a rank owns no output row."""
    n_out = (n + 2 * pad - dilation * (k - 1) - 1) // stride + 1
    windows = []
    for r in range(sh.size):
        o = sh.rows(n_out, r)
        windows.append((0, 0) if o.start == o.stop else (
            o.start * stride - pad,
            (o.stop - 1) * stride - pad + dilation * (k - 1) + 1))
    return n_out, windows


class _NoRows(torch.autograd.Function):

    @staticmethod
    def forward(ctx, shape, dtype, *inputs):
        ctx.inputs = [(t.shape, t.dtype, t.device) for t in inputs]
        return inputs[0].new_zeros(shape, dtype=dtype)

    @staticmethod
    def backward(ctx, g):
        return (None, None) + tuple(
            torch.zeros(s, dtype=d, device=v) for s, d, v in ctx.inputs)


def no_rows(shape, dtype: torch.dtype, *inputs: torch.Tensor
            ) -> torch.Tensor:
    """The output of an op on a rank that owns none of its output rows:
    zeros of ``shape`` (an empty map, or a loss site's zero sums) that keep
    ``inputs`` (the op's input window and parameters) in the graph with
    zero gradients, so that every rank holds gradients for the same
    parameters and runs the same backward."""
    return _NoRows.apply(tuple(shape), dtype, *inputs)


class _SpatialSum(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x):
        ctx.group = _active.group
        y = x.clone()
        dist.all_reduce(y, group=ctx.group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g


def spatial_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum of ``x`` over the data row's spatial ranks, alike on each;
    the backward sums the gradients the ranks' loss shares send into it."""
    return _SpatialSum.apply(x)


def spatial_max_(x: torch.Tensor) -> torch.Tensor:
    """``x`` replaced in place by its maximum over the spatial ranks (no
    gradient)."""
    dist.all_reduce(x, op=dist.ReduceOp.MAX, group=_active.group)
    return x


def draw_rows(draw: Callable[[tuple], torch.Tensor], shape: Sequence[int],
              axis: int) -> torch.Tensor:
    """``draw(shape)`` outside a row-sharded step. Inside one, ``shape``
    is a row-sharded tensor's (rows on ``axis``): the noise is drawn at the
    data row's whole shape and this rank's rows are kept, so that the S
    ranks, whose generators are seeded alike, draw the noise of the
    one-process step and stay in step."""
    sh = _active
    shape = tuple(shape)
    if sh is None:
        return draw(shape)
    key = ("draw", axis) + shape[:axis] + shape[axis + 1:]
    n = sh.global_height(key, shape[axis])
    rows = sh.rows(n)
    full = draw(shape[:axis] + (n,) + shape[axis + 1:])
    return full.narrow(axis, rows.start, rows.stop - rows.start).contiguous()
