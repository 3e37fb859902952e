"""The work of one step, counted once by the reference on the ``meta``
device at the cell's shapes: the model FLOPs under
``torch.utils.flop_counter.FlopCounterMode`` (the passes the algorithm
makes, forward and backward, no recomputation), and the calls of each
hand-written kernel's function with their shapes, from which
:mod:`benchmark.lib.bounds` takes bytes and operations.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Tuple

import torch
from torch.utils.flop_counter import FlopCounterMode


@dataclasses.dataclass
class Call:
    op: str                         # "resize_ce", "pgd_step", "nms"
    shape: Tuple[int, ...]
    elem_bytes: int
    reps: int                       # how many times the labels are tiled


class Recorder:
    """The kernel calls of a step, and the FLOPs of work that the run
    counts by hand where the reference's implementation would count
    something else (``extra_flops``)."""

    def __init__(self):
        self.calls: List[Call] = []
        self.extra_flops = 0.0

    def __call__(self, op: str, t: torch.Tensor, reps: int) -> None:
        self.calls.append(Call(op, tuple(t.shape), t.element_size(), reps))


class _Global:
    """A module tracker that sees no modules: every operation counts under
    "Global" (the per-module hooks clash with ``autograd.grad`` on a leaf,
    which the ascents take)."""
    parents = {"Global"}
    is_bw = False

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


class _Counter(FlopCounterMode):
    def __init__(self):
        super().__init__(display=False)
        self.mod_tracker = _Global()


def count(run: Callable[[Recorder], None]) -> Tuple[float, List[Call]]:
    """(FLOPs, kernel calls) of ``run(recorder)``, one step on meta
    tensors."""
    rec = Recorder()
    with _Counter() as counter:
        run(rec)
    return float(counter.get_total_flops()) + rec.extra_flops, rec.calls
