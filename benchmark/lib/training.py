"""What the training drivers share: the measured window of back-to-back
steps, freeing the program before the reference runs, the checks of
``correct``, and the sides of ``readings.py``."""
from __future__ import annotations

import gc
import sys
from typing import Callable, Iterator, List, Tuple

import torch

from . import compare, harness


def measure(step_at: Callable[[int], object], k: int, seconds: float,
            clock: harness.Clock, device) -> Tuple[int, float, int]:
    """Steps ``step_at(k), step_at(k + 1), ...`` until ``seconds`` have
    passed on the host clock, then a wait for the device: (steps, the
    window's seconds, the device's peak bytes in it). The garbage collector
    is frozen over the window, so that no collection of the set-up's
    objects lands in it. The steps enqueued in each second of the window
    go to standard error."""
    gc.collect()
    gc.freeze()
    gc.disable()
    try:
        return _window(step_at, k, seconds, clock, device)
    finally:
        gc.enable()
        gc.unfreeze()


def _window(step_at, k, seconds, clock, device) -> Tuple[int, float, int]:
    if device != "cpu":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    t0, n, ends = clock.now(), 0, []
    while True:
        step_at(k + n)
        n += 1
        ends.append(clock.now() - t0)
        if ends[-1] >= seconds:
            break
    if device != "cpu":
        torch.cuda.synchronize()
    window_s = clock.now() - t0
    peak = torch.cuda.max_memory_allocated() if device != "cpu" else 0
    per_second = [0] * (int(ends[-1]) + 1)
    for t in ends:
        per_second[int(t)] += 1
    print(f"window: {n} steps in {window_s!r} s; steps enqueued in each "
          f"second {per_second}", file=sys.stderr)
    return n, window_s, peak


def free(device) -> None:
    gc.collect()
    if device != "cpu":
        torch.cuda.empty_cache()


def checks(cell: harness.Cell, got: compare.Readings, ref: compare.Readings,
           last_loss: float) -> List[harness.Check]:
    """The compared numbers beside the cell's limits; the numbers not
    compared go to standard error."""
    numbers = compare.gaps(got, ref, cell.traffic["compare"])
    later = compare.diagnostics(got, ref)
    print(f"losses: program {got.losses}, reference {ref.losses}; loss "
          f"after the window {last_loss!r}; each step's loss gap "
          f"{later['loss_gaps']}, the change's over the {len(got.losses)} "
          f"steps {later['last_change_gap']!r}", file=sys.stderr)
    return [(m, numbers[m], lim) for m, lim in cell.traffic["limits"].items()]


def sides(cell: harness.Cell, read: Callable, ref: compare.Readings,
          wanted: List[Tuple], device) -> Iterator[Tuple[str, dict]]:
    """(side, numbers) of each ``(side, build, kwargs, inputs)`` read with
    ``read(build, inputs, **kwargs)``, against ``ref`` (``program_again``
    against the program: its own run-to-run noise)."""
    first = None
    for side, build, kw, inputs in wanted:
        got = read(build, inputs, **kw)
        first = got if side == "program" else first
        base = first if side == "program_again" else ref
        yield side, dict(compare.gaps(got, base, cell.traffic["compare"]),
                         losses=got.losses, **compare.diagnostics(got, base))
        free(device)
