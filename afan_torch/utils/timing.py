"""Host round trip and chained-window step timing — the PyTorch port's
counterpart of ``afan/utils/timing.py``.

A timing window chains its calls through the stream and ends with one
``fetch`` that needs every call's result (the sync); the host's round trip
for one value, measured by :func:`measure_rtt`, may be subtracted from each
window. Each probe reads a fresh one-element tensor (``.item()`` of a new
sum), so every probe pays a whole device-to-host trip.
"""
from __future__ import annotations

import time
from typing import Callable

import torch


def measure_rtt(probes: int = 10, device: str = "cuda") -> float:
    """The smallest host round trip, in seconds, over ``probes`` reads of a
    fresh one-element tensor on ``device`` (an add queued and its value
    read back with ``.item()``; the add's own time is negligible)."""
    x = torch.ones((), device=torch.device(device))
    (x + 1).item()        # first launch and transfer
    best = float("inf")
    for _ in range(probes):
        t0 = time.perf_counter()
        (x + 1).item()    # each probe reads a NEW, never-read tensor
        best = min(best, time.perf_counter() - t0)
    return best


def time_chained_windows(
    run_one: Callable[[], None],
    fetch: Callable[[], None],
    iters: int,
    windows: int = 3,
    rtt: float = 0.0,
) -> tuple[float, float]:
    """(min, median) per-iteration seconds across ``windows`` windows of
    ``iters`` chained calls each; ``fetch()`` must read one value that
    depends on every call of the window back to the host (the sync).
    ``rtt`` is subtracted from each window's total."""
    times = []
    for _ in range(windows):
        t0 = time.perf_counter()
        for _ in range(iters):
            run_one()
        fetch()
        times.append((time.perf_counter() - t0 - rtt) / iters)
    times.sort()
    return times[0], times[len(times) // 2]
