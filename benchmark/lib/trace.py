"""A traced window: ``torch.profiler`` (host and CUDA activities) over a
few units of work, reduced to what the per-layer readers take: the device
operations with their times, the busy seconds (the union of the device
operations' intervals), the window's length, the top device operations
and the longest idle gaps named by what the host was doing.
"""
from __future__ import annotations

import bisect
import dataclasses
import re
from typing import Callable, Dict, List, Sequence, Tuple

WINDOW = "bench.traced_window"
SEARCH_BACK = 4096


def base_name(kernel: str) -> str:
    """A kernel's function name: ``void ns::(anonymous namespace)::f<19,
    T>(args)`` → ``f``."""
    name = kernel.replace("(anonymous namespace)::", "").strip()
    name = re.sub(r"^void\s+", "", name)
    name = re.split(r"[<(]", name, maxsplit=1)[0]
    return name.split("::")[-1].strip()


@dataclasses.dataclass
class Trace:
    ops: List[Tuple[str, float, float]]     # (name, start us, end us)
    host: List[Tuple[str, float, float]]
    t0: float
    t1: float
    units: int

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e6

    def intervals(self) -> List[Tuple[float, float]]:
        merged = []
        for _, s, e in sorted(self.ops, key=lambda o: o[1]):
            s, e = max(s, self.t0), min(e, self.t1)
            if e <= s:
                continue
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return [tuple(m) for m in merged]

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.intervals()) / 1e6

    def kernels(self) -> List[Tuple[str, float, float]]:
        """Kernels alone (no copies or fills)."""
        return [o for o in self.ops if not o[0].startswith(("Memcpy",
                                                            "Memset"))]

    def seconds_of(self, names: Sequence[str]) -> float:
        """Device seconds of the kernels whose function name is in
        ``names``."""
        want = set(names)
        return sum(e - s for n, s, e in self.ops
                   if base_name(n) in want) / 1e6

    def top_ops(self, k: int = 10) -> List[List]:
        total: Dict[str, float] = {}
        for n, s, e in self.ops:
            key = base_name(n)
            total[key] = total.get(key, 0.0) + (e - s) / 1e6
        return [[n, t] for n, t in sorted(total.items(),
                                          key=lambda x: -x[1])[:k]]

    def idle_gaps(self, k: int = 10) -> List[List]:
        """The idle seconds of the window summed by the innermost host
        operation running at each gap's middle, the largest ``k``."""
        edges, at = [], self.t0
        for s, e in self.intervals():
            if s > at:
                edges.append((at, s))
            at = e
        if self.t1 > at:
            edges.append((at, self.t1))
        host = sorted(self.host, key=lambda h: h[1])
        starts = [h[1] for h in host]
        total: Dict[str, float] = {}
        for s, e in edges:
            mid = (s + e) / 2
            name = "host: no operation"
            # host operations nest: the innermost one covering the middle
            # is the covering one that started last
            i = bisect.bisect_right(starts, mid) - 1
            for j in range(i, max(i - SEARCH_BACK, -1), -1):
                if host[j][2] >= mid:
                    name = host[j][0]
                    break
            total[name] = total.get(name, 0.0) + (e - s) / 1e6
        return [[n, t] for n, t in sorted(total.items(),
                                          key=lambda x: -x[1])[:k]]

    def breakdown(self) -> Dict:
        return {"device_ops": self.top_ops(), "idle_gaps": self.idle_gaps()}


def traced(work: Callable[[], int], warm: Callable[[], object]) -> Trace:
    """Run ``warm()`` under a first profiler session and again while the
    measuring one warms up (their records dropped), then ``work()`` (which
    returns how many units it ran) under it, recording the host's
    operations and the device's; the window is the host span around
    ``work()`` and the final synchronise."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import (ProfilerActivity, profile, record_function,
                                schedule)
    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with profile(activities=activities):
        warm()              # the process's first session starts the tracers
        torch.cuda.synchronize()
    done = []
    with profile(activities=activities,
                 schedule=schedule(wait=0, warmup=1, active=1),
                 on_trace_ready=lambda p: done.append(p.events())) as prof:
        warm()
        torch.cuda.synchronize()
        prof.step()
        with record_function(WINDOW):
            units = work()
            torch.cuda.synchronize()
        prof.step()
    if not done:
        raise RuntimeError("the profiler handed over no trace")
    ops, hosts, window = [], [], None
    for e in done[0]:
        span = (e.name, float(e.time_range.start), float(e.time_range.end))
        if e.device_type == DeviceType.CUDA:
            # user annotations (the window, "Optimizer.step#SGD.step")
            # are spans over kernels, not operations
            if not (getattr(e, "is_user_annotation", False)
                    or e.name == WINDOW or "#" in e.name):
                ops.append(span)
        elif e.name == WINDOW:
            window = span
        elif not e.name.startswith("ProfilerStep"):
            hosts.append(span)
    if not ops or window is None:
        raise RuntimeError("the trace holds no device operation or window")
    return Trace(ops, hosts, window[1], window[2], units)
