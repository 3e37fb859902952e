"""What every run shares: the manifest and the files it names, the look
for a card, the device's description, the check that nothing of JAX or the
JAX package is loaded, and the result line.
"""
from __future__ import annotations

import dataclasses
import glob
import importlib.util
import json
import math
import os
import sys
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "afan")


def load_json(path: str) -> Dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: str, name: str):
    """Import the file ``path`` as a module called ``name``."""
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@dataclasses.dataclass
class Cell:
    """One cell of ``BENCHMARK.json`` with the files it names: its
    configuration, its traffic file, its driver and the metrics it
    reports."""
    name: str
    entry: Dict
    config: Dict
    traffic: Dict
    end_to_end: List[Dict]
    per_layer: List[Dict]

    @property
    def chips(self) -> int:
        return int(self.entry["chips"])

    def driver(self):
        path = os.path.join(BENCH_DIR, "drivers",
                            self.traffic["driver"] + ".py")
        return load_module(path, "bench_driver_" + self.traffic["driver"])


def _reports(metric: Dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: str = ROOT) -> Cell:
    """The cell ``name`` of ``<root>/BENCHMARK.json``: its entry, the
    configuration file it names, ``benchmark/workloads/<name>.json`` and
    the end-to-end and per-layer metrics it reports."""
    manifest = load_json(os.path.join(root, "BENCHMARK.json"))
    entries = [w for w in manifest["workloads"] if w["name"] == name]
    if not entries:
        raise SystemExit(f"no cell {name!r} in BENCHMARK.json")
    entry = entries[0]
    config_entry = [c for c in manifest["configs"]
                    if c["name"] == entry["config"]][0]
    config = load_json(os.path.join(root, config_entry["file"]))
    bench = os.path.join(root, os.path.relpath(BENCH_DIR, ROOT))
    traffic = load_json(os.path.join(bench, "workloads", name + ".json"))
    return Cell(name, entry, config, traffic,
                [m for m in manifest["end_to_end"] if _reports(m, name)],
                [m for m in manifest["per_layer"] if _reports(m, name)])


def kernel_names(op: str) -> List[str]:
    """The kernel function names that implement ``op``: every
    ``benchmark/kernels/<op>-<impl>.json``'s ``kernels``."""
    names = []
    for path in sorted(glob.glob(os.path.join(BENCH_DIR, "kernels",
                                              glob.escape(op) + "-*.json"))):
        names += load_json(path)["kernels"]
    return names


def metric_reader(name: str) -> Optional[Callable]:
    """``read(layer)`` of ``benchmark/metrics/<name>.py``, or None."""
    path = os.path.join(BENCH_DIR, "metrics", name + ".py")
    if not os.path.exists(path):
        return None
    return load_module(path, "bench_metric_" + name.replace(".", "_")).read


def forbidden_loaded() -> List[str]:
    """Top-level names of loaded modules that are JAX's or the JAX
    package's, compared whole (``afan_torch`` is not ``afan``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def steady_host(cores: int = 2) -> None:
    """Hold the run's host side still between runs: the process (and every
    thread it starts from here on) on the last ``cores`` of the cores it
    may use, and one intra-op thread, so that the host ops of a step run
    on the same cores each time."""
    import torch
    allowed = sorted(os.sched_getaffinity(0))
    os.sched_setaffinity(0, set(allowed[-cores:]))
    torch.set_num_threads(1)


def require_cards(n: int) -> None:
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this benchmark measures the card")
    if torch.cuda.device_count() < n:
        raise SystemExit(f"the cell needs {n} CUDA devices, "
                         f"{torch.cuda.device_count()} present")


def device_info(count: int, peak_bytes: int) -> Dict[str, Any]:
    import torch
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": count, "memory_peak_bytes": int(peak_bytes)}


def power_limit_w() -> Optional[float]:
    """The first card's power limit in watts as ``nvidia-smi`` reads it
    (None where it cannot)."""
    import subprocess
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=20)
        return float(out.stdout.split()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


Check = Tuple[str, float, float]        # (name, number, limit)


def passes(checks: List[Check]) -> bool:
    return all(math.isfinite(v) and v <= lim for _, v, lim in checks)


def emit(result: Dict, checks: List[Check]) -> None:
    """Print each compared number beside its limit as the last lines on
    standard error, then the result line (the compared numbers last in
    it) as the last line of standard output."""
    for name, value, limit in checks:
        print(f"check {name}: {value!r} limit {limit!r}", file=sys.stderr)
    result = dict(result)
    result["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in checks}
    sys.stderr.flush()
    print(json.dumps(result), flush=True)


class Clock:
    """The host clock from the start of the run."""

    def __init__(self):
        self.t0 = time.perf_counter()

    def now(self) -> float:
        return time.perf_counter() - self.t0
