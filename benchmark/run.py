"""Run one cell of ``BENCHMARK.json`` once on the card and print its result
line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The cell's traffic file (``benchmark/workloads/<cell>.json``) names its
driver (``benchmark/drivers/<driver>.py``), which builds the program from
the cell's configuration, makes every input from the seed, warms up, runs
the measured window and decides ``correct`` against the plain reference.
With ``--trace 0`` the result carries the cell's end-to-end metrics; with
``--trace 1`` its per-layer metrics, each read by
``benchmark/metrics/<metric>.py`` from a traced window after the measured
one. The last lines on standard error, and the ``checks`` key of the
result, give each compared number beside its limit.
"""
from __future__ import annotations

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from benchmark.lib import harness  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    clock = harness.Clock()
    clock.t0 = STARTED
    cell = harness.load_cell(args.workload)
    harness.steady_host()
    harness.require_cards(cell.chips)
    out, checks = cell.driver().run(cell, args.seed, args.seconds,
                                    bool(args.trace), clock)
    correct = harness.passes(checks)

    wanted = cell.per_layer if args.trace else cell.end_to_end
    metrics = {}
    if args.trace:
        layer = out["layer"]
        for m in wanted:
            read = harness.metric_reader(m["name"])
            value = read(layer) if read is not None else None
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in wanted:
            if m["name"] in out["metrics"]:
                value, unit = out["metrics"][m["name"]]
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device = harness.device_info(cell.chips, out["peak_bytes"])
    if args.trace:
        device["busy_s"] = out["layer"].trace.busy_s
        device["window_s"] = out["layer"].trace.window_s
    power = harness.power_limit_w()
    print(f"card {device['kind']}, power limit {power} W", file=sys.stderr)

    loaded = harness.forbidden_loaded()
    if loaded:
        print(f"refused: the run loaded {loaded}", file=sys.stderr)
        return 3
    result = {"correct": correct, "attempted": out["attempted"],
              "failed": out["failed"], "metrics": metrics, "device": device}
    if args.trace:
        result["breakdown"] = out["layer"].trace.breakdown()
    harness.emit(result, checks)
    return 0


if __name__ == "__main__":
    sys.exit(main())
