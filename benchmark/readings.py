"""The readings a cell's limits are set from, on the card at the cell's own
size: for each seed, the program against the reference (the lower
reading), the control against it (the reference in the precision below
the configuration's) and each fault the cell can have (planted in the
program or in the reference put in its place); each driver's
``calibration_readings`` says which. The benchmark's own runs do not run
this.

    python3 benchmark/readings.py --workload seg-city-afan-bf16 \
        --seeds 11 12 13 --control --faults half_batch

Prints one JSON line per seed and side.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from benchmark.lib import harness  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control", action="store_true")
    p.add_argument("--faults", nargs="*", default=())
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    cell = harness.load_cell(args.workload)
    drv = cell.driver()
    for seed in args.seeds:
        for side, numbers in drv.calibration_readings(
                cell, seed, args.device, args.control, args.faults):
            print(json.dumps({"seed": seed, "side": side, **numbers}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
