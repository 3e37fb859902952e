"""On the card: a short run of each cell prints a result line in the
contract's form, with ``correct`` true. Skips without a CUDA device."""
from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest
import torch

from benchmark.lib import harness


def _cells():
    with open(os.path.join(harness.ROOT, "BENCHMARK.json")) as f:
        return [w["name"] for w in json.load(f)["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", _cells())
def test_short_run_on_the_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    done = subprocess.run(
        [sys.executable, os.path.join(harness.BENCH_DIR, "run.py"),
         "--workload", cell, "--seed", str(2 ** 31 + 5), "--seconds", "3",
         "--trace", "0"], cwd=harness.ROOT, capture_output=True, text=True,
        timeout=900)
    assert done.returncode == 0, done.stderr[-3000:]
    line = json.loads(done.stdout.strip().splitlines()[-1])
    assert line["correct"] is True, line["checks"]
    assert line["device"]["platform"] == "gpu"
    assert "setup_s" in line["metrics"]
