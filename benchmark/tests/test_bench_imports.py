"""In a fresh interpreter: the harness, its drivers and metric readers, and
the program they drive, load no module whose top-level name is ``jax``,
``jaxlib``, ``flax``, ``optax`` or ``afan`` (compared whole:
``afan_torch`` is the program, not ``afan``); the plain reference loads
none of those and nothing of ``afan_torch``."""
from __future__ import annotations

import os
import subprocess
import sys

from benchmark.lib import harness

PROBE_HARNESS = """
import glob, os, sys
from benchmark.lib import harness, trace, work, rooflines, compare
for path in glob.glob(os.path.join(harness.BENCH_DIR, "drivers", "*.py")):
    harness.load_module(path, "d_" + os.path.basename(path)[:-3])
for path in glob.glob(os.path.join(harness.BENCH_DIR, "metrics", "*.py")):
    harness.metric_reader(os.path.basename(path)[:-3])
import afan_torch.cli.train_segment, afan_torch.cli.train_detect
import afan_torch.train.detect_loop
print(",".join(harness.forbidden_loaded()) or "none")
"""

PROBE_REFERENCE = """
import glob, importlib, os, sys
from benchmark.lib import harness
for path in sorted(glob.glob(os.path.join(harness.BENCH_DIR, "reference",
                                          "*.py"))):
    importlib.import_module("benchmark.reference."
                            + os.path.basename(path)[:-3])
bad = {m.split(".")[0] for m in sys.modules} & {
    "jax", "jaxlib", "flax", "optax", "afan", "afan_torch"}
print(",".join(sorted(bad)) or "none")
"""


def _fresh(code: str) -> str:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    done = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT,
                          capture_output=True, text=True, env=env)
    assert done.returncode == 0, done.stderr
    return done.stdout.strip().splitlines()[-1]


def test_harness_and_program_load_no_jax():
    assert _fresh(PROBE_HARNESS) == "none"


def test_reference_loads_neither_jax_nor_the_port():
    assert _fresh(PROBE_REFERENCE) == "none"


def test_forbidden_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "afan_torchx", sys)
    assert "afan" not in harness.forbidden_loaded()
    monkeypatch.setitem(sys.modules, "afan.core", sys)
    assert harness.forbidden_loaded() == ["afan"]
