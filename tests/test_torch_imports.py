"""The port's import rule: no module of ``afan_torch`` and not
``chip_smoke.py`` imports jax, flax, optax or anything of ``afan`` (whose
``__init__`` imports jax). Checked in a fresh interpreter, because
``tests/conftest.py`` has already imported jax in this one."""
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CHECK = """
import importlib, pkgutil, sys
import afan_torch
names = [m.name for m in pkgutil.walk_packages(afan_torch.__path__,
                                               "afan_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "afan"))
print(len(names), "modules")
sys.exit(f"imported {bad}" if bad else 0)
"""


def test_port_imports_neither_jax_nor_afan():
    proc = subprocess.run([sys.executable, "-c", CHECK], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert int(proc.stdout.split()[0]) >= 40


def test_data_parallel_rank_side_imports_neither_jax_nor_afan():
    """The spawned ranks of the data-parallel tests import
    ``tests/torch_dp_ranks.py`` (and the launcher); they must not pull jax
    in: the machine with the card has no jax."""
    check = ("import sys\n"
             "sys.path.insert(0, 'tests')\n"
             "import torch_dp_ranks, afan_torch.parallel.launch\n"
             "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
             "('jax', 'jaxlib', 'flax', 'optax', 'afan'))\n"
             "sys.exit(f'imported {bad}' if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", check], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
