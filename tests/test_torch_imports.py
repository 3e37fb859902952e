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


def test_infer_detect_image_and_dir_import_neither_pil_nor_opencv(tmp_path):
    """``infer_detect image`` and ``dir`` run where PIL and OpenCV cannot
    be imported (the machine with the card has neither), and import no
    jax or ``afan``."""
    images = os.path.join(ROOT, "tests", "fixtures", "torch_images")
    src = tmp_path / "in"
    src.mkdir()
    for name in ("voc_500x375.jpg", "label_500x375.png"):
        (src / name).write_bytes(open(os.path.join(images, name),
                                      "rb").read())
    check = (
        "import sys\n"
        "sys.modules['PIL'] = sys.modules['cv2'] = None  # imports raise\n"
        "from afan_torch.cli import infer_detect\n"
        "flags = ['-b', 'resnet18', '--image_min_side', '64',\n"
        "         '--image_max_side', '96', '--device', 'cpu', '-p', '0.0']\n"
        f"infer_detect.main(['image', {str(src / 'voc_500x375.jpg')!r},\n"
        f"                   {str(tmp_path / 'one.png')!r}] + flags)\n"
        f"infer_detect.main(['dir', {str(src)!r},\n"
        f"                   {str(tmp_path / 'out')!r}] + flags)\n"
        "banned = ('jax', 'jaxlib', 'flax', 'optax', 'afan', 'PIL', 'cv2')\n"
        "bad = sorted(m for m, v in sys.modules.items()\n"
        "             if v is not None and m.split('.')[0] in banned)\n"
        "sys.exit(f'imported {bad}' if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", check], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert sorted(os.listdir(tmp_path / "out")) == ["label_500x375.png",
                                                    "voc_500x375.png"]
    assert (tmp_path / "one.png").read_bytes()[:4] == b"\x89PNG"
