"""afan_torch's ``infer_detect`` without PIL or OpenCV, against afan's.

- :func:`afan_torch.utils.draw.rectangle` and ``put_text`` against
  ``cv2.rectangle(..., 2)`` and ``cv2.putText(..., FONT_HERSHEY_SIMPLEX,
  0.5, color, 1)``, pixel for pixel, on random boxes, origins and
  backgrounds (boxes and labels across every edge of the image, reversed
  and degenerate boxes, corners a million pixels away), and every printable
  character.
- ``draw`` against ``afan``'s (which calls OpenCV) on every label the CLI
  can draw: the 20 VOC names and bare class numbers with every ``p:.2f``
  from 0.00 to 1.00.
- ``infer_detect image`` and ``dir`` against ``afan``'s CLI on committed
  fixtures, both with the weights of ``afan``'s seeded init (carried by
  ``frcnn_variables_to_state_dict``) at a ResNet-18 and a small canvas: the
  same detections (classes equal, boxes and probabilities within 1e-4 of
  their scale) and the same decoded pixels of the written file (``afan``'s
  through OpenCV's PNG writer, the port's through ``write_png``).
- ``scripts/torch_make_glyphs.py``'s table is the one committed.
"""
import os
import subprocess
import sys

import cv2
import jax
import numpy as np
import pytest
from PIL import Image

from afan.cli import infer_detect as j_infer_detect
from afan_torch.cli import infer_detect
from afan_torch.data.voc_det import VOC_CLASSES
from afan_torch.interop.from_jax import frcnn_variables_to_state_dict
from afan_torch.utils import draw, glyphs
from afan_torch.utils.imread import read_rgb
from torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IMAGES = os.path.join(ROOT, "tests", "fixtures", "torch_images")
FIXTURE = os.path.join(IMAGES, "voc_500x375.jpg")
CLI = ["-b", "resnet18", "--image_min_side", "64", "--image_max_side", "96"]
PRINTABLE = "".join(chr(c) for c in range(32, 127))


def random_point(rng, h, w, reach):
    return (int(rng.randint(-reach, w + reach)),
            int(rng.randint(-reach, h + reach)))


@pytest.mark.parametrize("reach", [10, 100, 1000000])
def test_rectangle_matches_opencv(reach):
    rng = np.random.RandomState(reach % 97)
    for i in range(2000):
        h, w = rng.randint(1, 80), rng.randint(1, 80)
        p1 = random_point(rng, h, w, reach)
        p2 = [p1, (p1[0], random_point(rng, h, w, reach)[1]),
              (random_point(rng, h, w, reach)[0], p1[1]),
              random_point(rng, h, w, reach)][i % 4]
        img = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
        color = tuple(int(v) for v in rng.randint(0, 256, 3))
        want = cv2.rectangle(img.copy(), p1, p2, color, 2)
        got = draw.rectangle(img.copy(), p1, p2, color)
        np.testing.assert_array_equal(got, want, err_msg=f"{p1} {p2}")


def test_put_text_matches_opencv():
    rng = np.random.RandomState(1)
    cases = [PRINTABLE] + ["".join(rng.choice(list(PRINTABLE),
                                              rng.randint(1, 30)))
                           for _ in range(1500)]
    for text in cases:
        h, w = rng.randint(5, 60), rng.randint(5, 300)
        org = (int(rng.randint(-120, w + 20)), int(rng.randint(-20, h + 30)))
        img = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
        color = tuple(int(v) for v in rng.randint(0, 256, 3))
        want = cv2.putText(img.copy(), text, org, cv2.FONT_HERSHEY_SIMPLEX,
                           0.5, color, 1)
        got = draw.put_text(img.copy(), text, org, color)
        np.testing.assert_array_equal(got, want, err_msg=repr(text))
    with pytest.raises(ValueError, match="no glyph"):
        draw.put_text(np.zeros((8, 8, 3), np.uint8), "é", (0, 7), (1, 2, 3))


def test_draw_matches_afan_on_every_label():
    """Every class (the 20 names, 0 and numbers past the names) with every
    two-decimal probability, boxes inside and across the image's edges."""
    rng = np.random.RandomState(2)
    img = rng.rand(120, 160, 3).astype(np.float32)
    classes = list(range(len(VOC_CLASSES) + 1)) + [21, 37, 100, 1234]
    dets = []
    for i in range(101 * len(classes)):
        c = classes[i % len(classes)]
        p = (i // len(classes)) / 100.0
        x1, y1 = rng.uniform(-60, 170), rng.uniform(-30, 130)
        box = np.array([x1, y1, x1 + rng.uniform(-5, 90),
                        y1 + rng.uniform(-5, 70)], np.float32)
        dets.append((box, c, p))
    for start in range(0, len(dets), 60):
        chunk = dets[start:start + 60]
        np.testing.assert_array_equal(infer_detect.draw(img, chunk),
                                      j_infer_detect.draw(img, chunk))


def test_committed_glyphs_are_the_scripts(tmp_path):
    """The script rewrites the table it checks against OpenCV; the
    committed table is that table (OpenCV's version named in it)."""
    assert glyphs.OPENCV_VERSION == cv2.__version__
    out = tmp_path / "glyphs.py"
    subprocess.run([sys.executable, os.path.join(ROOT, "scripts",
                                                  "torch_make_glyphs.py"),
                    "--out", str(out)], check=True, capture_output=True,
                   timeout=300)
    committed = os.path.join(ROOT, "afan_torch", "utils", "glyphs.py")
    assert out.read_text() == open(committed).read()


# ---------- the CLI ----------

@pytest.fixture(scope="module")
def afan_weights():
    """``afan``'s CLI state (its seeded init) at the test's sizes."""
    args = j_infer_detect.argparse.Namespace(
        backbone="resnet18", image_min_side=64.0, image_max_side=96.0,
        checkpoint=None)
    model, state, canvas_hw = j_infer_detect.build_state(args)
    return model, state, canvas_hw


def recorded(monkeypatch, module, out):
    real = module.detect_image

    def detect_image(*a):
        dets = real(*a)
        out.append(dets)
        return dets
    monkeypatch.setattr(module, "detect_image", detect_image)


def run_both(tmp_path, monkeypatch, afan_weights, mode, src, thresh):
    model, state, canvas_hw = afan_weights
    monkeypatch.setattr(j_infer_detect, "build_state",
                        lambda args: (model, state, canvas_hw))
    sd = frcnn_variables_to_state_dict(jax.device_get(state.variables()))
    real = infer_detect.build_state

    def port_state(args, num_classes=21, device=None):
        tm, hw = real(args, num_classes, device)
        tm.load_state_dict(sd)
        return tm, hw
    monkeypatch.setattr(infer_detect, "build_state", port_state)
    want, got = [], []
    recorded(monkeypatch, j_infer_detect, want)
    recorded(monkeypatch, infer_detect, got)
    flags = CLI + ["-p", str(thresh)]
    j_infer_detect.main([mode, src, str(tmp_path / "afan.png")] + flags)
    infer_detect.main([mode, src, str(tmp_path / "port.png"), "--device",
                       "cpu"] + flags)
    return want, got


def same_detections(got, want):
    assert len(got) == len(want) and len(got) > 0
    for (gb, gc, gp), (wb, wc, wp) in zip(got, want):
        assert gc == wc
        np.testing.assert_allclose(gb, wb, rtol=0,
                                   atol=1e-4 * np.abs(wb).max())
        assert abs(gp - wp) <= 1e-4


@pytest.mark.parametrize("mode", ["image", "dir"])
def test_cli_matches_afan(tmp_path, monkeypatch, afan_weights, mode):
    """The same detections and the same pixels. ``dir`` names each output
    ``<name>.png``; ``afan`` keeps the input's name and so its format, and
    its JPEG is lossy, so there the port's pixels are held to ``afan``'s
    drawing of ``afan``'s detections."""
    names = ["voc_500x375.jpg"]
    src = FIXTURE
    if mode == "dir":
        names = ["label_500x375.png", "voc_500x375.jpg"]   # sorted
        src = tmp_path / "in"
        src.mkdir()
        for name in names:
            (src / name).write_bytes(open(os.path.join(IMAGES, name),
                                          "rb").read())
        (src / "notes.txt").write_text("not an image")
        src = str(src)
    # a threshold under the init's best probabilities: a few detections
    want, got = run_both(tmp_path, monkeypatch, afan_weights, mode, src,
                         0.06)
    assert len(got) == len(want) == len(names)
    if mode == "dir":
        assert sorted(os.listdir(tmp_path / "port.png")) == [
            "label_500x375.png", "voc_500x375.png"]
    for name, g, w in zip(names, got, want):
        same_detections(g, w)
        stem = os.path.splitext(name)[0]
        port_out = (tmp_path / "port.png" if mode == "image" else
                    tmp_path / "port.png" / f"{stem}.png")
        afan_out = (tmp_path / "afan.png" if mode == "image" else
                    tmp_path / "afan.png" / name)
        assert open(port_out, "rb").read(8) == b"\x89PNG\r\n\x1a\n"
        got_px = read_rgb(str(port_out))
        img = np.asarray(Image.open(os.path.join(IMAGES, name))
                         .convert("RGB"), np.float32) / 255.0
        np.testing.assert_array_equal(got_px, j_infer_detect.draw(img, w))
        if name.endswith(".png") or mode == "image":
            np.testing.assert_array_equal(got_px, read_rgb(str(afan_out)))
