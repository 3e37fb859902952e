"""Write the image fixtures of ``tests/test_torch_imread.py`` and
``chip_smoke.py --only data`` with PIL, and their manifest: the sha256 of
PIL's decoded bytes (``np.asarray(Image.open(p).convert("RGB"))`` for an
image, ``np.asarray(Image.open(p), np.uint8)`` for a label map).

    python tests/fixtures/torch_images/make_fixtures.py

The content is smooth and synthetic: sines over the image plane, a little
seeded noise, and for the label map class rectangles with 255 borders.
"""
import hashlib
import json
import os

import numpy as np
from PIL import Image

HERE = os.path.dirname(os.path.abspath(__file__))


def smooth(h, w, seed):
    rng = np.random.RandomState(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.stack([128 + 100 * np.sin(x / 37 + seed) * np.cos(y / 29),
                    128 + 110 * np.sin((x + 2 * y) / 53 + seed),
                    128 + 90 * np.cos((x - y) / 41)], -1)
    img += rng.randn(h, w, 3) * 4
    return np.clip(img, 0, 255).astype(np.uint8)


def label_map(h, w, seed):
    rng = np.random.RandomState(seed)
    lab = np.zeros((h, w), np.uint8)
    for _ in range(4):
        c = rng.randint(1, 21)
        y0, x0 = rng.randint(0, h - 80), rng.randint(0, w - 80)
        y1, x1 = y0 + rng.randint(40, 80), x0 + rng.randint(40, 80)
        lab[y0:y1, x0:x1] = 255          # the object's border: ignored
        lab[y0 + 3:y1 - 3, x0 + 3:x1 - 3] = c
    return lab


def voc_palette():
    pal = np.zeros((256, 3), np.uint8)
    for i in range(256):
        c, r, g, b = i, 0, 0, 0
        for j in range(8):
            r |= ((c >> 0) & 1) << (7 - j)
            g |= ((c >> 1) & 1) << (7 - j)
            b |= ((c >> 2) & 1) << (7 - j)
            c >>= 3
        pal[i] = (r, g, b)
    return pal


FIXTURES = {
    "voc_500x375.jpg": lambda p: Image.fromarray(smooth(375, 500, 1)).save(
        p, quality=85, subsampling=2),
    "voc_375x500.jpg": lambda p: Image.fromarray(smooth(500, 375, 2)).save(
        p, quality=85, subsampling=2),
    "coco_640x480.jpg": lambda p: Image.fromarray(smooth(480, 640, 3)).save(
        p, quality=90),
    "gray_200x150.jpg": lambda p: Image.fromarray(
        smooth(150, 200, 4)[..., 1]).save(p, quality=80),
    "restart_333x257.jpg": lambda p: Image.fromarray(
        smooth(257, 333, 5)).save(p, quality=75, subsampling=1,
                                  restart_marker_rows=1),
}


def write_label(p):
    im = Image.fromarray(label_map(375, 500, 6), mode="P")
    im.putpalette(voc_palette().tobytes())
    im.save(p)


FIXTURES["label_500x375.png"] = write_label


def decoded(path):
    if path.endswith(".png"):
        return np.asarray(Image.open(path), np.uint8)
    return np.asarray(Image.open(path).convert("RGB"))


def manifest():
    out = {}
    for name in sorted(FIXTURES):
        a = decoded(os.path.join(HERE, name))
        out[name] = {"shape": list(a.shape),
                     "sha256": hashlib.sha256(a.tobytes()).hexdigest()}
    return out


if __name__ == "__main__":
    for name, write in FIXTURES.items():
        write(os.path.join(HERE, name))
    with open(os.path.join(HERE, "manifest.json"), "w") as f:
        json.dump(manifest(), f, indent=1, sort_keys=True)
        f.write("\n")
