"""Write ``afan_torch/utils/glyphs.py``: the glyphs that OpenCV's
``cv2.putText(img, text, org, cv2.FONT_HERSHEY_SIMPLEX, 0.5, color, 1)``
draws for each printable ASCII character, as ``afan``'s ``infer_detect``
labels its boxes, so that the port draws them on a machine without OpenCV.

    python scripts/torch_make_glyphs.py [--out PATH]

OpenCV 5 draws this font anti-aliased, glyph by glyph: each glyph is an
8-bit coverage map at an integer offset from the pen, blended into the
image in the text's order as ``(bg * (255 - a) + color * a + 127) // 255``
per channel, and the pen moves by the glyph's integer advance. This script
reads each map from a white-on-black ``putText`` of the character alone,
and its advance from the character followed by ``l``; it then checks the
model against ``putText`` on random strings, origins (partly off the image
too), colours and backgrounds, and refuses to write a table that misses.
"""
import argparse
import os
import sys
import textwrap

import cv2
import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "afan_torch", "utils", "glyphs.py")
sys.path.insert(0, ROOT)

FONT, SCALE, THICKNESS = cv2.FONT_HERSHEY_SIMPLEX, 0.5, 1
CHARS = [chr(c) for c in range(32, 127)]
PEN = (60, 60)
CANVAS = (120, 200)


def coverage(text, org=PEN, shape=CANVAS):
    img = np.zeros(shape + (3,), np.uint8)
    cv2.putText(img, text, org, FONT, SCALE, (255, 255, 255), THICKNESS)
    return img[..., 0].astype(np.int64)


def glyph_map(ch):
    """(x0, y0, coverage map) of ``ch`` drawn alone at the pen."""
    a = coverage(ch)
    ys, xs = np.nonzero(a)
    if not len(ys):
        return 0, 0, np.zeros((0, 0), np.uint8)
    return (int(xs.min() - PEN[0]), int(ys.min() - PEN[1]),
            a[ys.min():ys.max() + 1, xs.min():xs.max() + 1].astype(np.uint8))


def advance(ch, maps):
    """The pen's move after ``ch``: the one offset of ``l`` at which the
    maps of ``ch`` and ``l`` give ``putText(ch + "l")``."""
    from afan_torch.utils import draw
    want = coverage(ch + "l")
    hits = []
    for dx in range(40):
        img = np.zeros(CANVAS + (3,), np.uint8)
        table = {"l": (0,) + maps["l"]}
        table[ch] = (dx,) + maps[ch]
        draw.put_text(img, ch + "l", PEN, (255, 255, 255), table)
        if np.array_equal(img[..., 0], want):
            hits.append(dx)
    if len(hits) != 1:
        raise SystemExit(f"{ch!r}: advances {hits} fit")
    return hits[0]


def check(table, n=4000, seed=0):
    from afan_torch.utils import draw
    rng = np.random.RandomState(seed)
    for _ in range(n):
        text = "".join(rng.choice(CHARS, rng.randint(1, 30)))
        h, w = rng.randint(5, 60), rng.randint(5, 200)
        org = (int(rng.randint(-100, w + 20)), int(rng.randint(-20, h + 30)))
        color = tuple(int(v) for v in rng.randint(0, 256, 3))
        img = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
        want = img.copy()
        cv2.putText(want, text, org, FONT, SCALE, color, THICKNESS)
        got = draw.put_text(img.copy(), text, org, color, table)
        if not np.array_equal(got, want):
            raise SystemExit(f"{text!r} at {org} on {h}x{w}: the table "
                             f"misses putText")


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", default=OUT)
    out = parser.parse_args(argv).out
    maps = {ch: glyph_map(ch) for ch in CHARS}
    table = {ch: (advance(ch, maps),) + maps[ch] for ch in CHARS}
    check(table)
    lines = [
        '"""The glyphs of ``cv2.putText(img, text, org, '
        'cv2.FONT_HERSHEY_SIMPLEX, 0.5,',
        f'color, 1)`` in OpenCV {cv2.__version__}, for printable ASCII: per '
        'character the',
        "pen's advance, the coverage map's offset from the pen (x, y; y down "
        "from",
        "the baseline), its width and its bytes (hex, row by row). Written "
        "by",
        "``scripts/torch_make_glyphs.py``; do not edit.",
        '"""',
        f"OPENCV_VERSION = {cv2.__version__!r}",
        "",
        "GLYPHS = {",
    ]
    for ch in CHARS:
        adv, x0, y0, m = table[ch]
        hexes = textwrap.wrap(m.tobytes().hex(), 60) or [""]
        body = "\n".join(f"        {h!r}" for h in hexes)
        lines.append(f"    {ch!r}: ({adv}, {x0}, {y0}, {m.shape[1]},\n"
                     f"{body}),")
    lines.append("}")
    with open(out, "w") as f:
        f.write("\n".join(lines) + "\n")
    print(f"wrote {out}: {len(table)} glyphs, checked against putText")


if __name__ == "__main__":
    main()
