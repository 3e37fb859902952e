"""Box and label drawing for ``infer_detect`` without OpenCV, which the
machine with the card does not have: ``cv2.rectangle(img, p1, p2, color,
2)`` and ``cv2.putText(img, text, org, cv2.FONT_HERSHEY_SIMPLEX, 0.5,
color, 1)`` on a ``(H, W, 3)`` uint8 image, pixel for pixel, at any
position (the parts off the image clipped).

- A rectangle of thickness 2 is OpenCV's closed polyline of four thick
  lines (``ThickLine``: a filled polygon one pixel to each side of the
  segment, and a filled circle of radius 1, a plus, at each end). For an
  axis-aligned segment from ``a`` to ``b`` that is the band of three rows
  (columns) over ``[a, b]`` and one more pixel at each end of the middle
  row (column).
- Text: OpenCV 5 draws the font anti-aliased, glyph by glyph. Each glyph is
  an 8-bit coverage map at an integer offset from the pen, blended into
  the image in the text's order, ``(bg * (255 - a) + color * a + 127) //
  255`` per channel; the pen then moves by the glyph's integer advance.
  The maps and advances are data (:mod:`afan_torch.utils.glyphs`, written
  from OpenCV by ``scripts/torch_make_glyphs.py``, which checks them).
"""
from __future__ import annotations

import functools
from typing import Dict, Sequence, Tuple

import numpy as np

Glyph = Tuple[int, int, int, np.ndarray]


def _fill(img: np.ndarray, y0: int, y1: int, x0: int, x1: int,
          color: np.ndarray) -> None:
    """Set rows ``y0..y1`` and columns ``x0..x1`` (inclusive, clipped)."""
    h, w = img.shape[:2]
    y0, y1, x0, x1 = max(y0, 0), min(y1, h - 1), max(x0, 0), min(x1, w - 1)
    if y0 <= y1 and x0 <= x1:
        img[y0:y1 + 1, x0:x1 + 1] = color


def rectangle(img: np.ndarray, p1: Sequence[int], p2: Sequence[int],
              color: Sequence[int]) -> np.ndarray:
    """``cv2.rectangle(img, p1, p2, color, 2)`` in place; returns
    ``img``."""
    (x1, y1), (x2, y2) = (int(v) for v in p1), (int(v) for v in p2)
    color = np.asarray(color, img.dtype)
    xa, xb, ya, yb = min(x1, x2), max(x1, x2), min(y1, y2), max(y1, y2)
    for y in (y1, y2):
        _fill(img, y - 1, y + 1, xa, xb, color)
        _fill(img, y, y, xa - 1, xb + 1, color)
    for x in (x1, x2):
        _fill(img, ya, yb, x - 1, x + 1, color)
        _fill(img, ya - 1, yb + 1, x, x, color)
    return img


@functools.lru_cache(maxsize=1)
def glyph_table() -> Dict[str, Glyph]:
    """{character: (advance, x0, y0, coverage map (h, w) uint8)}."""
    from .glyphs import GLYPHS
    table = {}
    for ch, (adv, x0, y0, w, *rows) in GLYPHS.items():
        data = np.frombuffer(bytes.fromhex("".join(rows)), np.uint8)
        table[ch] = (adv, x0, y0, data.reshape(-1, w) if w else
                     np.zeros((0, 0), np.uint8))
    return table


def put_text(img: np.ndarray, text: str, org: Sequence[int],
             color: Sequence[int], table: Dict[str, Glyph] = None
             ) -> np.ndarray:
    """``cv2.putText(img, text, org, cv2.FONT_HERSHEY_SIMPLEX, 0.5, color,
    1)`` in place (``org``: the baseline's left end); returns ``img``.
    ``table`` replaces :func:`glyph_table`."""
    table = glyph_table() if table is None else table
    x, y = (int(v) for v in org)
    h, w = img.shape[:2]
    col = np.asarray(color, np.int64)
    for ch in text:
        if ch not in table:
            raise ValueError(f"no glyph for {ch!r}")
        adv, gx, gy, cov = table[ch]
        y0, x0 = y + gy, x + gx
        ya, yb = max(y0, 0), min(y0 + cov.shape[0], h)
        xa, xb = max(x0, 0), min(x0 + cov.shape[1], w)
        if ya < yb and xa < xb:
            a = cov[ya - y0:yb - y0, xa - x0:xb - x0, None].astype(np.int64)
            bg = img[ya:yb, xa:xb].astype(np.int64)
            img[ya:yb, xa:xb] = (bg * (255 - a) + col * a + 127) // 255
        x += adv
    return img
