"""Box arithmetic for the detection stack — the PyTorch counterpart of
``afan/models/frcnn/boxes.py``.

All functions broadcast over leading axes; boxes are [x1, y1, x2, y2] corner
format, float32, absolute pixel coordinates.
"""
from __future__ import annotations

import torch


def to_center(boxes: torch.Tensor) -> torch.Tensor:
    """corner → (cx, cy, w, h)."""
    return torch.stack([
        (boxes[..., 0] + boxes[..., 2]) / 2,
        (boxes[..., 1] + boxes[..., 3]) / 2,
        boxes[..., 2] - boxes[..., 0],
        boxes[..., 3] - boxes[..., 1],
    ], dim=-1)


def from_center(cb: torch.Tensor) -> torch.Tensor:
    """(cx, cy, w, h) → corner."""
    return torch.stack([
        cb[..., 0] - cb[..., 2] / 2,
        cb[..., 1] - cb[..., 3] / 2,
        cb[..., 0] + cb[..., 2] / 2,
        cb[..., 1] + cb[..., 3] / 2,
    ], dim=-1)


def encode_deltas(src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """(dx/w, dy/h, log dw, log dh), with the ratio clamped away from 0 so
    degenerate (padded) boxes give finite logs."""
    s, d = to_center(src), to_center(dst)
    sw = torch.clamp(s[..., 2], min=1e-6)
    sh = torch.clamp(s[..., 3], min=1e-6)
    return torch.stack([
        (d[..., 0] - s[..., 0]) / sw,
        (d[..., 1] - s[..., 1]) / sh,
        torch.log(torch.clamp(d[..., 2] / sw, min=1e-6)),
        torch.log(torch.clamp(d[..., 3] / sh, min=1e-6)),
    ], dim=-1)


def decode_deltas(src: torch.Tensor, deltas: torch.Tensor) -> torch.Tensor:
    """Apply (dx, dy, log dw, log dh) deltas to ``src`` boxes."""
    s = to_center(src)
    return from_center(torch.stack([
        deltas[..., 0] * s[..., 2] + s[..., 0],
        deltas[..., 1] * s[..., 3] + s[..., 1],
        torch.exp(deltas[..., 2]) * s[..., 2],
        torch.exp(deltas[..., 3]) * s[..., 3],
    ], dim=-1))


def iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched IoU: a (..., Na, 4), b (..., Nb, 4) → (..., Na, Nb), without
    the +1 pixel convention (that is NMS-only)."""
    area_a = (a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1])
    area_b = (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = torch.clamp(rb - lt, min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = area_a[..., :, None] + area_b[..., None, :] - inter
    return inter / torch.clamp(union, min=1e-12)


def inside(boxes: torch.Tensor, left: float, top: float, right: float,
           bottom: float) -> torch.Tensor:
    """Whether each box lies wholly inside the image."""
    return ((boxes[..., 0] >= left) & (boxes[..., 1] >= top)
            & (boxes[..., 2] <= right) & (boxes[..., 3] <= bottom))


def clip(boxes: torch.Tensor, left: float, top: float, right: float,
         bottom: float) -> torch.Tensor:
    """Clamp to image bounds."""
    x = torch.clamp(boxes[..., 0::2], left, right)
    y = torch.clamp(boxes[..., 1::2], top, bottom)
    return torch.stack([x[..., 0], y[..., 0], x[..., 1], y[..., 1]], dim=-1)


# delta normalization of the ROI head
TRANSFORMER_NORMALIZE_MEAN = (0.0, 0.0, 0.0, 0.0)
TRANSFORMER_NORMALIZE_STD = (0.1, 0.1, 0.2, 0.2)
