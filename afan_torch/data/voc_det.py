"""PASCAL VOC detection data — the parts of ``afan/data/voc_det.py`` the
detection server uses: the class names, the resize rule and the resize.

``resize_image`` does what PIL's ``Image.resize(..., Image.BILINEAR)`` does
to an 8-bit RGB image (the machine with the card has no PIL), in the same
fixed-point arithmetic, so the two agree bit for bit: per axis, the
triangle filter's weights over a support widened by the downscale factor,
normalized per output index in float64 and rounded to ``2**22`` fixed
point; then a horizontal and a vertical pass, each accumulated in integers
from one half, shifted back and clipped to uint8 (Pillow's
``ImagingResample``, ``libImaging/Resample.c``).
"""
from __future__ import annotations

import numpy as np
import torch

VOC_CLASSES = (
    "aeroplane", "bicycle", "bird", "boat", "bottle", "bus", "car", "cat",
    "chair", "cow", "diningtable", "dog", "horse", "motorbike", "person",
    "pottedplant", "sheep", "sofa", "train", "tvmonitor")   # labels 1..20

PRECISION_BITS = 32 - 8 - 2     # Pillow's fixed point for 8-bit images


def compute_scale(width: int, height: int, image_min_side: float,
                  image_max_side: float) -> float:
    """The resize rule of `dataset/base.py:75-86`: shorter side to
    ``image_min_side``, then cap the longer side at ``image_max_side``."""
    scale = image_min_side / min(width, height)
    longer = max(width, height) * scale
    if longer > image_max_side:
        scale *= image_max_side / longer
    return scale


def _bilinear_coeffs(n_in: int, n_out: int):
    """Pillow's ``precompute_coeffs`` for the bilinear (triangle) filter and
    its ``normalize_coeffs_8bpc``: each output index's first source index
    ``(n_out,)`` and fixed-point weights ``(n_out, k)``, zero past its
    support. ``k`` is the widest support that occurs, not Pillow's
    ``2 * ceil(support) + 1``: the weights past it are all zero."""
    scale = n_in / n_out
    filterscale = max(scale, 1.0)
    support = 1.0 * filterscale
    center = (np.arange(n_out) + 0.5) * scale
    # C's (int) truncates toward zero; a negative start clamps to 0 anyway
    xmin = np.maximum((center - support + 0.5).astype(np.int64), 0)
    xmax = np.minimum((center + support + 0.5).astype(np.int64), n_in)
    k = max(int((xmax - xmin).max()), 1)
    x = xmin[:, None] + np.arange(k)[None, :]
    w = np.maximum(1.0 - np.abs((x - center[:, None] + 0.5)
                                * (1.0 / filterscale)), 0.0)
    w = np.where(x < xmax[:, None], w, 0.0)
    ww = w.sum(axis=1, keepdims=True)
    w = np.where(ww != 0.0, w / np.where(ww != 0.0, ww, 1.0), w)
    fixed = np.trunc(0.5 + w * (1 << PRECISION_BITS)).astype(np.int32)
    return xmin, fixed


def _resample_rows(x: torch.Tensor, n_out: int) -> torch.Tensor:
    """One of Pillow's two passes, along dim 0 of the contiguous int32 image
    ``x`` (values 0-255): a weighted sum of each output index's taps from
    one half, shifted back by ``PRECISION_BITS`` and clipped to 0-255 (the
    pass's uint8 result, kept in int32). The sum is taken tap by tap in
    int32, as Pillow takes it: the weights are non-negative and sum to about
    ``2**22``, so it stays below ``255 * 2**22 + 2**21 < 2**31``. Gathering
    whole rows keeps each tap a contiguous copy."""
    n_in = x.shape[0]
    xmin, fixed = _bilinear_coeffs(n_in, n_out)
    idx = torch.from_numpy(
        np.minimum(xmin[:, None] + np.arange(fixed.shape[1]), n_in - 1))
    weights = torch.from_numpy(fixed).reshape(
        fixed.shape + (1,) * (x.dim() - 1))
    acc = None
    for t in range(fixed.shape[1]):
        term = x.index_select(0, idx[:, t]).mul_(weights[:, t])
        acc = (term.add_(1 << (PRECISION_BITS - 1)) if acc is None
               else acc.add_(term))
    return acc.bitwise_right_shift_(PRECISION_BITS).clamp_(0, 255)


def resize_image(img: np.ndarray, scale: float) -> np.ndarray:
    """Bilinear resize of a float [0, 1] HWC image by ``scale``, through
    uint8 as the reference's PIL path does (`base.py:84-88`): horizontal
    pass first (on the transposed image), and a pass whose axis keeps its
    size is skipped, as in PIL."""
    h, w = img.shape[:2]
    out_h, out_w = round(h * scale), round(w * scale)
    x = torch.from_numpy((img * 255).astype(np.uint8)).to(torch.int32)
    if out_w != w:
        x = _resample_rows(x.transpose(0, 1).contiguous(), out_w)
        x = x.transpose(0, 1).contiguous()
    if out_h != h:
        x = _resample_rows(x, out_h)
    return x.to(torch.uint8).numpy().astype(np.float32) / 255.0
