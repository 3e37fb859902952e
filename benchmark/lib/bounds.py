"""The yardstick's arithmetic: the card's published peaks, and the least
bytes and operations of each hand-written kernel's work, counted from the
call's shapes and data (never from the kernel).

A kernel's least time is the larger of its bytes over the HBM rate and its
operations over the rate of the unit that runs them; its roofline share is
that least time over the device time the trace gives the kernels that
implement it. The constants are those of ``chip_smoke.py`` (its bound
arithmetic for the three kernels); ``benchmark/tests/test_bench_bounds.py``
holds the two equal.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

# NVIDIA H100 SXM data sheet, dense, at the 700 W power limit.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12           # float32 outside the tensor cores
PEAK_FLOPS = {"bfloat16": 989e12, "tf32": 495e12, "float32": 67e12}

# Greedy NMS: each IoU test is 16 float32 operations.
OPS_PER_IOU = 16
# Bilinear upsample + masked CE, per (valid pixel, class) at its least: a
# separable 2-tap lerp along W then H (3 + 3 h / H), the log-sum-exp (4);
# the backward recomputes the forward, forms softmax - onehot (3) and runs
# the transposed interpolation; per valid pixel 3 more (log, lse - picked,
# the masked sum).
CE_LERP_OPS = 3
CE_LSE_OPS = 4
CE_SOFTMAX_GRAD_OPS = 3
CE_PIXEL_OPS = 3
# The PGD update x + gamma * sign(g): sign, multiply, add; the clip adds
# c - eps, c + eps, maximum and minimum.
PGD_OPS, PGD_CLIP_OPS = 3, 7

Parts = Tuple[float, float]     # (bytes, operations)


def least_seconds(nbytes: float, ops: float, ops_per_s: float = F32_OPS_PER_S
                  ) -> Tuple[float, str]:
    """(least seconds, "bytes" or "operations": the bound that sets it)."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / ops_per_s
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def resize_ce_parts(b: int, c: int, h: int, w: int, H: int, W: int,
                    valid: int, logit_bytes: int) -> Dict[str, Parts]:
    """(bytes, operations) of the forward and the backward of one upsample
    + CE call: logits ``(b, c, h, w)`` of ``logit_bytes`` each, int32
    labels ``(b, H, W)`` of which ``valid`` are not ignored, ``(b,)``
    float32 sums out (the backward reads the cotangent and writes the
    logits' gradient)."""
    lo_bytes, lab_bytes = b * c * h * w * logit_bytes, b * H * W * 4
    interp = CE_LERP_OPS * (1 + h / H)
    fwd_ops = interp + CE_LSE_OPS
    bwd_ops = fwd_ops + CE_SOFTMAX_GRAD_OPS + interp
    return {"fwd": (lo_bytes + lab_bytes + b * 4,
                    valid * (c * fwd_ops + CE_PIXEL_OPS)),
            "bwd": (2 * lo_bytes + lab_bytes + b * 4,
                    valid * (c * bwd_ops + CE_PIXEL_OPS))}


def pgd_parts(numel: int, elem_bytes: int, clip: bool) -> Parts:
    """(bytes, operations) of one PGD update of ``numel`` elements: x, g
    (and the centre, with the clip) read once, the result written once."""
    return ((3 + clip) * elem_bytes * numel,
            (PGD_CLIP_OPS if clip else PGD_OPS) * numel)


def nms_parts(groups: int, n: int, iou_tests: int) -> Parts:
    """(bytes, operations) of one greedy NMS call over ``groups`` groups of
    ``n`` sorted boxes: the boxes (16 bytes) and valid flags read once, the
    keep mask written once; ``iou_tests`` from :func:`nms_iou_tests`."""
    return groups * n * (16 + 1 + 1), iou_tests * OPS_PER_IOU


def nms_iou_tests(keep, valid) -> int:
    """The IoU tests these boxes need, from the ``(groups, n)`` bool keep
    mask and valid flags: a kept box against every earlier kept box of its
    group, a suppressed valid box at least once."""
    kept_before = torch.cumsum(keep.to(torch.int64), dim=1) - 1
    return int((kept_before * keep).sum()) + int((valid & ~keep).sum())
