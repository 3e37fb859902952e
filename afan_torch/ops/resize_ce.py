"""Fused bilinear upsample + masked cross-entropy — the PyTorch counterpart of
``afan/ops/kernels/resize_ce_kernel.py:fused_resize_nll_sums``.

Every loss site and every ascent site of the segmentation step ends with
``resize_bilinear(logits, (H, W))`` followed by the 255-masked CE (or focal)
loss. :func:`fused_resize_nll_sums` returns the per-entry loss sums without
building the ``(B, C, H, W)`` upsampled logits or their cotangent: on a CUDA
tensor it is a :class:`torch.autograd.Function` over the hand-written
forward and backward kernels (:mod:`afan_torch.ops.kernels.resize_ce`); on a
CPU tensor it is :func:`fused_resize_nll_sums_plain`, the upsample and the
loss written out in PyTorch and differentiated by autograd.

Layout: logits ``(B, C, h, w)`` (the port's NCHW; ``afan`` takes
``(B, h, w, C)``), labels ``(B, H, W)`` integer with 255 ignored. The
logits may be float32 or bfloat16 (the models' compute dtype under
``--bf16``); both paths compute in float32 and return float32 sums, and the
gradient has the logits' dtype, as ``afan``'s (``resize_ce_kernel.py:
232,256-258``).

A row-sharded step passes a row ``window = (hg, Hg, y0, Y0)``: the logits
are the rows [y0, y0 + h) of a map of ``hg`` rows (the rows this rank's
labels read, fetched by :func:`afan_torch.parallel.spatial.window_rows`),
and the labels the rows [Y0, Y0 + H) of the upsample to ``Hg`` rows. Both
paths then compute the rows of the global upsample and their masked sums.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from ..models.deeplab.heads import resize_bilinear, resize_rows
from .kernels import resize_ce as kernels

IGNORE = 255

Focal = Optional[Tuple[float, float]]


def per_entry_loss_sums(logits: torch.Tensor, labels: torch.Tensor,
                        use_focal: bool, alpha: float = 1.0,
                        gamma: float = 2.0, ignore_index: int = IGNORE
                        ) -> torch.Tensor:
    """Per-batch-entry sums of the masked per-pixel loss
    (``afan/train/segment_loop.py:_per_entry_loss_sums``) of logits
    ``(B, C, H, W)`` against labels ``(B, H, W)`` → ``(B,)``."""
    mask = labels != ignore_index
    safe = torch.where(mask, labels, torch.zeros_like(labels)).long()
    logp = F.log_softmax(logits, dim=1)
    ce = -logp.gather(1, safe[:, None]).squeeze(1)
    val = alpha * (1 - torch.exp(-ce)) ** gamma * ce if use_focal else ce
    return torch.where(mask, val, torch.zeros_like(val)).sum(
        dim=tuple(range(1, val.dim())))


Window = Optional[Tuple[int, int, int, int]]


def resize_window_rows(lo: torch.Tensor, out_size: Sequence[int],
                       window: Window) -> torch.Tensor:
    """The float32 upsample of ``lo`` to the labels' ``out_size``: the whole
    map, or the rows of a ``window``."""
    if window is None:
        return resize_bilinear(lo.float(), tuple(out_size))
    hg, Hg, y0, Y0 = window
    return resize_rows(lo.float(), hg, (Hg, out_size[1]), y0,
                       slice(Y0, Y0 + out_size[0]))


def fused_resize_nll_sums_plain(lo: torch.Tensor, labels: torch.Tensor,
                                out_size: Sequence[int], focal: Focal = None,
                                window: Window = None) -> torch.Tensor:
    """The plain version: upsample (the window's rows of the global
    upsample), then the per-entry masked sums."""
    hi = resize_window_rows(lo, out_size, window)
    if focal is None:
        return per_entry_loss_sums(hi, labels, False)
    return per_entry_loss_sums(hi, labels, True, *focal)


def resize_ce_grad_plain(lo: torch.Tensor, labels: torch.Tensor,
                         gout: torch.Tensor, focal: Focal = None,
                         window: Window = None) -> torch.Tensor:
    """The plain version of the backward: ``d(sum_b gout[b] * sums[b]) /
    d lo`` by autograd through :func:`fused_resize_nll_sums_plain`."""
    with torch.enable_grad():
        x = lo.detach().requires_grad_(True)
        sums = fused_resize_nll_sums_plain(x, labels, labels.shape[1:], focal,
                                           window)
        (grad,) = torch.autograd.grad(sums, x, gout)
    return grad


class _FusedResizeNLL(torch.autograd.Function):

    @staticmethod
    def forward(ctx, lo, labels, focal, window):
        ctx.focal, ctx.window = focal, window
        ctx.save_for_backward(lo, labels)
        return kernels.resize_ce_forward(lo, labels, focal, window)

    @staticmethod
    def backward(ctx, gout):
        lo, labels = ctx.saved_tensors
        dlo = kernels.resize_ce_backward(
            lo, labels, gout.float().contiguous(), ctx.focal, ctx.window)
        return dlo, None, None, None


def fused_resize_nll_sums(lo: torch.Tensor, labels: torch.Tensor,
                          out_size: Sequence[int], focal: Focal = None,
                          window: Window = None) -> torch.Tensor:
    """Per-batch-entry sums ``(B,)`` of the 255-masked NLL (``focal=None``)
    or focal loss (``focal=(alpha, gamma)``) of ``resize_bilinear(lo,
    out_size)`` against ``labels`` (or of the rows of a row ``window``);
    differentiable w.r.t. ``lo``. On a CUDA tensor it launches the kernels
    or raises."""
    if tuple(labels.shape[1:]) != tuple(out_size):
        raise ValueError(f"labels {tuple(labels.shape)} do not match "
                         f"out_size {tuple(out_size)}")
    if lo.device.type == "cpu":
        return fused_resize_nll_sums_plain(lo, labels, out_size, focal,
                                           window)
    return _FusedResizeNLL.apply(lo.contiguous(),
                                 labels.to(torch.int32).contiguous(), focal,
                                 None if window is None else tuple(window))
