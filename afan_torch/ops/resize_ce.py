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
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from ..models.deeplab.heads import resize_bilinear
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


def fused_resize_nll_sums_plain(lo: torch.Tensor, labels: torch.Tensor,
                                out_size: Sequence[int], focal: Focal = None
                                ) -> torch.Tensor:
    """The plain version: upsample, then the per-entry masked sums."""
    hi = resize_bilinear(lo.float(), tuple(out_size))
    if focal is None:
        return per_entry_loss_sums(hi, labels, False)
    return per_entry_loss_sums(hi, labels, True, *focal)


def resize_ce_grad_plain(lo: torch.Tensor, labels: torch.Tensor,
                         gout: torch.Tensor, focal: Focal = None
                         ) -> torch.Tensor:
    """The plain version of the backward: ``d(sum_b gout[b] * sums[b]) /
    d lo`` by autograd through :func:`fused_resize_nll_sums_plain`."""
    with torch.enable_grad():
        x = lo.detach().requires_grad_(True)
        sums = fused_resize_nll_sums_plain(x, labels, labels.shape[1:], focal)
        (grad,) = torch.autograd.grad(sums, x, gout)
    return grad


class _FusedResizeNLL(torch.autograd.Function):

    @staticmethod
    def forward(ctx, lo, labels, focal):
        ctx.focal = focal
        ctx.save_for_backward(lo, labels)
        return kernels.resize_ce_forward(lo, labels, focal)

    @staticmethod
    def backward(ctx, gout):
        lo, labels = ctx.saved_tensors
        dlo = kernels.resize_ce_backward(
            lo, labels, gout.float().contiguous(), ctx.focal)
        return dlo, None, None


def fused_resize_nll_sums(lo: torch.Tensor, labels: torch.Tensor,
                          out_size: Sequence[int], focal: Focal = None
                          ) -> torch.Tensor:
    """Per-batch-entry sums ``(B,)`` of the 255-masked NLL (``focal=None``)
    or focal loss (``focal=(alpha, gamma)``) of ``resize_bilinear(lo,
    out_size)`` against ``labels``; differentiable w.r.t. ``lo``. On a CUDA
    tensor it launches the kernels or raises."""
    if tuple(labels.shape[1:]) != tuple(out_size):
        raise ValueError(f"labels {tuple(labels.shape)} do not match "
                         f"out_size {tuple(out_size)}")
    if lo.device.type == "cpu":
        return fused_resize_nll_sums_plain(lo, labels, out_size, focal)
    return _FusedResizeNLL.apply(lo.contiguous(),
                                 labels.to(torch.int32).contiguous(), focal)
