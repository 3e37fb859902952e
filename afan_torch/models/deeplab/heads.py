"""DeepLabV3/V3+ heads with aspp/concat tap points — the PyTorch counterpart
of ``afan/models/deeplab/heads.py``.

Module names are the reference's (`Segmentation/network/_deeplab.py`), so
its checkpoints load with ``load_state_dict`` and
``afan/interop/torch_zoo.py:convert_torch_deeplab`` reads the port's
``state_dict``: ASPP ``convs.0`` (1x1), ``convs.1-3`` (atrous 3x3),
``convs.4`` (image pooling: ``.1`` conv, ``.2`` bn), ``project`` (conv, bn,
relu, dropout 0.1); the V3+ head's ``project`` (48-channel low-level
projection), ``aspp`` and ``classifier`` (3x3 conv-bn-relu, 1x1 logits with
a bias); the V3 head's ``classifier`` = (ASPP, 3x3 conv, bn, relu, 1x1).
With ``separable`` (``--separable_conv``) every convolution with a kernel
above 1 (the ASPP's three atrous branches and the classifier's 3x3) is an
:class:`AtrousSeparableConv`, as ``afan`` builds it for both heads: the
reference's ``AtrousSeparableConvolution`` under its name ``body``, with
``afan``'s choices (no bias, Flax's fan-in init).
Layout is NCHW; every BatchNorm is the trainable
:class:`afan_torch.models.resnet.BatchNorm` and every convolution a
:class:`afan_torch.models.resnet.Conv2d`, so the heads follow the model's
compute dtype. Under bfloat16 they keep ``afan``'s dtype at each step: the
image-pooling mean reduces in float32 and returns bfloat16 (``jnp.mean``),
the resizes are ``jax.image.resize``'s bfloat16 contractions
(:func:`resize_bilinear`), and the concatenations join bfloat16 tensors.
"""
from __future__ import annotations

import functools
from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..resnet import BatchNorm, Conv2d


@functools.lru_cache(maxsize=64)
def _resize_weights(n_in: int, n_out: int) -> np.ndarray:
    """``jax.image.resize``'s bilinear weight matrix ``(n_in, n_out)``
    (``compute_weight_mat`` with antialiasing, the triangle kernel widened
    when it shrinks), in its float32 arithmetic."""
    f32 = np.float32
    inv_scale = 1.0 / (n_out / n_in)
    kernel_scale = f32(max(inv_scale, 1.0))
    sample = (np.arange(n_out, dtype=f32) + f32(0.5)) * f32(inv_scale) \
        - f32(0.5)
    x = np.abs(sample[None, :] - np.arange(n_in, dtype=f32)[:, None]) \
        / kernel_scale
    weights = np.maximum(f32(0.0), f32(1.0) - x)
    total = weights.sum(axis=0, keepdims=True, dtype=f32)
    weights = np.where(np.abs(total) > f32(1000.0 * np.finfo(f32).eps),
                       weights / np.where(total != 0, total, f32(1.0)),
                       f32(0.0))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[None, :], weights, f32(0.0)).astype(f32)


def resize_bilinear(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """Bilinear resize (half-pixel centres, ``align_corners=False``) of
    NCHW ``x`` to ``size``, as ``afan``'s ``jax.image.resize`` computes it
    in ``x``'s dtype. float32 (and float64): ``F.interpolate``, the same map
    when it upsamples (JAX antialiases only when it shrinks). bfloat16: JAX
    casts its float32 weight matrices to bfloat16 and contracts one axis,
    then the other, rounding each contraction to bfloat16, in the order of
    fewer multiplications (H first on a tie, as for every square resize of
    the models); so does this, bit for bit."""
    if x.dtype != torch.bfloat16:
        return F.interpolate(x, size=tuple(size), mode="bilinear",
                             align_corners=False)
    (h, w), (H, W) = x.shape[2:], size
    axes = [a for a, n_in, n_out in (("h", h, H), ("w", w, W))
            if n_in != n_out]
    if h * w * H + H * w * W > h * w * W + h * W * H:
        axes.reverse()
    for axis in axes:
        if axis == "h":
            wh = torch.from_numpy(_resize_weights(h, H)).to(x.device, x.dtype)
            x = torch.einsum("bchw,hH->bcHw", x, wh)
        else:
            ww = torch.from_numpy(_resize_weights(w, W)).to(x.device, x.dtype)
            x = torch.einsum("bchw,wW->bchW", x, ww)
    return x.contiguous()


class GlobalMean(nn.Module):
    """The image pooling's global mean (``nn.AdaptiveAvgPool2d(1)``),
    reduced in float32 and returned in the input's dtype, as ``jnp.mean``
    does on bfloat16."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dtype != torch.bfloat16:
            return F.adaptive_avg_pool2d(x, 1)
        return x.float().mean(dim=(2, 3), keepdim=True).to(x.dtype)


class AtrousSeparableConv(nn.Module):
    """Depthwise (dilated) then pointwise convolution, both without a bias
    (``afan/models/deeplab/heads.py:AtrousSeparableConv``), as ``body.0``
    and ``body.1`` (`_deeplab.py:115-139`)."""

    def __init__(self, cin: int, cout: int, k: int, dilation: int = 1):
        super().__init__()
        self.body = nn.Sequential(
            Conv2d(cin, cin, k, padding=(k // 2) * dilation,
                   dilation=dilation, groups=cin, bias=False),
            Conv2d(cin, cout, 1, bias=False))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.body(x)


def _conv(cin: int, cout: int, k: int, dilation: int = 1,
          separable: bool = False) -> nn.Module:
    """A bias-free k x k convolution; separable when asked and k > 1."""
    if separable and k > 1:
        return AtrousSeparableConv(cin, cout, k, dilation)
    return Conv2d(cin, cout, k, padding=(k // 2) * dilation,
                  dilation=dilation, bias=False)


class ConvBNReLU(nn.Sequential):
    """conv (no bias) → BatchNorm → ReLU, as ``(0, 1, 2)``."""

    def __init__(self, cin: int, cout: int, k: int, dilation: int = 1,
                 separable: bool = False):
        super().__init__(_conv(cin, cout, k, dilation, separable),
                         BatchNorm(cout), nn.ReLU())


class ASPPPooling(nn.Sequential):
    """Image pooling: global mean → 1x1 conv-bn-relu → broadcast back."""

    def __init__(self, cin: int, cout: int):
        super().__init__(GlobalMean(), Conv2d(cin, cout, 1, bias=False),
                         BatchNorm(cout), nn.ReLU())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x).expand(-1, -1, x.shape[2], x.shape[3])


class ASPP(nn.Module):
    """Atrous spatial pyramid pooling (`_deeplab.py:163-192`)."""

    def __init__(self, cin: int, rates: Sequence[int], cout: int = 256,
                 separable: bool = False):
        super().__init__()
        self.convs = nn.ModuleList(
            [ConvBNReLU(cin, cout, 1)]
            + [ConvBNReLU(cin, cout, 3, r, separable) for r in rates]
            + [ASPPPooling(cin, cout)])
        self.project = nn.Sequential(
            Conv2d(5 * cout, cout, 1, bias=False), BatchNorm(cout),
            nn.ReLU(), nn.Dropout(0.1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.project(torch.cat([m(x) for m in self.convs], dim=1))


def _classifier3x3(cin: int, num_classes: int, separable: bool = False
                   ) -> nn.Sequential:
    """3x3 conv-bn-relu + 1x1 logits (`_deeplab.py:39-44`)."""
    return nn.Sequential(*ConvBNReLU(cin, 256, 3, 1, separable),
                         Conv2d(256, num_classes, 1))


class DeepLabHeadV3Plus(nn.Module):
    """The V3+ decoder with its two SD tap points (`_deeplab.py:28-80`)."""

    def __init__(self, in_channels: int, low_level_channels: int,
                 num_classes: int, aspp_dilate: Sequence[int] = (12, 24, 36),
                 separable: bool = False):
        super().__init__()
        self.project = ConvBNReLU(low_level_channels, 48, 1)
        self.aspp = ASPP(in_channels, aspp_dilate, separable=separable)
        self.classifier = _classifier3x3(304, num_classes, separable)

    def _concat(self, low_level: torch.Tensor, aspp_out: torch.Tensor
                ) -> torch.Tensor:
        low = self.project(low_level)
        up = resize_bilinear(aspp_out, low.shape[2:])
        return torch.cat([low, up], dim=1)          # 48 + 256 = 304

    def forward(self, out: torch.Tensor, low_level: torch.Tensor
                ) -> torch.Tensor:
        return self.classifier(self._concat(low_level, self.aspp(out)))

    def aspp_head(self, out: torch.Tensor) -> torch.Tensor:
        """The 'aspp' SD tap feature."""
        return self.aspp(out)

    def aspp_tail(self, adv_aspp: torch.Tensor, low_level: torch.Tensor
                  ) -> torch.Tensor:
        """Classify from an adversarial aspp feature."""
        return self.classifier(self._concat(low_level, adv_aspp))

    def concat_head(self, out: torch.Tensor, low_level: torch.Tensor
                    ) -> torch.Tensor:
        """The 'concat' SD tap feature (304 channels)."""
        return self._concat(low_level, self.aspp(out))

    def concat_tail(self, adv_concat: torch.Tensor) -> torch.Tensor:
        return self.classifier(adv_concat)


class DeepLabHead(nn.Module):
    """Plain V3 head: ASPP + classifier, no low-level branch
    (`_deeplab.py:93-114`). Tap points: 'aspp' only."""

    def __init__(self, in_channels: int, num_classes: int,
                 aspp_dilate: Sequence[int] = (12, 24, 36),
                 separable: bool = False):
        super().__init__()
        self.classifier = nn.Sequential(
            ASPP(in_channels, aspp_dilate, separable=separable),
            *_classifier3x3(256, num_classes, separable))

    def forward(self, out: torch.Tensor, low_level: torch.Tensor = None
                ) -> torch.Tensor:
        return self.classifier(out)

    def aspp_head(self, out: torch.Tensor) -> torch.Tensor:
        return self.classifier[0](out)

    def aspp_tail(self, adv_aspp: torch.Tensor,
                  low_level: torch.Tensor = None) -> torch.Tensor:
        return self.classifier[1:](adv_aspp)
