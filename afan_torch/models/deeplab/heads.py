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

Inside a row-sharded step (:mod:`afan_torch.parallel.spatial`) the image
pooling's mean is the global sum over the data row's ranks over the
global pixel count, the decoder's upsample takes its output rows from the
window of input rows they read (:func:`resize_rows`), and the ASPP's
dropout draws its mask at the data row's whole map and keeps its rows.
"""
from __future__ import annotations

import functools
from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ...parallel import spatial
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


def resize_bilinear(x: torch.Tensor, size: Tuple[int, int],
                    key=None) -> torch.Tensor:
    """Bilinear resize (half-pixel centres, ``align_corners=False``) of
    NCHW ``x`` to ``size``, as ``afan``'s ``jax.image.resize`` computes it
    in ``x``'s dtype. float32 (and float64): ``F.interpolate``, the same map
    when it upsamples (JAX antialiases only when it shrinks). bfloat16: JAX
    casts its float32 weight matrices to bfloat16 and contracts one axis,
    then the other, rounding each contraction to bfloat16, in the order of
    fewer multiplications (H first on a tie, as for every square resize of
    the models); so does this, bit for bit.

    Inside a row-sharded step, with a ``key`` (the calling module), ``x``
    and the output are row-sharded and ``size`` is the output's local
    size: this rank's output rows come from the input rows they read
    (:func:`resize_rows`)."""
    sh = spatial.active()
    if sh is not None and key is not None:
        return _resize_sharded(sh, x, size, key)
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


def source_taps(n_out: int, n_in: int) -> Tuple[np.ndarray, ...]:
    """torch's ``align_corners=False`` linear taps of every output index:
    lower and upper source index and their weights. The source index
    ``scale * (dst + 0.5) - 0.5`` is one float32 rounding of the exact
    value (an ``fmaf``), clamped at 0; the upper index is clamped at the
    last row."""
    scale = np.float32(n_in) / np.float32(n_out)
    src = (np.float64(scale) * (np.arange(n_out) + 0.5) - 0.5)
    src = np.maximum(src.astype(np.float32), np.float32(0.0))
    i0 = np.minimum(src.astype(np.int64), n_in - 1)
    i1 = np.minimum(i0 + 1, n_in - 1)
    l1 = src - i0.astype(np.float32)
    return i0, i1, np.float32(1.0) - l1, l1


def resize_window(n_in: int, n_out: int, rows: slice) -> Tuple[int, int]:
    """The input rows [lo, hi) that the output rows ``rows`` of a bilinear
    resize from ``n_in`` to ``n_out`` read: torch's taps, clamped only at
    the global edges, and every row that ``jax.image.resize``'s weights of
    those rows touch; (0, 0) for no output rows."""
    if rows.start == rows.stop:
        return 0, 0
    i0, i1, _, _ = source_taps(n_out, n_in)
    touched = np.nonzero(_resize_weights(n_in, n_out)[:, rows].any(axis=1))[0]
    lo, hi = int(i0[rows.start]), int(i1[rows.stop - 1]) + 1
    if touched.size:
        lo, hi = min(lo, int(touched[0])), max(hi, int(touched[-1]) + 1)
    return lo, hi


def resize_rows(x: torch.Tensor, n_in: int, size: Tuple[int, int],
                y0: int, rows: slice) -> torch.Tensor:
    """The rows ``rows`` of the bilinear resize to ``size`` (global) of a
    map of global height ``n_in``, of which ``x`` holds the rows [y0, y0 +
    x.shape[2]) (:func:`resize_window`'s). float32: torch's taps of the
    global map, each output row ``l0 * t[i0] + l1 * t[i1]`` of the rows
    ``t`` interpolated along W, as ``F.interpolate`` forms a pixel.
    bfloat16: the rows and columns of :func:`resize_bilinear`'s global
    weight matrices, contracted in its order and rounded as it rounds."""
    (H, W), w = size, x.shape[3]
    if x.dtype == torch.bfloat16:
        axes = [a for a, n_i, n_o in (("h", n_in, H), ("w", w, W))
                if n_i != n_o]
        if n_in * w * H + H * w * W > n_in * w * W + n_in * W * H:
            axes.reverse()
        for axis in axes:
            if axis == "h":
                wh = _resize_weights(n_in, H)[y0:y0 + x.shape[2], rows]
                x = torch.einsum("bchw,hH->bcHw", x, torch.from_numpy(
                    np.ascontiguousarray(wh)).to(x.device, x.dtype))
            else:
                ww = torch.from_numpy(_resize_weights(w, W)).to(x.device,
                                                                x.dtype)
                x = torch.einsum("bchw,wW->bchW", x, ww)
        if "h" not in axes:
            x = x[:, :, rows.start - y0:rows.stop - y0]
        return x.contiguous()
    t = x if w == W else F.interpolate(x, size=(x.shape[2], W),
                                       mode="bilinear", align_corners=False)
    i0, i1, l0, l1 = (a[rows] for a in source_taps(H, n_in))
    dev = x.device
    l0 = torch.from_numpy(l0).to(dev, x.dtype).reshape(1, 1, -1, 1)
    l1 = torch.from_numpy(l1).to(dev, x.dtype).reshape(1, 1, -1, 1)
    return (t[:, :, torch.from_numpy(i0 - y0).to(dev)] * l0
            + t[:, :, torch.from_numpy(i1 - y0).to(dev)] * l1)


def _resize_sharded(sh, x: torch.Tensor, size: Tuple[int, int],
                    key) -> torch.Tensor:
    n_in = sh.global_height((key, "in"), x.shape[2])
    H = sh.global_height((key, "out"), size[0])
    windows = [resize_window(n_in, H, sh.rows(H, r)) for r in range(sh.size)]
    win = spatial.window_rows(x, n_in, windows, 0.0)
    rows = sh.rows(H)
    if rows.start == rows.stop:
        return spatial.no_rows((x.shape[0], x.shape[1], 0, size[1]),
                                  x.dtype, win)
    return resize_rows(win, n_in, (H, size[1]), windows[sh.index][0], rows)


class GlobalMean(nn.Module):
    """The image pooling's global mean (``nn.AdaptiveAvgPool2d(1)``),
    reduced in float32 and returned in the input's dtype, as ``jnp.mean``
    does on bfloat16."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        sh = spatial.active()
        if sh is not None:
            # the global sum and pixel count, not a mean of uneven shares
            n = sh.global_height(self, x.shape[2]) * x.shape[3]
            wide = x if x.dtype == torch.float64 else x.float()
            total = spatial.spatial_sum(wide.sum(dim=(2, 3), keepdim=True))
            return (total / n).to(x.dtype)
        if x.dtype != torch.bfloat16:
            return F.adaptive_avg_pool2d(x, 1)
        return x.float().mean(dim=(2, 3), keepdim=True).to(x.dtype)


class Dropout(nn.Dropout):
    """``nn.Dropout``; inside a row-sharded step the mask is drawn at the
    data row's whole map and this rank's rows are kept, so that the ranks
    of a data row draw one mask and their generators stay in step."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if spatial.active() is None or not self.training or self.p == 0:
            return super().forward(x)
        keep = spatial.draw_rows(lambda shape: torch.empty(
            shape, dtype=x.dtype, device=x.device).bernoulli_(1 - self.p),
            x.shape, 2)
        return x * keep / (1 - self.p)


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
            nn.ReLU(), Dropout(0.1))

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
        up = resize_bilinear(aspp_out, low.shape[2:], key=self)
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
