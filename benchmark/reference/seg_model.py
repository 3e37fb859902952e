"""Plain reference of DeepLabv3+ ResNet-50 (output stride 16) as the
A-FAN segmentation recipe trains it: a frozen copy of the port's model
written in plain PyTorch, with nothing of the port imported.

Layout NCHW; images in [0, 1] with the ImageNet normalisation at the input.
Module names are torchvision's and the reference's (`_deeplab.py`), so one
state dict loads into this model and into the port's. Compute dtype: the
parameters stay float32; every convolution casts its input and weight to
``compute_dtype`` (bfloat16 in the recipe) and adds its bias after the
convolution; the trainable BatchNorm takes the batch statistics in float32
and returns the input's dtype; the decoder's bilinear resizes of a bfloat16
map contract with ``jax.image.resize``'s weight matrices, one axis at a
time, each rounded to bfloat16 (the JAX original's arithmetic).

``fp8`` on a convolution rounds its input and weight to float8 e4m3 with a
per-tensor scale (amax to 448) before it computes: the control that stands
for the precision below bfloat16.
"""
from __future__ import annotations

import contextlib
import functools
from typing import Dict, Iterator, List, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
FP8_MAX = 448.0


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` through float8 e4m3 at a per-tensor scale, back in its dtype."""
    scale = FP8_MAX / x.detach().abs().amax().float().clamp_min(1e-12)
    q = (x.float() * scale).to(torch.float8_e4m3fn).float() / scale
    return x + (q.to(x.dtype) - x).detach()


class Conv2d(nn.Conv2d):
    compute_dtype = torch.float32
    fp8 = False

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        xin, w = x.to(dt), self.weight.to(dt)
        if self.fp8:
            xin, w = fp8_round(xin), fp8_round(w)
        if dt == torch.float32:
            return self._conv_forward(xin, w, self.bias)
        y = self._conv_forward(xin, w, None)
        return y if self.bias is None else y + self.bias.to(dt).reshape(
            1, -1, 1, 1)


class BatchNorm(nn.BatchNorm2d):
    """Train mode: batch statistics; the running statistics an EMA (weight
    0.01) of the batch mean and the biased variance, skipped while
    ``update_stats`` is off."""

    def __init__(self, num_features: int):
        super().__init__(num_features, eps=1e-5, momentum=0.01)
        self.update_stats = True

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0, self.eps)
        if not self.update_stats:
            return F.batch_norm(x, None, None, self.weight, self.bias, True,
                                0.0, self.eps)
        mean = torch.zeros_like(self.running_mean)
        var = torch.zeros_like(self.running_var)
        y = F.batch_norm(x, mean, var, self.weight, self.bias, True, 1.0,
                         self.eps)
        n = x.numel() // x.shape[1]
        with torch.no_grad():
            self.running_mean.lerp_(mean, self.momentum)
            self.running_var.lerp_(var * ((n - 1) / n), self.momentum)
        return y


@contextlib.contextmanager
def frozen_bn_stats(module: nn.Module) -> Iterator[None]:
    bns = [m for m in module.modules() if isinstance(m, BatchNorm)]
    for m in bns:
        m.update_stats = False
    try:
        yield
    finally:
        for m in bns:
            m.update_stats = True


def _conv(cin: int, cout: int, k: int, stride: int = 1,
          dilation: int = 1) -> Conv2d:
    return Conv2d(cin, cout, k, stride=stride, padding=(k // 2) * dilation,
                  dilation=dilation, bias=False)


class Bottleneck(nn.Module):
    def __init__(self, cin: int, planes: int, stride: int, dilation: int):
        super().__init__()
        out = planes * 4
        self.conv1 = _conv(cin, planes, 1)
        self.bn1 = BatchNorm(planes)
        self.conv2 = _conv(planes, planes, 3, stride, dilation)
        self.bn2 = BatchNorm(planes)
        self.conv3 = _conv(planes, out, 1)
        self.bn3 = BatchNorm(out)
        self.downsample = (nn.Sequential(_conv(cin, out, 1, stride),
                                         BatchNorm(out))
                           if stride != 1 or cin != out else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(y + identity)


class ResNet50(nn.Module):
    """Stem + layer1..4 at output stride 16 (layer4 dilated by 2, its first
    block at dilation 1); taps 1..4 exit after layer1..4."""

    def __init__(self):
        super().__init__()
        self.conv1 = Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = BatchNorm(64)
        cin, prev = 64, 1
        for i, (planes, n, dil) in enumerate(zip(
                (64, 128, 256, 512), (3, 4, 6, 3), (1, 1, 1, 2))):
            stride = 1 if (i == 0 or dil > prev) else 2
            blocks = []
            for j in range(n):
                blocks.append(Bottleneck(cin, planes, stride if j == 0 else 1,
                                         prev if j == 0 else dil))
                cin = planes * 4
            setattr(self, f"layer{i + 1}", nn.Sequential(*blocks))
            prev = dil
        self.register_buffer("mean", torch.tensor(IMAGENET_MEAN).reshape(
            1, 3, 1, 1), persistent=False)
        self.register_buffer("std", torch.tensor(IMAGENET_STD).reshape(
            1, 3, 1, 1), persistent=False)

    def stages(self):
        return (self.layer1, self.layer2, self.layer3, self.layer4)

    def run(self, x: torch.Tensor, start: int, end: int) -> torch.Tensor:
        if start == 0:
            x = (x - self.mean) / self.std
            x = F.relu(self.bn1(self.conv1(x)))
            x = F.max_pool2d(x, 3, stride=2, padding=1)
        for i in range(start, end):
            x = self.stages()[i](x)
        return x

    def head(self, x: torch.Tensor, tap: int
             ) -> Tuple[torch.Tensor, torch.Tensor]:
        low_level = self.run(x, 0, 1)
        return self.run(low_level, 1, tap), low_level


@functools.lru_cache(maxsize=16)
def _resize_weights(n_in: int, n_out: int) -> np.ndarray:
    """``jax.image.resize``'s bilinear weights ``(n_in, n_out)`` in float32
    (upsampling: the triangle kernel, half-pixel centres)."""
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


def resize_bilinear(x: torch.Tensor, size) -> torch.Tensor:
    """Bilinear resize, ``align_corners=False``: ``F.interpolate`` outside
    bfloat16; in bfloat16 the two contractions, the cheaper axis first (H
    on a tie), each rounded."""
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
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dtype != torch.bfloat16:
            return F.adaptive_avg_pool2d(x, 1)
        return x.float().mean(dim=(2, 3), keepdim=True).to(x.dtype)


class ConvBNReLU(nn.Sequential):
    def __init__(self, cin: int, cout: int, k: int, dilation: int = 1):
        super().__init__(Conv2d(cin, cout, k, padding=(k // 2) * dilation,
                                dilation=dilation, bias=False),
                         BatchNorm(cout), nn.ReLU())


class ASPPPooling(nn.Sequential):
    def __init__(self, cin: int, cout: int):
        super().__init__(GlobalMean(), Conv2d(cin, cout, 1, bias=False),
                         BatchNorm(cout), nn.ReLU())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x).expand(-1, -1, x.shape[2], x.shape[3])


class ASPP(nn.Module):
    def __init__(self, cin: int, rates, cout: int = 256):
        super().__init__()
        self.convs = nn.ModuleList(
            [ConvBNReLU(cin, cout, 1)]
            + [ConvBNReLU(cin, cout, 3, r) for r in rates]
            + [ASPPPooling(cin, cout)])
        self.project = nn.Sequential(
            Conv2d(5 * cout, cout, 1, bias=False), BatchNorm(cout),
            nn.ReLU(), nn.Dropout(0.1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.project(torch.cat([m(x) for m in self.convs], dim=1))


class HeadV3Plus(nn.Module):
    def __init__(self, num_classes: int, rates=(6, 12, 18)):
        super().__init__()
        self.project = ConvBNReLU(256, 48, 1)
        self.aspp = ASPP(2048, rates)
        self.classifier = nn.Sequential(*ConvBNReLU(304, 256, 3),
                                        Conv2d(256, num_classes, 1))

    def concat_head(self, out: torch.Tensor, low_level: torch.Tensor
                    ) -> torch.Tensor:
        low = self.project(low_level)
        up = resize_bilinear(self.aspp(out), low.shape[2:])
        return torch.cat([low, up], dim=1)

    def forward(self, out: torch.Tensor, low_level: torch.Tensor
                ) -> torch.Tensor:
        return self.classifier(self.concat_head(out, low_level))


class DeepLabV3Plus(nn.Module):
    """backbone + classifier with the SE (backbone tap) and SD ('concat'
    decoder feature) entry points of the A-FAN step."""

    def __init__(self, num_classes: int = 19):
        super().__init__()
        self.backbone = ResNet50()
        self.classifier = HeadV3Plus(num_classes)

    def set_precision(self, dtype: torch.dtype, fp8: bool = False) -> None:
        for m in self.modules():
            if isinstance(m, Conv2d):
                m.compute_dtype, m.fp8 = dtype, fp8

    def backbone_head(self, x, tap):
        return self.backbone.head(x, tap)

    def forward_tail_logits(self, feat, low_level, tap):
        return self.classifier(self.backbone.run(feat, tap, 4), low_level)

    def forward_logits(self, x):
        out, low_level = self.backbone.head(x, 4)
        return self.classifier(out, low_level)

    def attack_features(self, x, tap):
        """(SE tap feature, low_level, 'concat' SD feature)."""
        feat, low_level = self.backbone.head(x, tap)
        out = self.backbone.run(feat, tap, 4)
        return feat, low_level, self.classifier.concat_head(out, low_level)

    def sd_tail_logits(self, adv):
        return self.classifier.classifier(adv)

    def param_groups(self) -> List[Dict]:
        """The backbone at a tenth of the lr, the head at the lr."""
        return [{"params": list(self.backbone.parameters()),
                 "lr_scale": 0.1},
                {"params": list(self.classifier.parameters()),
                 "lr_scale": 1.0}]
