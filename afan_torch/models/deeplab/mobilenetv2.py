"""MobileNetV2 backbone for DeepLab — the PyTorch counterpart of
``afan/models/deeplab/mobilenetv2.py`` (inverted residual blocks, dilated
past the output stride; ``low_level`` after the 24-channel stage).

It has :class:`afan_torch.models.resnet.ResNetTorso`'s ``head(x, tap)`` /
``tail(feature, tap)`` API, taps 1..4 at the four stride-stage boundaries
(:data:`TAP_TO_STAGE`), so the SE attacks run on it unchanged. Module names
are ``afan``'s (``stem``, ``stem_bn``, ``b{stage}_{block}.{expand,
depthwise, project}{,_bn}``), so ``afan``'s parameters carry across by
name. Layout is NCHW; the ImageNet normalisation runs inside, in the
image's float32. Every convolution is a :class:`resnet.Conv2d` (the
depthwise one with ``groups`` = its channels) and every BatchNorm a
trainable :class:`resnet.BatchNorm` (momentum 0.01, ``afan``'s Flax EMA
of 0.99), so the backbone follows the model's compute dtype as the ResNet
does. The nonlinearity is ReLU6.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..resnet import (IMAGENET_MEAN, IMAGENET_STD, BatchNorm, Conv2d,
                      lecun_normal_)

# (expansion t, channels c, repeats n, stride s): MobileNetV2, table 2
INVERTED_RESIDUAL_SETTING = (
    (1, 16, 1, 1),
    (6, 24, 2, 2),    # low_level after this stage (24 channels)
    (6, 32, 3, 2),
    (6, 64, 4, 2),
    (6, 96, 3, 1),
    (6, 160, 3, 2),
    (6, 320, 1, 1),
)
# tap i (1..4) = the exit of this stage (0-based into the setting)
TAP_TO_STAGE = {1: 1, 2: 2, 3: 4, 4: 6}
LOW_LEVEL_STAGE = 1


class InvertedResidual(nn.Module):
    """1x1 expand (when ``expand`` > 1) → 3x3 depthwise (stride, dilation,
    symmetric padding = dilation) → 1x1 project, BatchNorm after each and
    ReLU6 after the first two; the input is added back when the stride is
    1 and the channels do not change."""

    def __init__(self, cin: int, cout: int, stride: int, expand: int,
                 dilation: int = 1):
        super().__init__()
        hidden = cin * expand
        self.use_res = stride == 1 and cin == cout
        if expand != 1:
            self.expand = Conv2d(cin, hidden, 1, bias=False)
            self.expand_bn = BatchNorm(hidden)
        self.depthwise = Conv2d(hidden, hidden, 3, stride=stride,
                                padding=dilation, dilation=dilation,
                                groups=hidden, bias=False)
        self.depthwise_bn = BatchNorm(hidden)
        self.project = Conv2d(hidden, cout, 1, bias=False)
        self.project_bn = BatchNorm(cout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x
        if hasattr(self, "expand"):
            y = F.relu6(self.expand_bn(self.expand(y)))
        y = F.relu6(self.depthwise_bn(self.depthwise(y)))
        y = self.project_bn(self.project(y))
        return x + y if self.use_res else y


class MobileNetV2Backbone(nn.Module):
    """Stem + the seven inverted-residual stages. Past ``output_stride`` a
    stage's stride becomes dilation by ``afan``'s rule: the first block of
    that stage keeps the previous dilation, the later blocks take the
    multiplied one."""

    def __init__(self, output_stride: int = 16):
        super().__init__()
        self.stem = Conv2d(3, 32, 3, stride=2, padding=1, bias=False)
        self.stem_bn = BatchNorm(32)
        self.stages = []
        current_stride, dilation, cin = 2, 1, 32
        for k, (t, c, n, s) in enumerate(INVERTED_RESIDUAL_SETTING):
            names = []
            for i in range(n):
                stride = s if i == 0 else 1
                d = dilation
                if stride > 1 and current_stride >= output_stride:
                    dilation *= stride
                    d = dilation // stride if i == 0 else dilation
                    stride = 1
                elif stride > 1:
                    current_stride *= stride
                names.append(f"b{k}_{i}")
                self.add_module(names[-1], InvertedResidual(
                    cin, c, stride, t, max(d, 1)))
                cin = c
            self.stages.append(names)
        self.register_buffer(
            "mean", torch.tensor(IMAGENET_MEAN).reshape(1, 3, 1, 1),
            persistent=False)
        self.register_buffer(
            "std", torch.tensor(IMAGENET_STD).reshape(1, 3, 1, 1),
            persistent=False)

    def _run(self, x: torch.Tensor, start: int, end: int):
        """Stages ``start..end`` (inclusive); also the low-level feature
        when stage 1 runs."""
        low_level = None
        for si in range(start, end + 1):
            for name in self.stages[si]:
                x = getattr(self, name)(x)
            if si == LOW_LEVEL_STAGE:
                low_level = x
        return x, low_level

    def head(self, x: torch.Tensor, tap: int
             ) -> Tuple[torch.Tensor, torch.Tensor]:
        """NCHW image in [0, 1] → (feature at ``tap``, ``low_level``)."""
        x = (x - self.mean) / self.std
        x = F.relu6(self.stem_bn(self.stem(x)))
        return self._run(x, 0, TAP_TO_STAGE[tap])

    def tail(self, feature: torch.Tensor, tap: int, end: int = 4
             ) -> torch.Tensor:
        """Resume from a (possibly adversarial) tap feature."""
        return self._run(feature, TAP_TO_STAGE[tap] + 1,
                         TAP_TO_STAGE[end])[0]

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Flax's default ``nn.Conv`` init (lecun-normal kernels) and
        identity BatchNorm."""
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                lecun_normal_(m.weight, generator)
            elif isinstance(m, nn.BatchNorm2d):
                m.reset_parameters()
