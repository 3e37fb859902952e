"""CIFAR ResNet-s (option-A shortcuts) with static tap points — the PyTorch
counterpart of ``afan/models/resnet_s.py``.

The 34 stages of ResNet-56s keep the reference's ``nn.Sequential`` indices
(`Classification/resnet_s.py:100-112`), so a tap index means the same cut
everywhere (``perturb_idx`` 13; the learnable list
:data:`LEARNABLE_TAPS`):

  0: per-channel input normalization (CIFAR mean/std)
  1: conv3x3(3→16)   2: BN   3: ReLU
  4..12:  9 BasicBlocks @16
  13..21: 9 BasicBlocks @32 (the first has stride 2, option-A shortcut)
  22..30: 9 BasicBlocks @64 (the first has stride 2, option-A shortcut)
  31: global average pool   32: flatten   33: linear(64→classes)

Parameters are named ``sequential_model.<i>.*`` plus the 9-element
learnable η ``w``: the layout of ``afan/interop/torch_ckpt.py:136-169``, so
a reference checkpoint's weights load by key (its normalization constants,
``sequential_model.0.{mean,std}``, are fixed here and not saved). Layout is
NCHW. BatchNorm is :class:`afan_torch.models.resnet.BatchNorm` with flax's
momentum 0.9 as PyTorch's 0.1. Initialisation is ``afan``'s:
kaiming-normal (fan_in, gain² 2, untruncated) conv and linear kernels, zero
linear bias, identity BatchNorm, drawn from an explicit ``torch.Generator``.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from .resnet import BatchNorm
from .taps import StagedModule

CIFAR_MEAN = (0.4914, 0.4822, 0.4465)
CIFAR_STD = (0.2470, 0.2435, 0.2616)
BN_MOMENTUM = 0.1       # flax's momentum 0.9 (`afan/models/resnet_s.py:70`)

# The 9 tap points of the learnable-η trainer (`main_learnable.py:59`).
LEARNABLE_TAPS = (4, 8, 11, 14, 18, 21, 24, 28, 31)


class NormalizeByChannelMeanStd(nn.Module):
    """``(x - mean) / std`` per channel as the model's first stage, so that
    input-space attacks work on [0, 1] pixels."""

    def __init__(self, mean: Sequence[float] = CIFAR_MEAN,
                 std: Sequence[float] = CIFAR_STD):
        super().__init__()
        self.register_buffer("mean", torch.tensor(mean).reshape(1, -1, 1, 1),
                             persistent=False)
        self.register_buffer("std", torch.tensor(std).reshape(1, -1, 1, 1),
                             persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return (x - self.mean) / self.std


class BasicBlock(nn.Module):
    """conv-bn-relu-conv-bn plus the shortcut; on a shape change the
    option-A shortcut: a stride-2 subsample and ``planes // 4`` zero
    channels padded on each side (`resnet_s.py:55-88`)."""

    def __init__(self, in_planes: int, planes: int, stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(in_planes, planes, 3, stride, 1, bias=False)
        self.bn1 = BatchNorm(planes, momentum=BN_MOMENTUM)
        self.conv2 = nn.Conv2d(planes, planes, 3, 1, 1, bias=False)
        self.bn2 = BatchNorm(planes, momentum=BN_MOMENTUM)
        self.pad = (planes // 4 if stride != 1 or in_planes != planes
                    else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        shortcut = x
        if self.pad is not None:
            shortcut = F.pad(x[:, :, ::2, ::2],
                             (0, 0, 0, 0, self.pad, self.pad))
        return F.relu(y + shortcut)


class GlobalAvgPool(nn.Module):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x.mean(dim=(2, 3), keepdim=True)


class ResNetS(StagedModule):
    """The CIFAR ResNet-s family (20/32/44/56/110 = num_blocks 3/5/7/9/18
    per stage). ``generator`` seeds the initialisation."""

    def __init__(self, num_blocks: Sequence[int] = (9, 9, 9),
                 num_classes: int = 10, init_weight: float = 1.0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.init_weight = float(init_weight)
        layers = [NormalizeByChannelMeanStd(),
                  nn.Conv2d(3, 16, 3, 1, 1, bias=False),
                  BatchNorm(16, momentum=BN_MOMENTUM), nn.ReLU()]
        in_planes = 16
        for stage_idx, (n, width) in enumerate(zip(num_blocks, (16, 32, 64))):
            for b in range(n):
                stride = 2 if stage_idx > 0 and b == 0 else 1
                layers.append(BasicBlock(in_planes, width, stride))
                in_planes = width
        layers += [GlobalAvgPool(), nn.Flatten(),
                   nn.Linear(in_planes, num_classes)]
        self.sequential_model = nn.Sequential(*layers)
        # learnable per-tap η (`resnet_s.py:113-114`)
        self.w = nn.Parameter(torch.full((9,), self.init_weight))
        self.reset_parameters(generator)

    def stages(self) -> nn.Sequential:
        return self.sequential_model

    def reset_parameters(self, generator: Optional[torch.Generator] = None
                         ) -> None:
        for m in self.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                nn.init.kaiming_normal_(m.weight, mode="fan_in",
                                        nonlinearity="relu",
                                        generator=generator)
                if m.bias is not None:
                    nn.init.zeros_(m.bias)
            elif isinstance(m, nn.BatchNorm2d):
                m.reset_parameters()
        with torch.no_grad():
            self.w.fill_(self.init_weight)


def resnet20(**kw) -> ResNetS:
    return ResNetS(num_blocks=(3, 3, 3), **kw)


def resnet32(**kw) -> ResNetS:
    return ResNetS(num_blocks=(5, 5, 5), **kw)


def resnet44(**kw) -> ResNetS:
    return ResNetS(num_blocks=(7, 7, 7), **kw)


def resnet56(init_weight_eta: float = 1.0, **kw) -> ResNetS:
    """`resnet_s.py:123-124`: 34 stages."""
    return ResNetS(num_blocks=(9, 9, 9), init_weight=init_weight_eta, **kw)


def resnet110(**kw) -> ResNetS:
    return ResNetS(num_blocks=(18, 18, 18), **kw)
