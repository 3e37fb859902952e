"""ImageNet-style ResNet torso (18/50/101) with static tap points and
frozen BatchNorm — the PyTorch counterpart of ``afan/models/resnet.py`` for
the detection stack.

Module names follow torchvision (``conv1``, ``bn1``, ``layerN.i.convK``,
``layerN.i.downsample.0/1``), so reference checkpoints load with
``load_state_dict``. Layout is NCHW. The ImageNet normalisation is embedded
at the input, and ``forward(x, start, end)`` runs layers (start, end]:
``start=0`` includes the stem; the detection features are (0, 3] and layer4
is the ROI head's "hidden" stage (:meth:`ResNetTorso.run_stage`).

Initialisation mirrors flax's: kaiming-normal (fan_out) conv kernels and
identity BatchNorm, drawn from an explicit ``torch.Generator``.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


class FrozenBatchNorm(nn.BatchNorm2d):
    """BatchNorm that always normalizes with its running statistics and
    never updates them (eps 1e-5), in train and eval mode alike. It keeps
    ``nn.BatchNorm2d``'s parameters and buffers, so checkpoint keys match."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.batch_norm(x, self.running_mean, self.running_var,
                            self.weight, self.bias, False, 0.0, self.eps)


def _conv(cin: int, cout: int, k: int, stride: int = 1) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, stride=stride, padding=k // 2, bias=False)


def _downsample(cin: int, cout: int, stride: int) -> Optional[nn.Sequential]:
    if stride == 1 and cin == cout:
        return None
    return nn.Sequential(_conv(cin, cout, 1, stride), FrozenBatchNorm(cout))


class Bottleneck(nn.Module):
    """torchvision Bottleneck: 1x1 reduce → 3x3 (stride) → 1x1 expand (x4),
    projection shortcut on a shape change."""
    expansion = 4

    def __init__(self, cin: int, planes: int, stride: int = 1):
        super().__init__()
        out = planes * self.expansion
        self.conv1 = _conv(cin, planes, 1)
        self.bn1 = FrozenBatchNorm(planes)
        self.conv2 = _conv(planes, planes, 3, stride)
        self.bn2 = FrozenBatchNorm(planes)
        self.conv3 = _conv(planes, out, 1)
        self.bn3 = FrozenBatchNorm(out)
        self.downsample = _downsample(cin, out, stride)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(y + identity)


class BasicBlockI(nn.Module):
    """torchvision BasicBlock (ResNet-18/34)."""
    expansion = 1

    def __init__(self, cin: int, planes: int, stride: int = 1):
        super().__init__()
        self.conv1 = _conv(cin, planes, 3, stride)
        self.bn1 = FrozenBatchNorm(planes)
        self.conv2 = _conv(planes, planes, 3)
        self.bn2 = FrozenBatchNorm(planes)
        self.downsample = _downsample(cin, planes, stride)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(y + identity)


class ResNetTorso(nn.Module):
    """Stem + layer1..4 with a tap-indexed split forward (taps 1..4 = exit
    after layer1..4)."""

    def __init__(self, layers: Sequence[int] = (3, 4, 6, 3),
                 block: type = Bottleneck):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = FrozenBatchNorm(64)
        cin = 64
        for i, (planes, n) in enumerate(zip((64, 128, 256, 512), layers)):
            blocks = []
            for j in range(n):
                stride = 2 if (i > 0 and j == 0) else 1
                blocks.append(block(cin, planes, stride))
                cin = planes * block.expansion
            setattr(self, f"layer{i + 1}", nn.Sequential(*blocks))
        self.register_buffer(
            "mean", torch.tensor(IMAGENET_MEAN).reshape(1, 3, 1, 1),
            persistent=False)
        self.register_buffer(
            "std", torch.tensor(IMAGENET_STD).reshape(1, 3, 1, 1),
            persistent=False)

    @property
    def stages(self):
        return (self.layer1, self.layer2, self.layer3, self.layer4)

    def stem(self, x: torch.Tensor) -> torch.Tensor:
        x = (x - self.mean) / self.std
        x = F.relu(self.bn1(self.conv1(x)))
        return F.max_pool2d(x, 3, stride=2, padding=1)

    def forward(self, x: torch.Tensor, start: int = 0, end: int = 4
                ) -> torch.Tensor:
        """Run layers (start, end] on NCHW ``x``."""
        if start == 0:
            x = self.stem(x)
        for stage in self.stages[start:end]:
            x = stage(x)
        return x

    def run_stage(self, x: torch.Tensor, stage: int) -> torch.Tensor:
        """Apply one layer (the detection 'hidden' = layer4 on pooled
        ROIs)."""
        return self.stages[stage](x)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """flax's init: kaiming-normal (fan_out, gain 2) conv kernels and
        identity BatchNorm."""
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                nn.init.kaiming_normal_(m.weight, mode="fan_out",
                                        nonlinearity="relu",
                                        generator=generator)
            elif isinstance(m, FrozenBatchNorm):
                m.reset_parameters()


def resnet18() -> ResNetTorso:
    return ResNetTorso((2, 2, 2, 2), BasicBlockI)


def resnet50() -> ResNetTorso:
    return ResNetTorso((3, 4, 6, 3), Bottleneck)


def resnet101() -> ResNetTorso:
    return ResNetTorso((3, 4, 23, 3), Bottleneck)


BACKBONES = {"resnet18": resnet18, "resnet50": resnet50,
             "resnet101": resnet101}


def from_name(name: str) -> ResNetTorso:
    """Backbone registry."""
    if name not in BACKBONES:
        raise ValueError(f"unknown backbone {name!r}; have {list(BACKBONES)}")
    return BACKBONES[name]()


# channels out of layer3 (detection features) / layer4 (hidden) per arch
NUM_FEATURES_OUT = {"resnet18": 256, "resnet50": 1024, "resnet101": 1024}
NUM_HIDDEN_OUT = {"resnet18": 512, "resnet50": 2048, "resnet101": 2048}
