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
Layout is NCHW; every BatchNorm is the trainable
:class:`afan_torch.models.resnet.BatchNorm`.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..resnet import BatchNorm


def resize_bilinear(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """``F.interpolate(mode='bilinear', align_corners=False)`` of NCHW
    ``x`` to ``size``; ``jax.image.resize(..., 'bilinear')`` computes the
    same map when it upsamples (it antialiases only when it shrinks)."""
    return F.interpolate(x, size=tuple(size), mode="bilinear",
                         align_corners=False)


class ConvBNReLU(nn.Sequential):
    """conv (no bias) → BatchNorm → ReLU, as ``(0, 1, 2)``."""

    def __init__(self, cin: int, cout: int, k: int, dilation: int = 1):
        super().__init__(
            nn.Conv2d(cin, cout, k, padding=(k // 2) * dilation,
                      dilation=dilation, bias=False),
            BatchNorm(cout), nn.ReLU())


class ASPPPooling(nn.Sequential):
    """Image pooling: global mean → 1x1 conv-bn-relu → broadcast back."""

    def __init__(self, cin: int, cout: int):
        super().__init__(nn.AdaptiveAvgPool2d(1),
                         nn.Conv2d(cin, cout, 1, bias=False),
                         BatchNorm(cout), nn.ReLU())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x).expand(-1, -1, x.shape[2], x.shape[3])


class ASPP(nn.Module):
    """Atrous spatial pyramid pooling (`_deeplab.py:163-192`)."""

    def __init__(self, cin: int, rates: Sequence[int], cout: int = 256):
        super().__init__()
        self.convs = nn.ModuleList(
            [ConvBNReLU(cin, cout, 1)]
            + [ConvBNReLU(cin, cout, 3, r) for r in rates]
            + [ASPPPooling(cin, cout)])
        self.project = nn.Sequential(
            nn.Conv2d(5 * cout, cout, 1, bias=False), BatchNorm(cout),
            nn.ReLU(), nn.Dropout(0.1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.project(torch.cat([m(x) for m in self.convs], dim=1))


def _classifier3x3(cin: int, num_classes: int) -> nn.Sequential:
    """3x3 conv-bn-relu + 1x1 logits (`_deeplab.py:39-44`)."""
    return nn.Sequential(nn.Conv2d(cin, 256, 3, padding=1, bias=False),
                         BatchNorm(256), nn.ReLU(),
                         nn.Conv2d(256, num_classes, 1))


class DeepLabHeadV3Plus(nn.Module):
    """The V3+ decoder with its two SD tap points (`_deeplab.py:28-80`)."""

    def __init__(self, in_channels: int, low_level_channels: int,
                 num_classes: int, aspp_dilate: Sequence[int] = (12, 24, 36)):
        super().__init__()
        self.project = ConvBNReLU(low_level_channels, 48, 1)
        self.aspp = ASPP(in_channels, aspp_dilate)
        self.classifier = _classifier3x3(304, num_classes)

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
                 aspp_dilate: Sequence[int] = (12, 24, 36)):
        super().__init__()
        self.classifier = nn.Sequential(ASPP(in_channels, aspp_dilate),
                                        *_classifier3x3(256, num_classes))

    def forward(self, out: torch.Tensor, low_level: torch.Tensor = None
                ) -> torch.Tensor:
        return self.classifier(out)

    def aspp_head(self, out: torch.Tensor) -> torch.Tensor:
        return self.classifier[0](out)

    def aspp_tail(self, adv_aspp: torch.Tensor,
                  low_level: torch.Tensor = None) -> torch.Tensor:
        return self.classifier[1:](adv_aspp)
