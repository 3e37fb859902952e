"""DeepLab composite models — the PyTorch counterpart of
``afan/models/deeplab/modeling.py``.

Constructor parity: output_stride 8 → dilate layer3+4 with ASPP rates
(12, 24, 36); 16 → dilate layer4 with (6, 12, 18). The reference's
dict-dispatch forward is a set of methods with ``afan``'s names; inputs are
NCHW images in [0, 1] and every output is NCHW. Train or eval mode is the
module's own (``model.train()`` / ``model.eval()``), where ``afan`` passes
``train``. Every BatchNorm trains with momentum 0.01; the backbone's lr x0.1
group is :func:`segmentation_param_groups`. The backbone is a ResNet
(:mod:`afan_torch.models.resnet`) or ``afan``'s MobileNetV2
(:mod:`.mobilenetv2`); ``separable_conv`` makes the head's k > 1
convolutions depthwise-separable in both heads, as ``afan`` does. ``dtype``
is the compute dtype (``afan``'s ``build_model(..., dtype)``; bfloat16 under
``--bf16``): the parameters stay float32 and the activations, features and
logits take ``dtype`` (see :mod:`afan_torch.models.resnet`).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn as nn

from .. import resnet
from ..resnet import BatchNorm, from_name, set_compute_dtype
from .heads import DeepLabHead, DeepLabHeadV3Plus, resize_bilinear
from .mobilenetv2 import MobileNetV2Backbone

BACKBONES = (*resnet.BACKBONES, "mobilenet")
# channels of the backbone's output and of ``low_level``
NUM_HIDDEN_OUT = {**resnet.NUM_HIDDEN_OUT, "mobilenet": 320}
NUM_LOW_LEVEL_OUT = {**resnet.NUM_LOW_LEVEL_OUT, "mobilenet": 24}

SdDict = Dict[str, torch.Tensor]


class DeepLab(nn.Module):
    """backbone + classifier with SE (backbone layer) and SD (decoder)
    taps."""

    def __init__(self, backbone_name: str = "resnet50", num_classes: int = 21,
                 output_stride: int = 16, plus: bool = True,
                 dtype: torch.dtype = torch.float32,
                 separable_conv: bool = False):
        super().__init__()
        if backbone_name not in BACKBONES:
            raise ValueError(f"unknown backbone {backbone_name!r}; have "
                             f"{list(BACKBONES)}")
        if backbone_name == "mobilenet":
            self.backbone = MobileNetV2Backbone(output_stride)
        else:
            self.backbone = from_name(backbone_name,
                                      output_stride=output_stride,
                                      norm=BatchNorm)
        rates = (12, 24, 36) if output_stride == 8 else (6, 12, 18)
        cin = NUM_HIDDEN_OUT[backbone_name]
        self.classifier = (
            DeepLabHeadV3Plus(cin, NUM_LOW_LEVEL_OUT[backbone_name],
                              num_classes, rates, separable_conv)
            if plus else DeepLabHead(cin, num_classes, rates,
                                     separable_conv))
        self.dtype = dtype
        set_compute_dtype(self, dtype)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """flax's init: the backbone's own (ResNet: kaiming-normal fan_out
        convs; MobileNetV2: lecun-normal), kaiming-normal fan_in head convs
        (depthwise and pointwise alike), zero logits bias, identity
        BatchNorm."""
        self.backbone.reset_parameters(generator)
        for m in self.classifier.modules():
            if isinstance(m, nn.Conv2d):
                nn.init.kaiming_normal_(m.weight, mode="fan_in",
                                        nonlinearity="relu",
                                        generator=generator)
                if m.bias is not None:
                    nn.init.zeros_(m.bias)
            elif isinstance(m, nn.BatchNorm2d):
                m.reset_parameters()

    # ---------- SE tap (backbone layers) ----------

    def backbone_head(self, x: torch.Tensor, tap: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(feature at ``tap``, low_level: after layer1, or MobileNetV2's
        24-channel stage)."""
        return self.backbone.head(x, tap)

    def forward_tail_logits(self, feat: torch.Tensor,
                            low_level: torch.Tensor, tap: int
                            ) -> torch.Tensor:
        """Backbone tail from a (possibly adversarial) tap feature and the
        decoder → the output-stride-4 logits, without the final upsample."""
        return self.classifier(self.backbone.tail(feat, tap), low_level)

    def low_level_feature(self, x: torch.Tensor) -> torch.Tensor:
        return self.backbone.head(x, 1)[1]

    # ---------- clean forward ----------

    def forward_logits(self, x: torch.Tensor) -> torch.Tensor:
        """Clean forward without the final upsample."""
        out, low_level = self.backbone.head(x, 4)
        return self.classifier(out, low_level)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return resize_bilinear(self.forward_logits(x), x.shape[2:])

    # ---------- SD taps (decoder features) ----------

    def _sd_feature(self, out: torch.Tensor, low_level: torch.Tensor,
                    which: str) -> torch.Tensor:
        if which == "aspp":
            return self.classifier.aspp_head(out)
        if which == "concat":
            return self.classifier.concat_head(out, low_level)
        raise ValueError(f"unknown sd tap {which!r}")

    def sd_head(self, x: torch.Tensor, which: str) -> SdDict:
        """Decoder feature + everything the SD tail needs."""
        out, low_level = self.backbone.head(x, 4)
        return {"adv": self._sd_feature(out, low_level, which),
                "low_level": low_level, "out": out}

    def attack_features(self, x: torch.Tensor, tap: int, which: str
                        ) -> Tuple[torch.Tensor, torch.Tensor, SdDict]:
        """One backbone + decoder pass → (SE tap feature, low_level, SD
        dict): ``backbone_head`` and ``sd_head`` with the stages below the
        tap run once."""
        feat_se, low_level = self.backbone.head(x, tap)
        out = self.backbone.tail(feat_se, tap)
        return feat_se, low_level, {
            "adv": self._sd_feature(out, low_level, which),
            "low_level": low_level, "out": out}

    def sd_tail_logits(self, sd_dict: SdDict, which: str,
                       adv_feature: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
        """Classify from the (possibly adversarial) SD feature → os4
        logits."""
        adv = adv_feature if adv_feature is not None else sd_dict["adv"]
        if which == "aspp":
            return self.classifier.aspp_tail(adv, sd_dict["low_level"])
        if which == "concat":
            return self.classifier.concat_tail(adv)
        raise ValueError(f"unknown sd tap {which!r}")


def segmentation_param_groups(model: DeepLab) -> List[dict]:
    """'backbone' (lr x0.1, `main_aug_final.py:79-82`) and 'classifier'
    optimizer param groups; ``lr_scale`` is read by
    :func:`afan_torch.train.optim.sgd`."""
    return [{"params": list(model.backbone.parameters()), "lr_scale": 0.1},
            {"params": list(model.classifier.parameters()), "lr_scale": 1.0}]


MODEL_MAP = {
    # name parity with `main_aug_final.py:63-70`
    "deeplabv3_resnet50": dict(backbone_name="resnet50", plus=False),
    "deeplabv3plus_resnet50": dict(backbone_name="resnet50", plus=True),
    "deeplabv3_resnet101": dict(backbone_name="resnet101", plus=False),
    "deeplabv3plus_resnet101": dict(backbone_name="resnet101", plus=True),
    "deeplabv3_mobilenet": dict(backbone_name="mobilenet", plus=False),
    "deeplabv3plus_mobilenet": dict(backbone_name="mobilenet", plus=True),
}


def build_model(name: str, num_classes: int, output_stride: int = 16,
                dtype: torch.dtype = torch.float32,
                separable_conv: bool = False) -> DeepLab:
    if name not in MODEL_MAP:
        raise ValueError(f"unknown model {name!r}; have {list(MODEL_MAP)}")
    return DeepLab(num_classes=num_classes, output_stride=output_stride,
                   dtype=dtype, separable_conv=separable_conv,
                   **MODEL_MAP[name])
