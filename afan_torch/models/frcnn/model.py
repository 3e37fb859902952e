"""Faster R-CNN — the PyTorch counterpart of ``afan/models/frcnn/model.py``
(eval path: :meth:`FasterRCNN.detect`).

Module names are the reference's (`Detection/model.py`): ``features`` (the
torso), ``rpn`` (``_features.0``, ``_anchor_objectness``,
``_anchor_transformer``) and ``detection`` (``_proposal_class``,
``_proposal_transformer``, and ``hidden``, the same module object as
``features.layer4``), so reference checkpoints load with
``load_state_dict``. Every BatchNorm is frozen.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Sequence, Tuple

import torch
import torch.nn as nn

from ..resnet import NUM_FEATURES_OUT, NUM_HIDDEN_OUT, from_name
from .anchors import ANCHOR_RATIOS, ANCHOR_SIZES, generate_anchors
from .roi_head import RoiPredictors, generate_detections, pool_and_hidden
from .rpn import RPNHeads, generate_proposals


@dataclasses.dataclass(frozen=True)
class FRCNNConfig:
    """EvalConfig parity (`Detection/config/*.py`); the training fields of
    ``afan``'s config come with the training path."""
    backbone: str = "resnet50"
    num_classes: int = 21
    anchor_ratios: Sequence[Tuple[int, int]] = ANCHOR_RATIOS
    anchor_sizes: Sequence[int] = ANCHOR_SIZES
    eval_pre_nms_top_n: int = 6000
    eval_post_nms_top_n: int = 300
    pooler_mode: str = "align"   # Config.POOLER_MODE: 'align' | 'pooling'


class FasterRCNN(nn.Module):
    def __init__(self, cfg: FRCNNConfig = FRCNNConfig()):
        super().__init__()
        self.cfg = cfg
        self.features = from_name(cfg.backbone)
        self.rpn = RPNHeads(
            NUM_FEATURES_OUT[cfg.backbone],
            num_anchors=len(cfg.anchor_ratios) * len(cfg.anchor_sizes))
        self.detection = RoiPredictors(NUM_HIDDEN_OUT[cfg.backbone],
                                       cfg.num_classes)
        self.detection.hidden = self.features.layer4
        self._anchor_cache: Dict[tuple, torch.Tensor] = {}

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Seeded init mirroring flax's: kaiming-normal torso convs,
        lecun-normal RPN convs and linears, identity BatchNorm."""
        self.features.reset_parameters(generator)
        self.rpn.reset_parameters(generator)
        self.detection.reset_parameters(generator)

    def features_clean(self, images: torch.Tensor) -> torch.Tensor:
        """NCHW images in [0, 1] → layer3 features."""
        return self.features(images, 0, 3)

    def _anchors(self, image_hw: Tuple[int, int],
                 feature_hw: Tuple[int, int]) -> torch.Tensor:
        dev = next(self.parameters()).device
        key = (tuple(image_hw), tuple(feature_hw), dev)
        if key not in self._anchor_cache:
            h, w = image_hw
            fh, fw = feature_hw
            a = generate_anchors(w, h, fw, fh, self.cfg.anchor_ratios,
                                 self.cfg.anchor_sizes)
            self._anchor_cache[key] = torch.from_numpy(a).to(dev)
        return self._anchor_cache[key]

    def _hidden_vec(self, features: torch.Tensor, flat_boxes: torch.Tensor,
                    bidx: torch.Tensor) -> torch.Tensor:
        return pool_and_hidden(
            features, flat_boxes, bidx,
            hidden_fn=lambda x: self.features.run_stage(x, 3),
            mode=self.cfg.pooler_mode)

    def detect_from_features(self, features: torch.Tensor,
                             image_hw: Tuple[int, int]
                             ) -> Tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
        """Everything after the torso: proposals, pooling, heads and
        per-class NMS."""
        bsz = features.shape[0]
        ih, iw = image_hw
        anchors = self._anchors((ih, iw), tuple(features.shape[2:]))
        obj, reg = self.rpn(features)
        proposals, pvalid = generate_proposals(
            anchors, obj, reg, iw, ih, self.cfg.eval_pre_nms_top_n,
            self.cfg.eval_post_nms_top_n)
        s = proposals.shape[1]
        bidx = torch.arange(bsz, device=features.device).repeat_interleave(s)
        hidden_vec = self._hidden_vec(features, proposals.reshape(-1, 4),
                                      bidx)
        cls, reg_o = self.detection(hidden_vec)
        boxes, probs, keep = generate_detections(
            proposals, cls.reshape(bsz, s, -1), reg_o.reshape(bsz, s, -1),
            iw, ih, self.cfg.num_classes)
        return boxes, probs, keep & pvalid[:, :, None]

    def detect(self, images: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Eval forward on NHWC images (B, H, W, 3) in [0, 1] → padded
        detections: boxes (B, P, C, 4), probs (B, P, C), keep (B, P, C)
        after per-class NMS@0.3; the caller applies its probability
        threshold."""
        features = self.features_clean(images.permute(0, 3, 1, 2))
        return self.detect_from_features(features, tuple(images.shape[1:3]))
