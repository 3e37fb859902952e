"""Region Proposal Network — the PyTorch counterpart of
``afan/models/frcnn/rpn.py`` (eval path: heads and proposal generation).

Module names follow the reference (``_features.0``, ``_anchor_objectness``,
``_anchor_transformer``). The heads run in NCHW and their outputs are
permuted to NHWC before flattening, so the anchor axis is in ``(y, x, a)``
order, the order of :func:`..anchors.generate_anchors`.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn as nn

from ...ops.nms import nms_select_presorted
from . import boxes as B


def lecun_normal_(t: torch.Tensor, generator: torch.Generator) -> None:
    """flax's default kernel init: truncated normal (at 2 std) with variance
    1/fan_in."""
    fan_in = t[0].numel()
    std = math.sqrt(1.0 / fan_in) / .87962566103423978
    nn.init.trunc_normal_(t, std=std, a=-2 * std, b=2 * std,
                          generator=generator)


class RPNHeads(nn.Module):
    """3x3 trunk conv + ReLU, then 1x1 objectness (2 per anchor) and
    regression (4 per anchor) heads."""

    def __init__(self, in_channels: int, hidden_channels: int = 512,
                 num_anchors: int = 9):
        super().__init__()
        self._features = nn.Sequential(
            nn.Conv2d(in_channels, hidden_channels, 3, padding=1), nn.ReLU())
        self._anchor_objectness = nn.Conv2d(hidden_channels, num_anchors * 2, 1)
        self._anchor_transformer = nn.Conv2d(hidden_channels, num_anchors * 4,
                                             1)

    def trunk(self, features: torch.Tensor) -> torch.Tensor:
        return self._features(features)

    def predict(self, trunk_feature: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(B,512,H,W) → objectness (B,A,2), deltas (B,A,4), A = H*W*9."""
        b = trunk_feature.shape[0]
        obj = self._anchor_objectness(trunk_feature).permute(0, 2, 3, 1)
        reg = self._anchor_transformer(trunk_feature).permute(0, 2, 3, 1)
        return obj.reshape(b, -1, 2), reg.reshape(b, -1, 4)

    def forward(self, features: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        return self.predict(self.trunk(features))

    def reset_parameters(self, generator: torch.Generator) -> None:
        for conv in (self._features[0], self._anchor_objectness,
                     self._anchor_transformer):
            lecun_normal_(conv.weight, generator)
            nn.init.zeros_(conv.bias)


def generate_proposals(anchors: torch.Tensor, objectness: torch.Tensor,
                       deltas: torch.Tensor, image_width: int,
                       image_height: int, pre_nms_top_n: int,
                       post_nms_top_n: int
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched: decode → clip → top-k → NMS@0.7 → first post_nms_top_n.

    anchors (A, 4), objectness (B, A, 2), deltas (B, A, 4) → (boxes
    (B, post_n, 4) zero-padded, valid (B, post_n)). Ranking is by the raw
    fg logit; a stable descending sort keeps the lower index first on ties,
    as ``lax.top_k`` does."""
    proposals = B.decode_deltas(anchors[None], deltas)
    proposals = B.clip(proposals, 0, 0, image_width, image_height)
    scores = objectness[..., 1]
    k = min(pre_nms_top_n, anchors.shape[0])
    top_idx = torch.sort(scores, dim=-1, descending=True,
                         stable=True).indices[:, :k]
    top_boxes = torch.gather(proposals, 1,
                             top_idx[..., None].expand(-1, -1, 4))
    return nms_select_presorted(top_boxes, 0.7, post_nms_top_n,
                                plus_one=True)
