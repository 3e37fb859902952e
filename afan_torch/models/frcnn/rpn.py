"""Region Proposal Network — the PyTorch counterpart of
``afan/models/frcnn/rpn.py``: the heads, anchor labeling and sampling, the
two RPN losses and proposal generation.

Module names follow the reference (``_features.0``, ``_anchor_objectness``,
``_anchor_transformer``). The heads run in NCHW and their outputs are
permuted to NHWC before flattening, so the anchor axis is in ``(y, x, a)``
order, the order of :func:`..anchors.generate_anchors`.

Under a bfloat16 compute dtype (``afan``'s ``RPNHeads(dtype=bf16)``) the
heads are bfloat16 convolutions, the objectness CE is ``afan``'s bfloat16
``log_softmax`` (:mod:`afan_torch.ops.lowp`), and the smooth-L1 promotes
the bfloat16 deltas to the float32 targets. Proposals decode the deltas in
float32: ``afan`` writes ``exp`` of a bfloat16 delta times a float32 anchor
side, and its jitted step keeps the ``exp`` in float32 inside XLA's fusion
(excess precision) rather than rounding it. So the boxes that reach NMS are
float32, as ``afan``'s NMS casts them, and they are ranked by the bfloat16
fg logit, ties to the lower index.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn as nn

from ...ops.lowp import log_softmax
from ...ops.nms import nms_select_presorted
from ..resnet import Conv2d, lecun_normal_
from . import boxes as B
from .sampling import (Priorities, SampleResult, beta_smooth_l1, gather_rows,
                       masked_mean, sample_fg_bg, select_fg_bg)


class RPNHeads(nn.Module):
    """3x3 trunk conv + ReLU, then 1x1 objectness (2 per anchor) and
    regression (4 per anchor) heads."""

    def __init__(self, in_channels: int, hidden_channels: int = 512,
                 num_anchors: int = 9):
        super().__init__()
        self._features = nn.Sequential(
            Conv2d(in_channels, hidden_channels, 3, padding=1), nn.ReLU())
        self._anchor_objectness = Conv2d(hidden_channels, num_anchors * 2, 1)
        self._anchor_transformer = Conv2d(hidden_channels, num_anchors * 4, 1)

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


class RPNTargets(NamedTuple):
    sample: SampleResult          # (B, S) sampled anchor slots
    gt_objectness: torch.Tensor   # (B, S) int64 0/1
    gt_deltas: torch.Tensor       # (B, S, 4)


def label_anchors(anchors: torch.Tensor, gt_boxes: torch.Tensor,
                  gt_valid: torch.Tensor, image_width: int,
                  image_height: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Anchor labels (`region_proposal_network.py:69-83`) for a batch:
    anchors (A, 4), ground truth (B, G, 4) with validity (B, G) → labels
    (B, A) (-1 ignore, 0 bg below IoU 0.3, 1 fg at IoU 0.7 or the best
    anchor of a gt) and the assigned gt (B, A); anchors not wholly inside
    the image are -1."""
    ious = B.iou(anchors[None], gt_boxes)                    # (B, A, G)
    ious = torch.where(gt_valid[:, None, :], ious,
                       torch.full_like(ious, -1.0))
    anchor_max, assignment = ious.max(dim=2)
    gt_max = ious.amax(dim=1, keepdim=True)                   # (B, 1, G)
    labels = torch.full(anchor_max.shape, -1, dtype=torch.int64,
                        device=anchors.device)
    labels = torch.where(anchor_max < 0.3, 0, labels)
    additions = ((ious > 0) & (ious == gt_max)
                 & gt_valid[:, None, :]).any(dim=2)
    labels = torch.where(additions, 1, labels)
    labels = torch.where(anchor_max >= 0.7, 1, labels)
    inside = B.inside(anchors, 0, 0, image_width, image_height)
    return torch.where(inside[None], labels, -1), assignment


def rpn_targets(anchors: torch.Tensor, gt_boxes: torch.Tensor,
                gt_valid: torch.Tensor, image_width: int, image_height: int,
                num_samples: int = 256, fg_cap: int = 128,
                generator: Optional[torch.Generator] = None,
                priorities: Optional[Priorities] = None) -> RPNTargets:
    """Label and sample each image's anchors and gather the regression
    targets of the sampled slots. ``priorities`` (two (B, A) uniforms)
    replace the draw from ``generator``."""
    labels, assignment = label_anchors(anchors, gt_boxes, gt_valid,
                                       image_width, image_height)
    fg, bg = labels == 1, labels == 0
    sample = (sample_fg_bg(generator, fg, bg, num_samples, fg_cap)
              if priorities is None else
              select_fg_bg(priorities, fg, bg, num_samples, fg_cap))
    sel = sample.indices
    sel_anchors = anchors[sel]
    sel_gt = gather_rows(gt_boxes, torch.gather(assignment, 1, sel))
    return RPNTargets(sample=sample, gt_objectness=sample.is_fg.long(),
                      gt_deltas=B.encode_deltas(sel_anchors, sel_gt))


def rpn_loss(objectness: torch.Tensor, deltas: torch.Tensor,
             targets: RPNTargets, beta: float
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-image (objectness CE, fg smooth-L1) over the sampled anchors
    (`region_proposal_network.py:175-198`): objectness (B, A, 2), deltas
    (B, A, 4) → two (B,) vectors."""
    sel = targets.sample.indices
    logp = log_softmax(gather_rows(objectness, sel), dim=-1)
    ce = -torch.gather(logp, 2, targets.gt_objectness[..., None])[..., 0]
    ce = masked_mean(ce, targets.sample.valid)
    l1 = beta_smooth_l1(gather_rows(deltas, sel), targets.gt_deltas, beta,
                        targets.sample.is_fg)
    return ce, l1


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
    proposals = B.decode_deltas(anchors[None], deltas.float())
    proposals = B.clip(proposals, 0, 0, image_width, image_height)
    scores = objectness[..., 1]
    k = min(pre_nms_top_n, anchors.shape[0])
    top_idx = torch.sort(scores, dim=-1, descending=True,
                         stable=True).indices[:, :k]
    top_boxes = torch.gather(proposals, 1,
                             top_idx[..., None].expand(-1, -1, 4))
    return nms_select_presorted(top_boxes, 0.7, post_nms_top_n,
                                plus_one=True)
