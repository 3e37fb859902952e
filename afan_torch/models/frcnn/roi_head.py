"""ROI detection head — the PyTorch counterpart of
``afan/models/frcnn/roi_head.py``.

Training labels the proposals by IoU (fg at 0.5 with the matched gt's
class), samples 128 slots per image with at most 32 fg (`model.py:263-283`)
and scores them with a CE and a class-selected smooth-L1 on deltas
normalized by mean 0 and std (.1, .1, .2, .2) (`model.py:354-379`). Pool the
proposals (ROIAlign 14x14 → 2x2 max → 7x7), run the backbone's
layer4 as the "hidden" stage, global max pool, then two linears (class
logits, 4 deltas per class). Detections are decoded per class and pruned by
per-class NMS at 0.3, all images and classes in one kernel launch.

Under a bfloat16 compute dtype the predictors are Flax's ``Dense(dtype=
bf16)`` (:class:`afan_torch.models.resnet.Linear`), the CE and the
detections' softmax are ``afan``'s bfloat16 formulas
(:mod:`afan_torch.ops.lowp`), and the decoded boxes promote to float32.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import torch
import torch.nn as nn

from ...ops.lowp import log_softmax, softmax
from ...ops.nms import nms_mask
from ...ops.roi_align import pool_rois
from ..resnet import Linear, lecun_normal_
from . import boxes as B
from .sampling import (Priorities, SampleResult, beta_smooth_l1, gather_rows,
                       masked_mean, sample_fg_bg, select_fg_bg)


class RoiTargets(NamedTuple):
    sample: SampleResult        # (B, S) slots into the proposal axis
    boxes: torch.Tensor         # (B, S, 4) sampled proposal boxes
    gt_classes: torch.Tensor    # (B, S) int64 (0 = background)
    gt_deltas: torch.Tensor     # (B, S, 4) normalized regression targets


def roi_targets(proposals: torch.Tensor, gt_boxes: torch.Tensor,
                gt_classes: torch.Tensor, gt_valid: torch.Tensor,
                num_samples: int = 128, fg_cap: int = 32,
                generator: Optional[torch.Generator] = None,
                priorities: Optional[Priorities] = None) -> RoiTargets:
    """Label and sample each image's proposals (B, P, 4) against its
    ground truth (B, G); zero-padded proposals have IoU 0 with every gt and
    are background candidates, as in the reference. ``priorities`` (two
    (B, P) uniforms) replace the draw from ``generator``."""
    ious = B.iou(proposals, gt_boxes)                         # (B, P, G)
    ious = torch.where(gt_valid[:, None, :], ious,
                       torch.full_like(ious, -1.0))
    max_iou, assignment = ious.max(dim=2)
    fg = max_iou >= 0.5
    labels = torch.where(fg, torch.gather(gt_classes.long(), 1, assignment),
                         0)
    fg, bg = fg & (labels > 0), max_iou < 0.5
    sample = (sample_fg_bg(generator, fg, bg, num_samples, fg_cap)
              if priorities is None else
              select_fg_bg(priorities, fg, bg, num_samples, fg_cap))
    sel = sample.indices
    sel_boxes = gather_rows(proposals, sel)
    sel_gt = gather_rows(gt_boxes, torch.gather(assignment, 1, sel))
    sel_classes = torch.where(sample.is_fg, torch.gather(labels, 1, sel), 0)
    mean = torch.tensor(B.TRANSFORMER_NORMALIZE_MEAN, device=proposals.device)
    std = torch.tensor(B.TRANSFORMER_NORMALIZE_STD, device=proposals.device)
    deltas = (B.encode_deltas(sel_boxes, sel_gt) - mean) / std
    return RoiTargets(sample=sample, boxes=sel_boxes, gt_classes=sel_classes,
                      gt_deltas=deltas)


def roi_loss(class_logits: torch.Tensor, reg_out: torch.Tensor,
             targets: RoiTargets, beta: float, num_classes: int
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-image (CE, smooth-L1) over the sampled slots: logits (B, S, C),
    deltas (B, S, C*4) → two (B,) vectors. The deltas are taken at each
    slot's gt class; only fg rows enter the smooth-L1."""
    logp = log_softmax(class_logits, dim=-1)
    cls = targets.gt_classes
    ce = masked_mean(-torch.gather(logp, 2, cls[..., None])[..., 0],
                     targets.sample.valid)
    reg = reg_out.reshape(*reg_out.shape[:2], num_classes, 4)
    reg_sel = torch.gather(reg, 2, cls[..., None, None].expand(
        -1, -1, 1, 4))[:, :, 0]
    fg = targets.sample.is_fg & (cls > 0)
    return ce, beta_smooth_l1(reg_sel, targets.gt_deltas, beta, fg)


class RoiPredictors(nn.Module):
    """The two linear heads on the pooled hidden vector. The owning model
    also sets ``hidden`` (its backbone's layer4) on this module, so the
    reference's ``detection.hidden.*`` keys exist as an alias."""

    def __init__(self, hidden_channels: int, num_classes: int):
        super().__init__()
        self._proposal_class = Linear(hidden_channels, num_classes)
        self._proposal_transformer = Linear(hidden_channels, num_classes * 4)

    def forward(self, hidden_vec: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(R, C_hidden) → ((R, classes), (R, classes*4))."""
        return (self._proposal_class(hidden_vec),
                self._proposal_transformer(hidden_vec))

    def reset_parameters(self, generator: torch.Generator) -> None:
        for lin in (self._proposal_class, self._proposal_transformer):
            lecun_normal_(lin.weight, generator)
            nn.init.zeros_(lin.bias)


def generate_detections(proposals: torch.Tensor, class_logits: torch.Tensor,
                        reg_out: torch.Tensor, image_width: int,
                        image_height: int, num_classes: int
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Batched eval-time detections: proposals (B, P, 4), logits (B, P, C),
    deltas (B, P, C*4) → boxes (B, P, C, 4), probs (B, P, C), keep
    (B, P, C), where keep is the per-class NMS@0.3 mask (class 0, the
    background, is never kept)."""
    bsz, p = proposals.shape[0], proposals.shape[1]
    dev = proposals.device
    std = torch.tensor(B.TRANSFORMER_NORMALIZE_STD, device=dev)
    mean = torch.tensor(B.TRANSFORMER_NORMALIZE_MEAN, device=dev)
    reg = reg_out.reshape(bsz, p, num_classes, 4) * std + mean
    boxes = B.decode_deltas(proposals[:, :, None, :], reg)
    boxes = B.clip(boxes, 0, 0, image_width, image_height)
    probs = softmax(class_logits, dim=-1)
    # classes 1..C-1 as (B, C-1) groups of P boxes each
    c_boxes = boxes[:, :, 1:].permute(0, 2, 1, 3)
    c_probs = probs[:, :, 1:].permute(0, 2, 1)
    keep = nms_mask(c_boxes, c_probs, 0.3, plus_one=True).permute(0, 2, 1)
    keep = torch.cat([torch.zeros((bsz, p, 1), dtype=torch.bool, device=dev),
                      keep], dim=2)
    return boxes, probs, keep


def pool_and_hidden(features: torch.Tensor, boxes: torch.Tensor,
                    hidden_fn: Callable[[torch.Tensor], torch.Tensor],
                    mode: str = "align") -> torch.Tensor:
    """Pooler on each image's boxes ``(B, S, 4)`` → layer4 "hidden" →
    global max pool → (B*S, C_hidden)."""
    pooled = pool_rois(features, boxes, None, mode)            # (R,C,7,7)
    hidden = hidden_fn(pooled)                                 # (R,2048,4,4)
    return torch.amax(hidden, dim=(2, 3))
