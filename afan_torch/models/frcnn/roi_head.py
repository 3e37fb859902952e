"""ROI detection head — the PyTorch counterpart of
``afan/models/frcnn/roi_head.py`` (eval path).

Pool the proposals (ROIAlign 14x14 → 2x2 max → 7x7), run the backbone's
layer4 as the "hidden" stage, global max pool, then two linears (class
logits, 4 deltas per class). Detections are decoded per class and pruned by
per-class NMS at 0.3, all images and classes in one kernel launch.
"""
from __future__ import annotations

from typing import Callable, Tuple

import torch
import torch.nn as nn

from ...ops.nms import nms_mask
from ...ops.roi_align import pool_rois
from . import boxes as B
from .rpn import lecun_normal_


class RoiPredictors(nn.Module):
    """The two linear heads on the pooled hidden vector. The owning model
    also sets ``hidden`` (its backbone's layer4) on this module, so the
    reference's ``detection.hidden.*`` keys exist as an alias."""

    def __init__(self, hidden_channels: int, num_classes: int):
        super().__init__()
        self._proposal_class = nn.Linear(hidden_channels, num_classes)
        self._proposal_transformer = nn.Linear(hidden_channels,
                                               num_classes * 4)

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
    probs = torch.softmax(class_logits, dim=-1)
    # classes 1..C-1 as (B, C-1) groups of P boxes each
    c_boxes = boxes[:, :, 1:].permute(0, 2, 1, 3)
    c_probs = probs[:, :, 1:].permute(0, 2, 1)
    keep = nms_mask(c_boxes, c_probs, 0.3, plus_one=True).permute(0, 2, 1)
    keep = torch.cat([torch.zeros((bsz, p, 1), dtype=torch.bool, device=dev),
                      keep], dim=2)
    return boxes, probs, keep


def pool_and_hidden(features: torch.Tensor, boxes: torch.Tensor,
                    batch_indices: torch.Tensor,
                    hidden_fn: Callable[[torch.Tensor], torch.Tensor],
                    mode: str = "align") -> torch.Tensor:
    """Pooler → layer4 "hidden" → global max pool → (R, C_hidden)."""
    pooled = pool_rois(features, boxes, batch_indices, mode)   # (R,C,7,7)
    hidden = hidden_fn(pooled)                                 # (R,2048,4,4)
    return torch.amax(hidden, dim=(2, 3))
