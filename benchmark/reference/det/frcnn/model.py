"""Faster R-CNN — the PyTorch counterpart of ``afan/models/frcnn/model.py``:
the training losses with their SE and SD tap points, and the eval path
(:meth:`FasterRCNN.detect`).

The reference's input-dict modes map onto methods as in ``afan``:
``flag='head'`` is :meth:`FasterRCNN.backbone_head`, a tail or clean
forward is :meth:`FasterRCNN.losses` (with ``feature_tap`` /
``adv_feature``), ``out_idx='roi_head'`` is
:meth:`FasterRCNN.roi_head_forward`, ``'roi_tail'``
:meth:`FasterRCNN.roi_tail_losses`, ``'rpn_head'``
:meth:`FasterRCNN.rpn_head_forward` and ``'rpn_tail'``
:meth:`FasterRCNN.rpn_tail_losses`. Every method that samples anchors and
proposals takes a ``generator`` and optional ``targets``; with targets
given it samples nothing (no NMS, no labeling), so a step can reuse one
forward's sample and a test can inject ``afan``'s. The RPN tail samples in
every call, from its own proposals, with given sampling ``priorities``.

Module names are the reference's (`Detection/model.py`): ``features`` (the
torso), ``rpn`` (``_features.0``, ``_anchor_objectness``,
``_anchor_transformer``) and ``detection`` (``_proposal_class``,
``_proposal_transformer``, and ``hidden``, the same module object as
``features.layer4``), so reference checkpoints load with
``load_state_dict``. Every BatchNorm is frozen.

``dtype`` is the compute dtype (``afan``'s ``FasterRCNN(dtype=...)``,
bfloat16 under ``--bf16``): the parameters stay float32, every convolution
and linear computes in ``dtype`` (:mod:`afan_torch.models.resnet`), and so
do the features, the pooled ROIs, the heads' outputs and the CE losses; the
smooth-L1 losses, anchors, proposals and detected boxes are float32, as in
``afan``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn as nn

from ..lowp import mean
from ..resnet import (NUM_FEATURES_OUT, NUM_HIDDEN_OUT, from_name,
                      set_compute_dtype)
from .anchors import ANCHOR_RATIOS, ANCHOR_SIZES, generate_anchors
from .roi_head import (RoiPredictors, RoiTargets, generate_detections,
                       pool_and_hidden, roi_loss, roi_targets)
from . import sampling
from .rpn import RPNHeads, RPNTargets, generate_proposals, rpn_loss, rpn_targets
from .sampling import Priorities

Targets = Tuple[RPNTargets, RoiTargets]
# the sampling uniforms of one forward: the anchors', then the proposals'
SamplePriorities = Tuple[Priorities, Priorities]


class DetectionLosses(NamedTuple):
    """The four per-image loss vectors (B,) of the reference forward
    (`Detection/model.py:58-75`)."""
    anchor_objectness: torch.Tensor
    anchor_transformer: torch.Tensor
    proposal_class: torch.Tensor
    proposal_transformer: torch.Tensor

    def total(self) -> torch.Tensor:
        """Their means summed, as `Detection/attack_algo.py:21-27`."""
        return (mean(self.anchor_objectness) + mean(self.anchor_transformer)
                + mean(self.proposal_class)
                + mean(self.proposal_transformer))


def _nchw(images: torch.Tensor) -> torch.Tensor:
    return images.permute(0, 3, 1, 2)


@dataclasses.dataclass(frozen=True)
class FRCNNConfig:
    """TrainConfig/EvalConfig parity (`Detection/config/*.py`)."""
    backbone: str = "resnet50"
    num_classes: int = 21
    anchor_ratios: Sequence[Tuple[int, int]] = ANCHOR_RATIOS
    anchor_sizes: Sequence[int] = ANCHOR_SIZES
    train_pre_nms_top_n: int = 12000
    train_post_nms_top_n: int = 2000
    eval_pre_nms_top_n: int = 6000
    eval_post_nms_top_n: int = 300
    anchor_smooth_l1_beta: float = 1.0
    proposal_smooth_l1_beta: float = 1.0
    roi_samples: int = 128
    roi_fg_cap: int = 32
    rpn_samples: int = 256
    rpn_fg_cap: int = 128
    pooler_mode: str = "align"   # Config.POOLER_MODE: 'align' | 'pooling'


class FasterRCNN(nn.Module):
    def __init__(self, cfg: FRCNNConfig = FRCNNConfig(),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        self.features = from_name(cfg.backbone)
        self.rpn = RPNHeads(
            NUM_FEATURES_OUT[cfg.backbone],
            num_anchors=len(cfg.anchor_ratios) * len(cfg.anchor_sizes))
        self.detection = RoiPredictors(NUM_HIDDEN_OUT[cfg.backbone],
                                       cfg.num_classes)
        self.detection.hidden = self.features.layer4
        set_compute_dtype(self, dtype)
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

    # ---------- backbone taps (SE attack) ----------

    def backbone_head(self, images: torch.Tensor, tap: int) -> torch.Tensor:
        """NHWC images → the NCHW feature after layer ``tap`` (1-3)."""
        return self.features(_nchw(images), 0, tap)

    def backbone_tail(self, feature: torch.Tensor, tap: int) -> torch.Tensor:
        """Resume layer ``tap`` → layer3 from an (adversarial) feature."""
        return self.features(feature, tap, 3)

    def _torso(self, images: torch.Tensor, feature_tap: Optional[int],
               adv_feature: Optional[torch.Tensor]) -> torch.Tensor:
        if adv_feature is not None:
            return self.backbone_tail(adv_feature, feature_tap)
        return self.features_clean(_nchw(images))

    # ---------- training losses ----------

    def sample_targets(self, features: torch.Tensor,
                       image_hw: Tuple[int, int], obj: torch.Tensor,
                       reg: torch.Tensor, gt_boxes: torch.Tensor,
                       gt_classes: torch.Tensor, gt_valid: torch.Tensor,
                       generator: Optional[torch.Generator],
                       priorities: Optional[SamplePriorities] = None
                       ) -> Targets:
        """One forward's sample: label and sample the anchors, make the
        proposals from the detached RPN outputs (top 12000, NMS at 0.7,
        2000 kept, in one kernel launch for the batch), then label and
        sample them. Draws the RPN priorities, then the ROI ones, unless
        ``priorities`` gives them."""
        ih, iw = image_hw
        cfg = self.cfg
        rpn_p, roi_p = priorities if priorities is not None else (None, None)
        anchors = self._anchors(image_hw, tuple(features.shape[2:]))
        rpn_t = rpn_targets(anchors, gt_boxes, gt_valid, iw, ih,
                            cfg.rpn_samples, cfg.rpn_fg_cap, generator,
                            rpn_p)
        proposals, _ = generate_proposals(
            anchors, obj.detach(), reg.detach(), iw, ih,
            cfg.train_pre_nms_top_n, cfg.train_post_nms_top_n)
        roi_t = roi_targets(proposals, gt_boxes, gt_classes, gt_valid,
                            cfg.roi_samples, cfg.roi_fg_cap, generator,
                            roi_p)
        return rpn_t, roi_t

    def draw_priorities(self, features: torch.Tensor,
                        image_hw: Tuple[int, int],
                        generator: Optional[torch.Generator]
                        ) -> SamplePriorities:
        """The uniforms one sampling forward on ``features`` draws: the
        anchors' (B, A), then the proposals' (B, post_nms_top_n)."""
        bsz, dev = features.shape[0], features.device
        n_anchors = self._anchors(image_hw, tuple(features.shape[2:])
                                  ).shape[0]
        return (sampling.draw_priorities((bsz, n_anchors), generator, dev),
                sampling.draw_priorities(
                    (bsz, self.cfg.train_post_nms_top_n), generator, dev))

    def losses(self, images: torch.Tensor, gt_boxes: torch.Tensor,
               gt_classes: torch.Tensor, gt_valid: torch.Tensor,
               generator: Optional[torch.Generator] = None,
               feature_tap: Optional[int] = None,
               adv_feature: Optional[torch.Tensor] = None,
               targets: Optional[Targets] = None) -> DetectionLosses:
        """The four losses of a clean forward of NHWC ``images`` or, with
        ``adv_feature``, of the SE tail forward resuming from it at
        ``feature_tap``."""
        features = self._torso(images, feature_tap, adv_feature)
        return self._losses_from_features(
            features, tuple(images.shape[1:3]), gt_boxes, gt_classes,
            gt_valid, generator, targets)

    def _losses_from_features(self, features: torch.Tensor,
                              image_hw: Tuple[int, int],
                              gt_boxes, gt_classes, gt_valid,
                              generator: Optional[torch.Generator],
                              targets: Optional[Targets] = None,
                              rpn_out=None) -> DetectionLosses:
        obj, reg = self.rpn(features) if rpn_out is None else rpn_out
        if targets is None:
            targets = self.sample_targets(features, image_hw, obj, reg,
                                          gt_boxes, gt_classes, gt_valid,
                                          generator)
        rpn_t, roi_t = targets
        a_ce, a_l1 = rpn_loss(obj, reg, rpn_t, self.cfg.anchor_smooth_l1_beta)
        p_ce, p_l1 = self._roi_losses_from_targets(features, roi_t)
        return DetectionLosses(a_ce, a_l1, p_ce, p_l1)

    @torch.no_grad()
    def compute_targets(self, images: torch.Tensor, gt_boxes: torch.Tensor,
                        gt_classes: torch.Tensor, gt_valid: torch.Tensor,
                        generator: Optional[torch.Generator] = None
                        ) -> Targets:
        """One clean forward's sample, without gradients, for reuse across
        the step's forwards (``share_proposals``)."""
        features = self.features_clean(_nchw(images))
        obj, reg = self.rpn(features)
        return self.sample_targets(features, tuple(images.shape[1:3]), obj,
                                   reg, gt_boxes, gt_classes, gt_valid,
                                   generator)

    def losses_from_targets(self, images: torch.Tensor,
                            rpn_tgts: RPNTargets, roi_tgts: RoiTargets,
                            feature_tap: Optional[int] = None,
                            adv_feature: Optional[torch.Tensor] = None
                            ) -> DetectionLosses:
        """:meth:`losses` on given targets: RPN losses on the sampled
        anchors, ROI losses pooling the sampled boxes from this forward's
        features."""
        return self.losses(images, None, None, None, None, feature_tap,
                           adv_feature, (rpn_tgts, roi_tgts))

    def _roi_losses_from_targets(self, features: torch.Tensor,
                                 roi_tgts: RoiTargets
                                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        return self._roi_losses(self._hidden_vec(features, roi_tgts.boxes),
                                roi_tgts)

    def _roi_losses(self, hidden_vec: torch.Tensor, roi_tgts: RoiTargets
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
        bsz, s = roi_tgts.boxes.shape[:2]
        cls, reg_o = self.detection(hidden_vec)
        return roi_loss(cls.reshape(bsz, s, -1), reg_o.reshape(bsz, s, -1),
                        roi_tgts, self.cfg.proposal_smooth_l1_beta,
                        self.cfg.num_classes)

    # ---------- SD tap: the pooled ROI vector ----------

    def roi_dict(self, obj: torch.Tensor, reg: torch.Tensor,
                 targets: Targets) -> Dict[str, Any]:
        """The SD pass's RPN losses at its sampled anchors, and its
        targets (`model.py:115-150`)."""
        a_ce, a_l1 = rpn_loss(obj, reg, targets[0],
                              self.cfg.anchor_smooth_l1_beta)
        return {"anchor_objectness_losses": a_ce,
                "anchor_transformer_losses": a_l1,
                "roi_targets": targets[1], "targets": targets}

    def roi_head_forward(self, images: torch.Tensor, gt_boxes: torch.Tensor,
                         gt_classes: torch.Tensor, gt_valid: torch.Tensor,
                         generator: Optional[torch.Generator] = None,
                         targets: Optional[Targets] = None
                         ) -> Dict[str, Any]:
        """``out_idx='roi_head'``: a clean forward up to the pooled hidden
        vector ``roi_feature_map`` (B*S, C_hidden), the SD tap, with
        :meth:`roi_dict`'s RPN losses and targets."""
        features = self.features_clean(_nchw(images))
        obj, reg = self.rpn(features)
        if targets is None:
            targets = self.sample_targets(features, tuple(images.shape[1:3]),
                                          obj, reg, gt_boxes, gt_classes,
                                          gt_valid, generator)
        out = self.roi_dict(obj, reg, targets)
        out["roi_feature_map"] = self._hidden_vec(features, targets[1].boxes)
        return out

    def roi_tail_losses(self, roi_dict: Dict[str, Any],
                        roi_feature: Optional[torch.Tensor] = None
                        ) -> DetectionLosses:
        """``out_idx='roi_tail'``: the predictors and ROI losses from a
        (possibly adversarial) pooled feature; the RPN losses pass through
        from the dict (`model.py:141-150`)."""
        hidden_vec = (roi_dict["roi_feature_map"] if roi_feature is None
                      else roi_feature)
        p_ce, p_l1 = self._roi_losses(hidden_vec, roi_dict["roi_targets"])
        return DetectionLosses(roi_dict["anchor_objectness_losses"],
                               roi_dict["anchor_transformer_losses"],
                               p_ce, p_l1)

    # ---------- SD tap: the RPN trunk feature ----------

    def rpn_head_forward(self, images: torch.Tensor) -> Dict[str, Any]:
        """``out_idx='rpn_head'``: the clean layer3 ``features`` and the RPN
        trunk feature ``rpn_feature`` (B, 512, H/16, W/16), the SD tap
        (`model.py:77-113`; the reference's ascent on it is dead code,
        ``afan`` runs the intended one)."""
        features = self.features_clean(_nchw(images))
        return {"features": features, "rpn_feature": self.rpn.trunk(features)}

    def rpn_tail_losses(self, rpn_dict: Dict[str, Any],
                        image_hw: Tuple[int, int], gt_boxes: torch.Tensor,
                        gt_classes: torch.Tensor, gt_valid: torch.Tensor,
                        priorities: SamplePriorities,
                        rpn_feature: Optional[torch.Tensor] = None
                        ) -> DetectionLosses:
        """``out_idx='rpn_tail'``: the RPN predictions from a (possibly
        adversarial) trunk feature, the anchors and the proposals made from
        those predictions detached (the proposal NMS) sampled with
        ``priorities``, and the ROI losses pooled from the dict's clean
        ``features``. ``afan`` draws every call's sample from one key, so
        a step passes the same ``priorities`` to each call."""
        features = rpn_dict["features"]
        trunk = rpn_dict["rpn_feature"] if rpn_feature is None else rpn_feature
        obj, reg = self.rpn.predict(trunk)
        targets = self.sample_targets(features, image_hw, obj, reg, gt_boxes,
                                      gt_classes, gt_valid, None, priorities)
        return self._losses_from_features(features, image_hw, gt_boxes,
                                          gt_classes, gt_valid, None,
                                          targets, (obj, reg))

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

    def _hidden_vec(self, features: torch.Tensor, boxes: torch.Tensor
                    ) -> torch.Tensor:
        """Pooled hidden vectors (B*S, C_hidden) of each image's boxes
        (B, S, 4)."""
        return pool_and_hidden(
            features, boxes,
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
        hidden_vec = self._hidden_vec(features, proposals)
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
