"""Detection mAP — a copy of ``afan/eval/det_map.py`` (the behavioral port
of `Detection/voc_eval.py` plus the evaluation loop of
`Detection/evaluator.py:20-47`), its loop taking the port's detect function
and scoring by the VOC protocol or COCO's (:mod:`.coco_map`).

The reference writes per-class result files (comp3 protocol,
`voc2007.py:152-161`) and re-reads them; here evaluation is in-memory, but
the math is the exact voc_eval algorithm: score-descending greedy matching
at IoU>0.5 with the legacy +1 areas, difficult-gt neutrality, VOC07 11-pt
or continuous AP.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import numpy as np
import torch

from ..parallel import mesh as dp
from .coco_map import coco_bbox_ap, format_coco_summary


def voc_ap(rec: np.ndarray, prec: np.ndarray, use_07_metric: bool = False
           ) -> float:
    """AP from a PR curve (`voc_eval.py:31-62`): 11-point interpolation or
    the continuous precision-envelope area."""
    if use_07_metric:
        ap = 0.0
        for t in np.arange(0.0, 1.1, 0.1):
            p = np.max(prec[rec >= t]) if np.sum(rec >= t) > 0 else 0.0
            ap += p / 11.0
        return float(ap)
    mrec = np.concatenate(([0.0], rec, [1.0]))
    mpre = np.concatenate(([0.0], prec, [0.0]))
    for i in range(mpre.size - 1, 0, -1):
        mpre[i - 1] = np.maximum(mpre[i - 1], mpre[i])
    i = np.where(mrec[1:] != mrec[:-1])[0]
    return float(np.sum((mrec[i + 1] - mrec[i]) * mpre[i + 1]))


@dataclass
class ClassGT:
    """Per-image gt for one class: boxes + difficult flags + matched marks
    (`voc_eval.py:121-131`)."""
    bbox: np.ndarray
    difficult: np.ndarray
    det: List[bool] = field(default_factory=list)

    def __post_init__(self):
        self.det = [False] * len(self.bbox)


def eval_class(gt_by_image: Dict[str, ClassGT], image_ids: List[str],
               confidence: np.ndarray, boxes: np.ndarray,
               ovthresh: float = 0.5, use_07_metric: bool = True
               ) -> Tuple[np.ndarray, np.ndarray, float]:
    """One class's (rec, prec, ap) — the matching loop of
    `voc_eval.py:136-198` (greedy by confidence, +1-pixel IoU, difficult
    gts neutral, double-matches are FPs)."""
    npos = sum(int(np.sum(~g.difficult)) for g in gt_by_image.values())
    order = np.argsort(-confidence)
    image_ids = [image_ids[i] for i in order]
    boxes = boxes[order]
    nd = len(image_ids)
    tp = np.zeros(nd)
    fp = np.zeros(nd)
    for d in range(nd):
        r = gt_by_image.get(image_ids[d])
        bb = boxes[d]
        ovmax, jmax = -np.inf, -1
        if r is not None and r.bbox.size > 0:
            g = r.bbox
            ixmin = np.maximum(g[:, 0], bb[0])
            iymin = np.maximum(g[:, 1], bb[1])
            ixmax = np.minimum(g[:, 2], bb[2])
            iymax = np.minimum(g[:, 3], bb[3])
            iw = np.maximum(ixmax - ixmin + 1.0, 0.0)
            ih = np.maximum(iymax - iymin + 1.0, 0.0)
            inters = iw * ih
            uni = ((bb[2] - bb[0] + 1.0) * (bb[3] - bb[1] + 1.0)
                   + (g[:, 2] - g[:, 0] + 1.0) * (g[:, 3] - g[:, 1] + 1.0)
                   - inters)
            overlaps = inters / uni
            ovmax = np.max(overlaps)
            jmax = int(np.argmax(overlaps))
        if ovmax > ovthresh:
            if not r.difficult[jmax]:
                if not r.det[jmax]:
                    tp[d] = 1.0
                    r.det[jmax] = True
                else:
                    fp[d] = 1.0
        else:
            fp[d] = 1.0
    fp = np.cumsum(fp)
    tp = np.cumsum(tp)
    rec = tp / float(max(npos, 1))
    prec = tp / np.maximum(tp + fp, np.finfo(np.float64).eps)
    return rec, prec, voc_ap(rec, prec, use_07_metric)


def evaluate_detections(num_classes: int,
                        gt: Dict[str, Tuple[np.ndarray, np.ndarray, np.ndarray]],
                        det_image_ids: List[str], det_boxes: np.ndarray,
                        det_classes: np.ndarray, det_probs: np.ndarray,
                        ovthresh: float = 0.5, use_07_metric: bool = True
                        ) -> Tuple[float, Dict[int, float]]:
    """mAP over classes 1..num_classes-1 (`voc2007.py:118-149`).

    ``gt``: image_id → (boxes (G,4), labels (G,), difficult (G,)).
    Detections are flat arrays across all images.
    """
    aps = {}
    det_classes = np.asarray(det_classes)
    det_probs = np.asarray(det_probs)
    det_boxes = np.asarray(det_boxes).reshape(-1, 4)
    for c in range(1, num_classes):
        gt_c = {}
        for image_id, (b, l, diff) in gt.items():
            m = l == c
            gt_c[image_id] = ClassGT(bbox=b[m], difficult=diff[m])
        sel = np.nonzero(det_classes == c)[0]
        if len(sel) == 0:
            aps[c] = 0.0
            continue
        _, _, ap = eval_class(gt_c, [det_image_ids[i] for i in sel],
                              det_probs[sel], det_boxes[sel],
                              ovthresh, use_07_metric)
        aps[c] = ap
    mean_ap = float(np.mean(list(aps.values()))) if aps else 0.0
    return mean_ap, aps


def ground_truth(samples) -> Dict[str, Tuple[np.ndarray, np.ndarray,
                                              np.ndarray]]:
    """image_id → (boxes, labels, difficult) of the loader's samples: a VOC
    sample's raw XML boxes with their difficult flags (neutral in the VOC07
    mAP); a synthetic or COCO sample's boxes, none of them difficult."""
    return {s.image_id: ((s.eval_boxes, s.eval_labels, s.eval_difficult)
                         if s.eval_boxes is not None else
                         (s.boxes, s.labels, np.zeros(len(s.labels), bool)))
            for s in samples}


def crowd_regions(samples) -> Dict[str, Tuple[np.ndarray, np.ndarray]]:
    """image_id → (boxes, labels) of the samples' COCO crowd annotations."""
    return {s.image_id: (s.crowd_boxes, s.crowd_labels) for s in samples
            if s.crowd_boxes is not None and len(s.crowd_boxes)}


class DetectionEvaluator:
    """The eval loop of `Detection/evaluator.py:20-47`: clean forward per
    batch → rescale boxes by 1/scale → prob>0.05 filter → dataset mAP."""

    PROB_THRESH = 0.05

    def __init__(self, loader, detect_fn, num_classes: int,
                 use_07_metric: bool = True, protocol: str = "voc"):
        """``detect_fn(images (B, H, W, 3))`` → (boxes, probs, keep), as
        :func:`afan_torch.train.detect_loop.make_detect_fn` gives it.
        ``protocol``: 'voc' (voc_eval 11-pt/continuous AP@0.5) or 'coco'
        (COCOeval AP@[.5:.95], :mod:`.coco_map`)."""
        if protocol not in ("voc", "coco"):
            raise ValueError(f"unknown protocol {protocol!r}")
        self.loader = loader
        self.detect_fn = detect_fn
        self.num_classes = num_classes
        self.use_07 = use_07_metric
        self.protocol = protocol

    def _batches(self):
        """(index, batch) of the loader's batches; under data parallelism
        rank r decodes and runs the batches whose index is r modulo N."""
        size, r = dp.world_size(), dp.rank()
        if size == 1:
            yield from enumerate(self.loader)
            return
        for k, idxs in enumerate(self.loader.eval_batches()):
            if k % size == r:
                yield k, self.loader._make_batch(idxs)

    def evaluate(self) -> Tuple[float, str]:
        chunks = []
        for k, batch in self._batches():
            boxes, probs, keep = (t.cpu().numpy() for t in self.detect_fn(
                torch.as_tensor(batch.images)))
            mask = keep & (probs > self.PROB_THRESH)
            bsel, psel, csel = np.nonzero(mask)
            scales = np.asarray(batch.scales, np.float64)[bsel]
            chunks.append((k, [batch.image_ids[b] for b in bsel],
                           boxes[bsel, psel, csel] / scales[:, None], csel,
                           probs[bsel, psel, csel]))
        if dp.world_size() > 1:
            # every rank's detections, in the one-process batch order
            chunks = sorted((c for part in dp.gather_objects(chunks)
                             for c in part), key=lambda c: c[0])
        id_chunks: List[List[str]] = [c[1] for c in chunks]
        box_chunks: List[np.ndarray] = [c[2] for c in chunks]
        cls_chunks: List[np.ndarray] = [c[3] for c in chunks]
        prob_chunks: List[np.ndarray] = [c[4] for c in chunks]
        gt = ground_truth(self.loader.samples)
        all_ids = [i for chunk in id_chunks for i in chunk]
        if not all_ids:
            return 0.0, "no detections"
        boxes_arr = np.concatenate(box_chunks).reshape(-1, 4)
        classes_arr = np.concatenate(cls_chunks)
        probs_arr = np.concatenate(prob_chunks)
        if self.protocol == "coco":
            res = coco_bbox_ap(self.num_classes,
                               {k: (b, lab) for k, (b, lab, _) in gt.items()},
                               all_ids, boxes_arr, classes_arr, probs_arr,
                               crowd=crowd_regions(self.loader.samples)
                               or None)
            return res["AP"], format_coco_summary(res)
        mean_ap, aps = evaluate_detections(
            self.num_classes, gt, all_ids, boxes_arr, classes_arr,
            probs_arr, use_07_metric=self.use_07)
        detail = "\n".join(f"{c:d}: AP = {ap:.4f}" for c, ap in aps.items())
        return mean_ap, detail
