"""COCO-protocol bbox AP/AR — a numpy copy of ``afan/eval/coco_map.py``
(``coco_eval_summary``, ``coco_bbox_ap``, ``format_coco_summary``), the
self-contained form of the COCOeval bbox summary the reference prints
(`Detection/dataset/coco2017.py:160-171`; pycocotools is not used):

* IoU thresholds 0.50:0.95:0.05 (10 levels);
* per image/class, score-descending greedy matching; gt outside the
  current area range are *ignored* (a det matched to an ignored gt is
  neither TP nor FP; an unmatched det whose own area is outside the range
  is ignored too); crowd gt are ignore regions matched by intersection over
  the detection's area, and may absorb any number of detections;
* precision accumulated on the standard 101-point recall grid [0:0.01:1]
  with the monotone precision envelope; AP = mean over classes (with >=1
  non-ignored gt) and IoU thresholds;
* AR = mean over classes/thresholds of the max recall at a detection cap;
* the 12 summary metrics: AP, AP50, AP75, AP small/medium/large
  (areas <32^2 / 32^2..96^2 / >96^2, maxDets 100) and AR@1/10/100 +
  AR small/medium/large (maxDets 100).
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

IOU_THRESHOLDS = np.arange(0.5, 1.0, 0.05)
RECALL_GRID = np.linspace(0.0, 1.0, 101)
MAX_DETS = 100

AREA_RANGES = {
    "all": (0.0, 1e10),
    "small": (0.0, 32.0 ** 2),
    "medium": (32.0 ** 2, 96.0 ** 2),
    "large": (96.0 ** 2, 1e10),
}

_SUMMARY_ROWS = [
    ("AP", "Average Precision", "0.50:0.95", "all", 100),
    ("AP50", "Average Precision", "0.50", "all", 100),
    ("AP75", "Average Precision", "0.75", "all", 100),
    ("APs", "Average Precision", "0.50:0.95", "small", 100),
    ("APm", "Average Precision", "0.50:0.95", "medium", 100),
    ("APl", "Average Precision", "0.50:0.95", "large", 100),
    ("AR1", "Average Recall", "0.50:0.95", "all", 1),
    ("AR10", "Average Recall", "0.50:0.95", "all", 10),
    ("AR100", "Average Recall", "0.50:0.95", "all", 100),
    ("ARs", "Average Recall", "0.50:0.95", "small", 100),
    ("ARm", "Average Recall", "0.50:0.95", "medium", 100),
    ("ARl", "Average Recall", "0.50:0.95", "large", 100),
]


def _area(boxes: np.ndarray) -> np.ndarray:
    return np.clip(boxes[:, 2] - boxes[:, 0], 0, None) * \
        np.clip(boxes[:, 3] - boxes[:, 1], 0, None)


def _iou_matrix(d: np.ndarray, g: np.ndarray) -> np.ndarray:
    """Standard (no +1) corner IoU, (D, G)."""
    area_d = _area(d)
    area_g = _area(g)
    lt = np.maximum(d[:, None, :2], g[None, :, :2])
    rb = np.minimum(d[:, None, 2:], g[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    return inter / np.maximum(area_d[:, None] + area_g[None, :] - inter,
                              1e-12)


def _match_image(det_boxes, det_scores, gt_boxes, gt_ignore, thresholds,
                 max_dets, area_rng, gt_crowd=None):
    """COCOeval evaluateImg matching for one (image, class, area range).

    gts are ordered non-ignored first (COCOeval sorts by _ignore); each
    det takes the unmatched gt of highest IoU >= t, falling back to an
    ignored gt only when no valid gt qualifies. Crowd gt (iscrowd — always
    ignored) use the crowd-modified IoU inter/area_det and, unlike normal
    gt, may absorb any number of detections (pycocotools: a matched gt is
    skipped only when ``not iscrowd``). Returns (tp, dt_ig, sorted_scores)
    each (T, D<=max_dets) / (D,).
    """
    order = np.argsort(-det_scores, kind="stable")[:max_dets]
    d = det_boxes[order]
    scores = det_scores[order]
    if gt_crowd is None:
        gt_crowd = np.zeros(len(gt_boxes), bool)
    g_order = np.argsort(gt_ignore, kind="stable")
    g = gt_boxes[g_order]
    g_ig = gt_ignore[g_order]
    g_cr = gt_crowd[g_order]
    T, D, G = len(thresholds), len(d), len(g)
    tp = np.zeros((T, D), bool)
    dt_ig = np.zeros((T, D), bool)
    if D == 0:
        return tp, dt_ig, scores
    d_out = ~_in_range_mask(_area(d), area_rng)
    if G == 0:
        dt_ig[:] = d_out[None, :]
        return tp, dt_ig, scores
    ious = _iou_matrix(d, g)
    if g_cr.any():
        # crowd-modified IoU (maskUtils.iou with iscrowd=1): intersection
        # over the DETECTION's area — a det fully inside a big crowd
        # region scores 1.0 regardless of the crowd's size
        lt = np.maximum(d[:, None, :2], g[None, :, :2])
        rb = np.minimum(d[:, None, 2:], g[None, :, 2:])
        wh = np.clip(rb - lt, 0, None)
        inter = wh[..., 0] * wh[..., 1]
        crowd_iou = inter / np.maximum(_area(d)[:, None], 1e-12)
        ious = np.where(g_cr[None, :], crowd_iou, ious)
    for ti, t in enumerate(thresholds):
        taken = np.zeros(G, bool)
        for di in range(D):
            best, best_iou = -1, min(t, 1 - 1e-10)
            for gi in range(G):
                if taken[gi] and not g_cr[gi]:
                    continue
                # gts sorted valid-first: once we hold a valid match,
                # ignored gts can't improve it
                if best > -1 and not g_ig[best] and g_ig[gi]:
                    break
                if ious[di, gi] < best_iou:
                    continue
                best, best_iou = gi, ious[di, gi]
            if best >= 0:
                taken[best] = True
                tp[ti, di] = not g_ig[best]
                dt_ig[ti, di] = bool(g_ig[best])
            else:
                dt_ig[ti, di] = d_out[di]
    return tp, dt_ig, scores


def _in_range_mask(areas: np.ndarray, rng: Tuple[float, float]):
    return (areas >= rng[0]) & (areas <= rng[1])


def coco_eval_summary(num_classes: int,
                      gt: Dict[str, Tuple[np.ndarray, np.ndarray]],
                      det_image_ids: List[str], det_boxes: np.ndarray,
                      det_classes: np.ndarray, det_probs: np.ndarray,
                      crowd: Dict[str, Tuple[np.ndarray, np.ndarray]] = None
                      ) -> Dict[str, float]:
    """Full 12-metric COCO bbox summary over classes 1..num_classes-1.

    ``gt``: image_id → (boxes (G,4) corners, labels (G,)).
    ``crowd``: optional image_id → (boxes, labels) of iscrowd gt — ignore
    regions per COCOeval (never in npos; dets over them are neither TP
    nor FP).
    """
    det_classes = np.asarray(det_classes)
    det_probs = np.asarray(det_probs)
    det_boxes = np.asarray(det_boxes).reshape(-1, 4)
    det_image_ids = np.asarray(det_image_ids)
    T = len(IOU_THRESHOLDS)

    # accumulate once per (area, class): tp/ig/scores at maxDets=100, then
    # slice smaller maxDets from the per-image score-ordered lists
    results: Dict[str, float] = {}
    per_area: Dict[str, Dict[int, list]] = {}
    for area_name, area_rng in AREA_RANGES.items():
        per_class = {}
        for c in range(1, num_classes):
            class_sel = det_classes == c
            records = []   # (tp (T,D), ig (T,D), scores (D,)) per image
            npos = 0
            for image_id, (g_boxes, g_labels) in gt.items():
                g = g_boxes[g_labels == c]
                g_cr = np.zeros(len(g), bool)
                if crowd is not None and image_id in crowd:
                    cb, cl = crowd[image_id]
                    cg = np.asarray(cb).reshape(-1, 4)[np.asarray(cl) == c]
                    if len(cg):
                        g = np.concatenate([g.reshape(-1, 4), cg])
                        g_cr = np.concatenate(
                            [g_cr, np.ones(len(cg), bool)])
                g_ig = (~_in_range_mask(_area(g), area_rng) | g_cr) \
                    if len(g) else np.zeros(0, bool)
                npos += int((~g_ig).sum())
                sel = class_sel & (det_image_ids == image_id)
                if not sel.any():
                    continue
                records.append(_match_image(det_boxes[sel], det_probs[sel],
                                            g, g_ig, IOU_THRESHOLDS,
                                            MAX_DETS, area_rng, g_cr))
            per_class[c] = (records, npos)
        per_area[area_name] = per_class

    def accumulate(area_name: str, max_dets: int):
        """(ap (C,T) or None, ar (C,T) or None) for classes with gt."""
        ap_rows, ar_rows = [], []
        for c, (records, npos) in per_area[area_name].items():
            if npos == 0:
                continue  # COCOeval skips classes absent from gt (-1)
            if not records:
                ap_rows.append(np.zeros(T))
                ar_rows.append(np.zeros(T))
                continue
            tps = np.concatenate([r[0][:, :max_dets] for r in records], 1)
            igs = np.concatenate([r[1][:, :max_dets] for r in records], 1)
            scores = np.concatenate([r[2][:max_dets] for r in records])
            order = np.argsort(-scores, kind="stable")
            tps, igs = tps[:, order], igs[:, order]
            ap_t = np.zeros(T)
            ar_t = np.zeros(T)
            for ti in range(T):
                keep = ~igs[ti]
                tp_row = tps[ti][keep]
                tp_cum = np.cumsum(tp_row)
                fp_cum = np.cumsum(~tp_row)
                rec = tp_cum / npos
                prec = tp_cum / np.maximum(tp_cum + fp_cum, 1e-12)
                ar_t[ti] = rec[-1] if len(rec) else 0.0
                p = prec.copy()
                for i in range(len(p) - 1, 0, -1):
                    p[i - 1] = max(p[i - 1], p[i])
                idx = np.searchsorted(rec, RECALL_GRID, side="left")
                vals = np.where(idx < len(p),
                                p[np.minimum(idx, max(len(p) - 1, 0))]
                                if len(p) else 0.0, 0.0)
                ap_t[ti] = vals.mean()
            ap_rows.append(ap_t)
            ar_rows.append(ar_t)
        if not ap_rows:
            return None, None
        return np.stack(ap_rows), np.stack(ar_rows)

    for key, kind, iou, area, mdet in _SUMMARY_ROWS:
        ap, ar = accumulate(area, mdet)
        if ap is None:
            results[key] = -1.0  # COCOeval prints -1 when no gt in range
            continue
        mat = ap if kind == "Average Precision" else ar
        if iou == "0.50":
            results[key] = float(mat[:, 0].mean())
        elif iou == "0.75":
            results[key] = float(mat[:, 5].mean())
        else:
            results[key] = float(mat.mean())
    return results


def format_coco_summary(res: Dict[str, float]) -> str:
    """The familiar 12-line COCOeval summarize() block."""
    lines = []
    for key, kind, iou, area, mdet in _SUMMARY_ROWS:
        lines.append(
            f" {kind:<18} (AP) @[ IoU={iou:<9} | area={area:>6} | "
            f"maxDets={mdet:>3} ] = {res[key]:0.3f}"
            if kind == "Average Precision" else
            f" {kind:<18} (AR) @[ IoU={iou:<9} | area={area:>6} | "
            f"maxDets={mdet:>3} ] = {res[key]:0.3f}")
    return "\n".join(lines)


def coco_bbox_ap(num_classes: int,
                 gt: Dict[str, Tuple[np.ndarray, np.ndarray]],
                 det_image_ids: List[str], det_boxes: np.ndarray,
                 det_classes: np.ndarray, det_probs: np.ndarray,
                 crowd: Dict[str, Tuple[np.ndarray, np.ndarray]] = None
                 ) -> Dict[str, float]:
    """Back-compat wrapper: the full summary dict (superset of the old
    {'AP','AP50','AP75'} result)."""
    res = coco_eval_summary(num_classes, gt, det_image_ids, det_boxes,
                            det_classes, det_probs, crowd=crowd)
    if res["AP"] < 0:
        return {k: 0.0 if v < 0 else v for k, v in res.items()}
    return res
