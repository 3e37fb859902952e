"""Fixed-capacity greedy NMS — the PyTorch counterpart of ``afan/ops/nms.py``.

Every function returns static shapes (a keep mask per input slot, or the
first ``max_output_size`` kept boxes padded), so the detect path has no
host sync and no data-dependent shape. All of them take optional leading
batch dimensions: boxes ``(..., N, 4)`` and scores ``(..., N)``; the groups
go to the kernel in one launch.

The keep mask itself comes from :func:`afan_torch.ops.kernels.nms.
nms_sorted_mask`: the CUDA kernel on a CUDA tensor, for every N, and
:func:`nms_sorted_mask_plain` (pairwise IoU, then the blockwise greedy
suppression of ``afan``) on a CPU tensor.

IoU convention: legacy "+1 pixel" areas via ``plus_one``; suppression is
``iou >= threshold``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

import numpy as np

BLOCK = 128


def pairwise_iou(a: torch.Tensor, b: torch.Tensor, plus_one: bool = False
                 ) -> torch.Tensor:
    """IoU matrix ``(..., Na, Nb)`` of corner boxes ``(..., Na, 4)``,
    ``(..., Nb, 4)`` [x1, y1, x2, y2]."""
    off = 1.0 if plus_one else 0.0
    area_a = (a[..., 2] - a[..., 0] + off) * (a[..., 3] - a[..., 1] + off)
    area_b = (b[..., 2] - b[..., 0] + off) * (b[..., 3] - b[..., 1] + off)
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = torch.clamp(rb - lt + off, min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = area_a[..., :, None] + area_b[..., None, :] - inter
    return inter / torch.clamp(union, min=1e-12)


def _greedy_suppress(iou_sorted: torch.Tensor, valid_sorted: torch.Tensor,
                     threshold: float) -> torch.Tensor:
    """Keep mask (sorted order) of exact greedy NMS given the IoU matrices
    ``(..., N, N)`` of score-sorted boxes: blockwise, as in ``afan`` — a
    sequential pass within each ``BLOCK`` tile, then one vectorized
    suppression of all later boxes by the tile's keepers."""
    n = iou_sorted.shape[-1]
    thr = torch.tensor(threshold, dtype=iou_sorted.dtype,
                       device=iou_sorted.device)
    sup_mat = iou_sorted >= thr
    suppressed = ~valid_sorted   # invalid slots start suppressed
    for start in range(0, n, BLOCK):
        end = min(start + BLOCK, n)
        tile = sup_mat[..., start:end, start:end]
        sup = suppressed[..., start:end].clone()
        for i in range(end - start - 1):
            kept_i = ~sup[..., i]
            sup[..., i + 1:] |= kept_i[..., None] & tile[..., i, i + 1:]
        suppressed[..., start:end] = sup
        if end < n:
            hit = (sup_mat[..., start:end, end:] & ~sup[..., :, None]).any(-2)
            suppressed[..., end:] |= hit
    return ~suppressed & valid_sorted


def nms_sorted_mask_plain(boxes_sorted: torch.Tensor,
                          valid_sorted: torch.Tensor, threshold: float,
                          plus_one: bool = True) -> torch.Tensor:
    """The plain version of the NMS kernel: same inputs, same keep mask."""
    iou = pairwise_iou(boxes_sorted, boxes_sorted, plus_one=plus_one)
    return _greedy_suppress(iou, valid_sorted, threshold)


def _as_groups(boxes: torch.Tensor, valid: Optional[torch.Tensor]):
    """(..., N, 4) boxes + optional (..., N) valid → contiguous (G, N, 4) f32
    boxes, (G, N) bool valid, and the leading shape."""
    lead = boxes.shape[:-2]
    n = boxes.shape[-2]
    b = boxes.reshape(-1, n, 4).to(torch.float32).contiguous()
    if valid is None:
        v = torch.ones(b.shape[:2], dtype=torch.bool, device=boxes.device)
    else:
        v = valid.reshape(-1, n).to(torch.bool).contiguous()
    return b, v, lead


def nms_mask_presorted(boxes_sorted: torch.Tensor, threshold: float,
                       valid_sorted: Optional[torch.Tensor] = None,
                       plus_one: bool = True) -> torch.Tensor:
    """Keep mask for boxes already in score-descending order."""
    b, v, lead = _as_groups(boxes_sorted, valid_sorted)
    keep = nms_sorted_mask(b, v, threshold, plus_one)
    return keep.reshape(*lead, b.shape[1])


def nms_mask(boxes: torch.Tensor, scores: torch.Tensor, threshold: float,
             valid: Optional[torch.Tensor] = None, plus_one: bool = True
             ) -> torch.Tensor:
    """Exact greedy NMS; returns a keep mask aligned with the INPUT order.
    Ties in score keep the lower index first, as ``jnp.argsort`` does."""
    b, v, lead = _as_groups(boxes, valid)
    s = scores.reshape(b.shape[:2])
    key = torch.where(v, -s, torch.full_like(s, float("inf")))
    order = torch.argsort(key, dim=-1, stable=True)
    b_sorted = torch.gather(b, 1, order[..., None].expand(-1, -1, 4))
    keep_sorted = nms_sorted_mask(b_sorted.contiguous(),
                                  torch.gather(v, 1, order).contiguous(),
                                  threshold, plus_one)
    keep = torch.zeros_like(keep_sorted).scatter_(1, order, keep_sorted)
    return keep.reshape(*lead, b.shape[1])


def nms_select_presorted(boxes_sorted: torch.Tensor, threshold: float,
                         max_output_size: int, plus_one: bool = True,
                         valid_sorted: Optional[torch.Tensor] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """NMS on score-sorted boxes → the first ``max_output_size`` kept boxes
    (still score-sorted, zero-padded) and their validity mask.

    Each kept box's rank is a cumsum over the keep mask; boxes scatter into
    ``max_output_size + 1`` slots, the last a dump slot for the overflow."""
    b, v, lead = _as_groups(boxes_sorted, valid_sorted)
    keep = nms_sorted_mask(b, v, threshold, plus_one)
    k = max_output_size
    rank = torch.cumsum(keep.to(torch.int64), dim=-1) - 1
    sel = keep & (rank < k)
    tgt = torch.where(sel, rank, torch.full_like(rank, k))
    out = torch.zeros((b.shape[0], k + 1, 4), dtype=boxes_sorted.dtype,
                      device=b.device)
    out.scatter_(1, tgt[..., None].expand(-1, -1, 4),
                 b.to(boxes_sorted.dtype))
    valid = torch.zeros((b.shape[0], k + 1), dtype=torch.bool,
                        device=b.device).scatter_(1, tgt, sel)
    return (out[:, :k].reshape(*lead, k, 4), valid[:, :k].reshape(*lead, k))


def nms_padded(boxes: torch.Tensor, scores: torch.Tensor, threshold: float,
               max_output_size: int, valid: Optional[torch.Tensor] = None,
               plus_one: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """NMS with fixed-size output: ``(indices (..., K), mask (..., K))`` —
    score-descending kept indices, padded with -1."""
    keep = nms_mask(boxes, scores, threshold, valid=valid, plus_one=plus_one)
    masked = torch.where(keep, scores.to(torch.float32),
                         torch.full_like(scores, float("-inf"),
                                         dtype=torch.float32))
    k = min(max_output_size, boxes.shape[-2])
    top, idx = torch.sort(masked, dim=-1, descending=True, stable=True)
    top, idx = top[..., :k], idx[..., :k]
    mask = top > float("-inf")
    idx = torch.where(mask, idx, torch.full_like(idx, -1))
    if k < max_output_size:
        pad = max_output_size - k
        idx = torch.nn.functional.pad(idx, (0, pad), value=-1)
        mask = torch.nn.functional.pad(mask, (0, pad), value=False)
    return idx, mask


def nms_sorted_mask(boxes: torch.Tensor, valid: torch.Tensor,
                    threshold: float, plus_one: bool = True) -> torch.Tensor:
    """The keep mask of groups ``(G, N, 4)`` of score-sorted boxes, as the
    kernel computes it: the IoU test on the device, the greedy pass on the
    host (a valid box is kept unless an earlier kept box hits it). On
    ``meta`` tensors every valid box is kept."""
    if boxes.device.type == "meta":
        return valid.clone()
    ok = valid.cpu().numpy()
    keep = np.zeros_like(ok)
    for g in range(ok.shape[0]):         # one group's IoU matrix at a time
        hits = (pairwise_iou(boxes[g], boxes[g], plus_one=plus_one)
                >= threshold).cpu().numpy()
        suppressed = ~ok[g]
        for i in range(hits.shape[0]):
            if not suppressed[i]:
                keep[g, i] = True
                suppressed |= hits[i]
    return torch.from_numpy(keep).to(boxes.device)
