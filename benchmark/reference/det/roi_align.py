"""ROIAlign and ROI max-pooling — the PyTorch counterpart of
``afan/ops/roi_align.py``.

Features are NCHW ``(B, C, H, W)``; boxes are corner format in absolute
image coordinates; ``batch_indices`` maps each ROI to its image, or the boxes
come as ``(B, S, 4)``, S per image (:func:`roi_align_per_image`, what the
model pools); outputs are ``(R, C, ph, pw)``.

Semantics are those of ``afan``: the legacy non-aligned ROIAlign (no -0.5
offset, ROI sides at least 1) with a static ``sampling_ratio`` (2, where the
reference's adaptive grid would give a data-dependent shape), samples outside
(-1, extent) contribute 0.

On a bfloat16 feature (``--bf16``) the contractions keep ``afan``'s
rounding points (`afan/ops/roi_align.py:138-146`): both axis-weight
matrices are rounded to bfloat16, the contractions run in float32 on the
widened feature (``preferred_element_type=float32``), and the output is
rounded to bfloat16 once. A bfloat16 ``matmul`` would round the first
contraction's result too.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

ROI_CHUNK = 256   # ROIs per contraction: bounds the (r, ph, W, C) transient


def _axis_weights(lo: torch.Tensor, bin_size: torch.Tensor, n_bins: int,
                  s: int, axis_len: int, axis_idx: torch.Tensor
                  ) -> torch.Tensor:
    """Sample-averaged bilinear weights ``(R, n_bins, L)`` of feature lane
    ``axis_idx[r, l]`` (local index on this axis) for output bin i."""
    i = torch.arange(n_bins, dtype=lo.dtype, device=lo.device)
    j = (torch.arange(s, dtype=lo.dtype, device=lo.device) + 0.5) / s
    pos = lo[:, None, None] + (i[None, :, None] + j[None, None, :]) \
        * bin_size[:, None, None]
    oob = (pos < -1.0) | (pos > float(axis_len))
    pos_c = torch.clamp(pos, 0.0, float(axis_len - 1))
    w = torch.clamp(1.0 - torch.abs(pos_c[..., None]
                                    - axis_idx[:, None, None, :].to(lo.dtype)),
                    min=0.0)
    w = torch.where(oob[..., None], torch.zeros_like(w), w)
    return w.mean(dim=2)


def _feature_weights(w: torch.Tensor, feat: torch.Tensor) -> torch.Tensor:
    """Float32 weights as the contraction with ``feat`` takes them: rounded
    to ``feat``'s dtype first when that is below float32."""
    if feat.dtype in (torch.float32, torch.float64):
        return w
    return w.to(feat.dtype).to(torch.float32)


def roi_align_einsum(feat: torch.Tensor, boxes: torch.Tensor,
                     batch_indices: torch.Tensor,
                     output_size: Tuple[int, int] = (14, 14),
                     spatial_scale: float = 1.0 / 16,
                     sampling_ratio: int = 2) -> torch.Tensor:
    """ROIAlign as two dense contractions: ``Wy[r] @ feat[b_r] @ Wx[r]^T``
    with sample-averaged triangle weights. Images are concatenated along H
    and the y weights are evaluated at ``global_idx - b*H``, so rows of other
    images get weight 0 — one contraction for the whole batch. ROIs go in
    chunks of ``ROI_CHUNK`` to bound the ``(r, ph, W, C)`` intermediate."""
    ph, pw = output_size
    s = sampling_ratio
    B, C, H, W = feat.shape
    R = boxes.shape[0]
    f32 = torch.float32
    dev = feat.device

    x1 = boxes[:, 0].to(f32) * spatial_scale
    y1 = boxes[:, 1].to(f32) * spatial_scale
    x2 = boxes[:, 2].to(f32) * spatial_scale
    y2 = boxes[:, 3].to(f32) * spatial_scale
    bin_w = torch.clamp(x2 - x1, min=1.0) / pw
    bin_h = torch.clamp(y2 - y1, min=1.0) / ph

    gy = torch.arange(B * H, dtype=torch.int64, device=dev)[None, :] \
        - (batch_indices.to(torch.int64) * H)[:, None]      # (R, B*H)
    wy = _feature_weights(_axis_weights(y1, bin_h, ph, s, H, gy), feat)
    lx = torch.arange(W, dtype=torch.int64, device=dev)[None, :].expand(R, W)
    wx = _feature_weights(_axis_weights(x1, bin_w, pw, s, W, lx), feat)

    feat_cat = feat.to(f32).permute(0, 2, 3, 1).reshape(B * H, W, C)
    out = torch.empty((R, C, ph, pw), dtype=f32, device=dev)
    for lo in range(0, R, ROI_CHUNK):
        hi = min(lo + ROI_CHUNK, R)
        # contract H first (the larger axis), then W
        t = torch.einsum("rhH,HWc->rhWc", wy[lo:hi], feat_cat)
        out[lo:hi] = torch.einsum("rhWc,rwW->rchw", t, wx[lo:hi])
    return out.to(feat.dtype)


def roi_align_per_image(feat: torch.Tensor, boxes: torch.Tensor,
                        output_size: Tuple[int, int] = (14, 14),
                        spatial_scale: float = 1.0 / 16,
                        sampling_ratio: int = 2) -> torch.Tensor:
    """:func:`roi_align_einsum` for boxes ``(B, S, 4)``, image b's S ROIs
    first → ``(B*S, C, ph, pw)``: each image's ROIs are contracted against
    that image's rows only, a B-fold smaller first contraction than the
    concatenated one. The second contraction is a batched matmul over
    (ROI, output row) that reads the ``(ROI, ph, W, C)`` intermediate in
    place; the result is a view in channels-last order."""
    ph, pw = output_size
    s = sampling_ratio
    B, C, H, W = feat.shape
    S = boxes.shape[1]
    f32 = torch.float32
    dev = feat.device
    flat = boxes.reshape(-1, 4).to(f32) * spatial_scale
    x1, y1, x2, y2 = flat.unbind(1)
    bin_w = torch.clamp(x2 - x1, min=1.0) / pw
    bin_h = torch.clamp(y2 - y1, min=1.0) / ph
    ly = torch.arange(H, dtype=torch.int64, device=dev).expand(B * S, H)
    lx = torch.arange(W, dtype=torch.int64, device=dev).expand(B * S, W)
    wy = _feature_weights(_axis_weights(y1, bin_h, ph, s, H, ly),
                          feat).reshape(B, S * ph, H)
    wx = _feature_weights(_axis_weights(x1, bin_w, pw, s, W, lx),
                          feat).reshape(B, S, 1, pw, W)
    rows = feat.to(f32).permute(0, 2, 3, 1).reshape(B, H, W * C)
    out = torch.empty((B, S, ph, pw, C), dtype=f32, device=dev)
    step = max(1, ROI_CHUNK // B)
    for lo in range(0, S, step):
        hi = min(lo + step, S)
        t = torch.matmul(wy[:, lo * ph:hi * ph], rows)     # (B, s*ph, W*C)
        out[:, lo:hi] = torch.matmul(wx[:, lo:hi],
                                     t.reshape(B, hi - lo, ph, W, C))
    return out.reshape(B * S, ph, pw, C).permute(0, 3, 1, 2).to(feat.dtype)


def _bilinear_gather(feat_nhwc: torch.Tensor, batch_idx: torch.Tensor,
                     y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Sample ``feat_nhwc`` (B,H,W,C) at fractional (y, x) ``(R, P)`` →
    ``(R, P, C)``; samples outside (-1, extent) give 0."""
    H, W = feat_nhwc.shape[1], feat_nhwc.shape[2]
    oob = (y < -1.0) | (y > H) | (x < -1.0) | (x > W)
    y = torch.clamp(y, 0.0, H - 1)
    x = torch.clamp(x, 0.0, W - 1)
    y0f, x0f = torch.floor(y), torch.floor(x)
    y0, x0 = y0f.long(), x0f.long()
    y1 = torch.clamp(y0 + 1, max=H - 1)
    x1 = torch.clamp(x0 + 1, max=W - 1)
    ly = (y - y0f)[..., None]
    lx = (x - x0f)[..., None]
    hy, hx = 1.0 - ly, 1.0 - lx
    b = batch_idx.long()[:, None]
    v00 = feat_nhwc[b, y0, x0]
    v01 = feat_nhwc[b, y0, x1]
    v10 = feat_nhwc[b, y1, x0]
    v11 = feat_nhwc[b, y1, x1]
    out = hy * hx * v00 + hy * lx * v01 + ly * hx * v10 + ly * lx * v11
    return torch.where(oob[..., None], torch.zeros_like(out), out)


def roi_align_gather(feat: torch.Tensor, boxes: torch.Tensor,
                     batch_indices: torch.Tensor,
                     output_size: Tuple[int, int] = (14, 14),
                     spatial_scale: float = 1.0 / 16,
                     sampling_ratio: int = 2) -> torch.Tensor:
    """ROIAlign, gather formulation: the semantics oracle of
    :func:`roi_align_einsum`."""
    ph, pw = output_size
    s = sampling_ratio
    dev = feat.device
    feat_nhwc = feat.permute(0, 2, 3, 1)
    r = boxes.shape[0]
    x1 = boxes[:, 0] * spatial_scale
    y1 = boxes[:, 1] * spatial_scale
    x2 = boxes[:, 2] * spatial_scale
    y2 = boxes[:, 3] * spatial_scale
    bin_w = torch.clamp(x2 - x1, min=1.0) / pw
    bin_h = torch.clamp(y2 - y1, min=1.0) / ph
    sub = (torch.arange(s, device=dev)[None, :] + 0.5) / s
    iy = (torch.arange(ph, device=dev)[:, None] + sub).reshape(-1)
    ix = (torch.arange(pw, device=dev)[:, None] + sub).reshape(-1)
    ys = y1[:, None] + iy[None, :] * bin_h[:, None]          # (r, ph*s)
    xs = x1[:, None] + ix[None, :] * bin_w[:, None]          # (r, pw*s)
    yy = torch.repeat_interleave(ys, pw * s, dim=1)
    xx = xs.repeat(1, ph * s)
    vals = _bilinear_gather(feat_nhwc, batch_indices, yy, xx)
    vals = vals.reshape(r, ph, s, pw, s, -1).mean(dim=(2, 4))
    return vals.permute(0, 3, 1, 2)


def roi_pool_max(feat: torch.Tensor, boxes: torch.Tensor,
                 batch_indices: torch.Tensor,
                 output_size: Tuple[int, int] = (7, 7),
                 spatial_scale: float = 1.0 / 16,
                 samples: int = 12) -> torch.Tensor:
    """The legacy POOLING mode: integer crop of the ROI (round + clamp of the
    scaled corners), then adaptive max pooling to ``output_size`` over a
    static grid of ``samples`` x ``samples`` nearest taps per bin."""
    ph, pw = output_size
    K = samples
    H, W = feat.shape[2], feat.shape[3]
    dev = feat.device

    def axis_positions(lo, size, n_bins):
        i = torch.arange(n_bins, dtype=torch.float32, device=dev)
        bs = torch.floor(i[None, :] * size[:, None] / n_bins + 1e-3)
        be = torch.ceil((i[None, :] + 1.0) * size[:, None] / n_bins - 1e-3)
        t = (torch.arange(K, dtype=torch.float32, device=dev) + 0.5) / K
        pos = bs[:, :, None] + t[None, None, :] * (be - bs)[:, :, None]
        idx = torch.minimum(torch.floor(pos), (be - 1.0)[:, :, None])
        return (lo[:, None, None] + idx).reshape(idx.shape[0], -1)

    x1 = torch.clamp(torch.round(boxes[:, 0] * spatial_scale), 0, W)
    y1 = torch.clamp(torch.round(boxes[:, 1] * spatial_scale), 0, H)
    x2 = torch.clamp(torch.round(boxes[:, 2] * spatial_scale), 0, W)
    y2 = torch.clamp(torch.round(boxes[:, 3] * spatial_scale), 0, H)
    w = torch.clamp(x2 - x1, min=1.0)
    h = torch.clamp(y2 - y1, min=1.0)
    yi = torch.clamp(axis_positions(y1, h, ph).long(), 0, H - 1)
    xi = torch.clamp(axis_positions(x1, w, pw).long(), 0, W - 1)
    feat_nhwc = feat.permute(0, 2, 3, 1)
    b = batch_indices.long()[:, None, None]
    vals = feat_nhwc[b, yi[:, :, None], xi[:, None, :]]   # (R, ph*K, pw*K, C)
    r = boxes.shape[0]
    vals = vals.reshape(r, ph, K, pw, K, -1).amax(dim=(2, 4))
    return vals.permute(0, 3, 1, 2)


def _max_pool_2x2(x: torch.Tensor) -> torch.Tensor:
    """2x2/2 max pool of ``(R, C, 2h, 2w)``. Its gradient splits evenly
    among tied maxima (``amax``'s, as ``afan``'s ``jnp.max``), where
    ``max_pool2d`` would send it all to one: ReLU zeros under a whole
    bin tie, and the SE ascent at layer 3 reads that gradient."""
    r, c, h, w = x.shape
    return x.reshape(r, c, h // 2, 2, w // 2, 2).amax(dim=(3, 5))


def pool_rois(feat: torch.Tensor, boxes: torch.Tensor,
              batch_indices: Optional[torch.Tensor] = None,
              mode: str = "align") -> torch.Tensor:
    """The reference Pooler: ALIGN = ROIAlign 14x14 at scale 1/16, then 2x2
    max pool → ``(R, C, 7, 7)``; POOLING = :func:`roi_pool_max`. Without
    ``batch_indices`` the boxes are ``(B, S, 4)``, S per image."""
    if mode not in ("align", "pooling"):
        raise ValueError(f"unknown pooler mode {mode!r}")
    if batch_indices is None and mode == "align":
        return _max_pool_2x2(roi_align_per_image(feat, boxes, (14, 14),
                                                 1.0 / 16, 2))
    if batch_indices is None:
        batch_indices = torch.arange(
            boxes.shape[0], device=boxes.device).repeat_interleave(
                boxes.shape[1])
        boxes = boxes.reshape(-1, 4)
    if mode == "pooling":
        return roi_pool_max(feat, boxes, batch_indices, (7, 7), 1.0 / 16)
    return _max_pool_2x2(roi_align_einsum(feat, boxes, batch_indices,
                                          (14, 14), 1.0 / 16, 2))
