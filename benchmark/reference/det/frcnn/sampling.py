"""Fixed-capacity foreground/background sampling — the PyTorch counterpart
of ``afan/models/frcnn/sampling.py``.

A fixed number of slots is filled with a validity mask: random priorities
and a top-k sample "up to K of the marked items" uniformly, as the
reference's ``randperm`` lists do (RPN: 256 anchors, at most 128 fg; ROI
head: 128 proposals, at most 32 fg). Sampling is per image, as in ``afan``.

The draw is split from the selection: :func:`draw_priorities` takes the two
uniform vectors from a generator, and :func:`select_fg_bg` is the
deterministic rest (top-k, compaction, fg-then-bg order), so that a test
can feed it ``afan``'s uniforms. Every function is batched over leading
axes; the candidate axis is the last.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from ..lowp import reduce_sum


class SampleResult(NamedTuple):
    indices: torch.Tensor  # (..., num_total) int64 into the candidate axis
    valid: torch.Tensor    # (..., num_total) bool: the slot is filled
    is_fg: torch.Tensor    # (..., num_total) bool: the slot holds a fg


Priorities = Tuple[torch.Tensor, torch.Tensor]


def draw_priorities(shape, generator: Optional[torch.Generator],
                    device=None) -> Priorities:
    """The fg and bg uniforms in [0, 1) of ``shape``, fg drawn first."""
    u_fg = torch.rand(shape, generator=generator, device=device)
    u_bg = torch.rand(shape, generator=generator, device=device)
    return u_fg, u_bg


def _top(pri: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the ``k`` largest along the last axis; ties keep the
    lower index first, as ``lax.top_k`` does."""
    return torch.sort(pri, dim=-1, descending=True, stable=True).indices[
        ..., :k]


def select_fg_bg(priorities: Priorities, fg_mask: torch.Tensor,
                 bg_mask: torch.Tensor, num_total: int, fg_cap: int
                 ) -> SampleResult:
    """Up to ``fg_cap`` foregrounds by priority, then backgrounds into the
    remaining of ``num_total`` slots; slots beyond the candidates are
    invalid (their indices stay in range)."""
    u_fg, u_bg = priorities
    n = fg_mask.shape[-1]
    neg = torch.tensor(float("-inf"), device=fg_mask.device)
    fg_idx = _top(torch.where(fg_mask, u_fg, neg), min(fg_cap, n))
    bg_idx = _top(torch.where(bg_mask, u_bg, neg), min(num_total, n))
    n_fg = fg_mask.sum(-1, keepdim=True).clamp(max=fg_cap)
    n_bg = torch.minimum(num_total - n_fg, bg_mask.sum(-1, keepdim=True))
    k_fg, k_bg = fg_idx.shape[-1], bg_idx.shape[-1]
    ar = torch.arange(max(k_fg, k_bg), device=fg_mask.device)
    take = torch.cat([ar[:k_fg] < n_fg, ar[:k_bg] < n_bg], dim=-1)
    idx = torch.cat([fg_idx, bg_idx], dim=-1)
    fg_flag = (torch.arange(k_fg + k_bg, device=fg_mask.device) < k_fg
               ).expand_as(take)
    # taken slots to the front, fg before bg
    order = torch.argsort((~take).to(torch.uint8), dim=-1,
                          stable=True)[..., :num_total]
    valid = torch.gather(take, -1, order)
    return SampleResult(indices=torch.gather(idx, -1, order), valid=valid,
                        is_fg=torch.gather(fg_flag, -1, order) & valid)


def sample_fg_bg(generator: Optional[torch.Generator], fg_mask: torch.Tensor,
                 bg_mask: torch.Tensor, num_total: int, fg_cap: int
                 ) -> SampleResult:
    """:func:`select_fg_bg` on priorities drawn from ``generator``."""
    return select_fg_bg(
        draw_priorities(fg_mask.shape, generator, fg_mask.device), fg_mask,
        bg_mask, num_total, fg_cap)


def gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The sampled rows ``x[b, idx[b, s]]``: x (B, N, k), idx (B, S) →
    (B, S, k)."""
    return torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[-1]))


def masked_mean(values: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Mean over the masked entries of the last axis; 0 where the mask is
    empty (the reference would give NaN on an empty foreground set). A
    bfloat16 ``values`` (the CE of bfloat16 logits) is summed in float32,
    rounded, then divided in bfloat16, as ``afan``'s ``jnp.sum(...) /
    count``."""
    denom = mask.sum(-1).clamp(min=1)
    return reduce_sum(torch.where(mask, values, torch.zeros_like(values)),
                      -1) / denom


def beta_smooth_l1(input: torch.Tensor, target: torch.Tensor, beta: float,
                   mask: torch.Tensor) -> torch.Tensor:
    """Masked beta smooth-L1 (`Detection/extension/functional.py:6-10`):
    rows ``(..., S, k)`` with a row mask ``(..., S)``; the elementwise
    Huber loss summed over the masked rows over their element count
    (+1e-8). A bfloat16 ``input`` meets float32 targets and the whole loss
    is float32, as in ``afan``."""
    diff = torch.abs(input - target)
    loss = torch.where(diff < beta, 0.5 * diff * diff / beta,
                       diff - 0.5 * beta)
    total = torch.where(mask[..., None], loss,
                        torch.zeros_like(loss)).sum((-2, -1))
    numel = mask.sum(-1) * input.shape[-1]
    return total / (numel + 1e-8)
