"""Norm-ball projections — the PyTorch counterpart of
``afan/core/project.py``. Pure functions; nothing is updated in place."""
from __future__ import annotations

import numbers

import torch


def weak_scalar(value, dtype: torch.dtype):
    """A Python number as JAX's weak typing meets an array of ``dtype``:
    rounded to ``dtype`` first (``bf16(c - bf16(eps))``), where PyTorch
    would keep it in float32 (``bf16(c - eps)``). Tensors pass through."""
    if not isinstance(value, numbers.Real) or dtype == torch.float64:
        return value
    return torch.tensor(float(value), dtype=dtype).item()


def tensor_clamp(t: torch.Tensor, min: torch.Tensor, max: torch.Tensor
                 ) -> torch.Tensor:
    """Elementwise clamp of ``t`` into ``[min, max]`` (tensors)."""
    return torch.minimum(torch.maximum(t, min), max)


def linfball_proj(center: torch.Tensor, radius, t: torch.Tensor
                  ) -> torch.Tensor:
    """Project ``t`` onto the L-inf ball of ``radius`` around ``center``; a
    Python ``radius`` is rounded to ``center``'s dtype first, as in
    ``afan``."""
    radius = weak_scalar(radius, center.dtype)
    return tensor_clamp(t, center - radius, center + radius)


def l2ball_proj(center: torch.Tensor, radius, t: torch.Tensor
                ) -> torch.Tensor:
    """Per-sample radial projection of ``t`` onto the L2 ball of ``radius``
    around ``center`` (leading batch axis). A zero offset returns
    ``center``, where the reference's normalize-then-scale gives 0/0
    (`afan/core/project.py:36-48`)."""
    direction = t - center
    flat = direction.reshape(direction.shape[0], -1)
    dist = torch.linalg.vector_norm(flat, dim=1, keepdim=True)
    scale = torch.where(dist > radius, radius / dist.clamp_min(1e-12),
                        torch.ones_like(dist))
    return center + (flat * scale).reshape(direction.shape)
