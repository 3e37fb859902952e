"""Means and softmaxes at ``afan``'s rounding points below float32.

Under ``--bf16`` ``afan``'s losses are ``jax.numpy`` and ``jax.nn`` code on
bfloat16 arrays: each elementwise op rounds to bfloat16, and a sum or mean
accumulates in float32 and rounds once (``jnp.sum`` / ``jnp.mean`` upcast
half-precision inputs). Inside ``afan``'s jitted steps XLA also drops a
rounding to bfloat16 that is followed at once by a widening to float32
(excess precision): the ``exp`` that feeds a sum is summed unrounded.
PyTorch's fused ``log_softmax``, ``softmax`` and ``cross_entropy`` on
bfloat16 round only their result. The functions here spell ``afan``'s
formulas out on a bfloat16 tensor, so that each op rounds where the jitted
JAX op does (within the last bit of the two libraries' float32 ``exp``),
and stay PyTorch's fused ops on float32 and float64.
"""
from __future__ import annotations

import torch

_WIDE = (torch.float32, torch.float64)


def mean(x: torch.Tensor, dim=None) -> torch.Tensor:
    """``jnp.mean``: the float32 mean of a narrower ``x``, rounded once to
    ``x``'s dtype."""
    if x.dtype in _WIDE:
        return x.mean() if dim is None else x.mean(dim)
    wide = x.float()
    return (wide.mean() if dim is None else wide.mean(dim)).to(x.dtype)


def reduce_sum(x: torch.Tensor, dim, keepdim: bool = False) -> torch.Tensor:
    """``jnp.sum``: the float32 sum of a narrower ``x``, rounded once to
    ``x``'s dtype."""
    if x.dtype in _WIDE:
        return x.sum(dim, keepdim=keepdim)
    return x.sum(dim, keepdim=keepdim, dtype=torch.float32).to(x.dtype)


def _sum_exp(shifted: torch.Tensor, dim: int) -> torch.Tensor:
    """``jnp.sum(jnp.exp(shifted), keepdims=True)`` as jitted: the float32
    ``exp`` summed unrounded, the sum rounded to ``shifted``'s dtype."""
    return torch.exp(shifted.float()).sum(dim, keepdim=True).to(
        shifted.dtype)


def log_softmax(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """``jax.nn.log_softmax``: ``shifted - log(sum(exp(shifted)))`` with
    ``shifted = x - max(x)`` (the max without a gradient)."""
    if x.dtype in _WIDE:
        return torch.log_softmax(x, dim)
    shifted = x - x.detach().amax(dim, keepdim=True)
    return shifted - torch.log(_sum_exp(shifted, dim))


def softmax(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """``jax.nn.softmax``: ``exp(x - max(x)) / sum(exp(x - max(x)))``, the
    numerator rounded, the sum over the unrounded ``exp``."""
    if x.dtype in _WIDE:
        return torch.softmax(x, dim)
    shifted = x - x.detach().amax(dim, keepdim=True)
    return torch.exp(shifted) / _sum_exp(shifted, dim)


def logsumexp(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """``jax.nn.logsumexp`` over ``dim`` (dropped): ``log(sum(exp(x - m))) +
    m``, ``m`` the max without a gradient (0 where it is not finite)."""
    if x.dtype in _WIDE:
        return torch.logsumexp(x, dim)
    m = x.detach().amax(dim, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    return (torch.log(_sum_exp(x - m, dim)) + m).squeeze(dim)
