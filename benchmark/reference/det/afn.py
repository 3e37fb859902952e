"""AFN, adversarial feature normalization ("mix_feature") — the PyTorch
counterpart of ``afan/core/afn.py``.

The statistics are taken over the channel axis (per sample and spatial
position, not per channel), with the unbiased variance (ddof 1) and eps
1e-5. The port's activations are NCHW, so the channel axis is 1 (``afan``'s
NHWC uses -1).

Under bfloat16 the statistics follow ``jnp.mean`` / ``jnp.var``: reduced
in float32 and returned in bfloat16; eps meets them as a weak-typed scalar
(rounded to bfloat16), and the rest is bfloat16 arithmetic, each op
rounded, as in ``afan``.
"""
from __future__ import annotations

from typing import Sequence

import torch

from .project import weak_scalar

_EPS = 1e-5


def _stats(feature: torch.Tensor, channel_axis: int):
    """(var, mean) over ``channel_axis`` with ddof 1, reduced in float32
    (float64 stays float64) and returned in ``feature``'s dtype."""
    wide = feature if feature.dtype == torch.float64 else feature.float()
    var, mean = torch.var_mean(wide, dim=channel_axis, correction=1,
                               keepdim=True)
    return var.to(feature.dtype), mean.to(feature.dtype)


def mix_feature(clean_feature: torch.Tensor, adv_feature: torch.Tensor,
                channel_axis: int = 1) -> torch.Tensor:
    """``(clean - mu_cl) / sigma_cl * sigma_adv + mu_adv``."""
    var_cl, mean_cl = _stats(clean_feature, channel_axis)
    var_adv, mean_adv = _stats(adv_feature, channel_axis)
    eps = weak_scalar(_EPS, clean_feature.dtype)
    normalized = (clean_feature - mean_cl) / torch.sqrt(var_cl + eps)
    return normalized * torch.sqrt(var_adv + eps) + mean_adv


def mix_spectrum(clean_feature: torch.Tensor, spectrum: torch.Tensor,
                 mask: Sequence[int], channel_axis: int = 1) -> torch.Tensor:
    """AFN on the points of a stacked spectrum ``(N, ...)`` whose ``mask``
    entry is set (the reference's ``mix_layer`` string)."""
    return torch.stack([
        mix_feature(clean_feature, spectrum[i], channel_axis) if mask[i]
        else spectrum[i] for i in range(spectrum.shape[0])])
