"""AFN, adversarial feature normalization ("mix_feature") — the PyTorch
counterpart of ``afan/core/afn.py``.

The statistics are taken over the channel axis (per sample and spatial
position, not per channel), with the unbiased variance (ddof 1) and eps
1e-5. The port's activations are NCHW, so the channel axis is 1 (``afan``'s
NHWC uses -1).
"""
from __future__ import annotations

from typing import Sequence

import torch

_EPS = 1e-5


def mix_feature(clean_feature: torch.Tensor, adv_feature: torch.Tensor,
                channel_axis: int = 1) -> torch.Tensor:
    """``(clean - mu_cl) / sigma_cl * sigma_adv + mu_adv``."""
    var_cl, mean_cl = torch.var_mean(clean_feature, dim=channel_axis,
                                     correction=1, keepdim=True)
    var_adv, mean_adv = torch.var_mean(adv_feature, dim=channel_axis,
                                       correction=1, keepdim=True)
    normalized = (clean_feature - mean_cl) / torch.sqrt(var_cl + _EPS)
    return normalized * torch.sqrt(var_adv + _EPS) + mean_adv


def mix_spectrum(clean_feature: torch.Tensor, spectrum: torch.Tensor,
                 mask: Sequence[int], channel_axis: int = 1) -> torch.Tensor:
    """AFN on the points of a stacked spectrum ``(N, ...)`` whose ``mask``
    entry is set (the reference's ``mix_layer`` string)."""
    return torch.stack([
        mix_feature(clean_feature, spectrum[i], channel_axis) if mask[i]
        else spectrum[i] for i in range(spectrum.shape[0])])
