"""The PGD sign step — the PyTorch counterpart of
``afan/ops/kernels/pgd_step.py:pgd_update``.

Every ascent step of :func:`afan_torch.core.attack.pgd` in sign mode ends
with ``x + gamma * sign(g)`` and, with ``clip``, the projection onto the
L-inf ball around the clean feature. Eager PyTorch runs that as 3 launches
(7 with the clip), each writing an intermediate; :func:`pgd_update` on a
CUDA tensor runs it as one hand-written kernel
(:mod:`afan_torch.ops.kernels.pgd_step`), and on a CPU tensor as
:func:`pgd_update_plain`, the same chain of PyTorch ops. Both take float32
and bfloat16; in bfloat16 ``gamma`` and ``eps`` are rounded to bfloat16
first, as ``afan``'s ascent rounds them (``attack.py:114`` and JAX's weak
typing), so each op rounds once, as ``afan``'s bf16 ops do. ``gamma``
may be a one-element tensor of ``x``'s dtype on ``x``'s device, a step size
drawn there (``random_steps``): the kernel then reads it on the card and
the plain version multiplies by it, so nothing goes to the host.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

from ..core.project import linfball_proj, weak_scalar
from .kernels import pgd_step as kernels


def pgd_update_plain(x: torch.Tensor, g: torch.Tensor,
                     center: Optional[torch.Tensor] = None, *,
                     gamma: Union[float, torch.Tensor],
                     eps: Optional[float] = None, clip: bool = False
                     ) -> torch.Tensor:
    """The plain version: ``x + gamma * sign(g)``, then
    ``linfball_proj(center, eps, .)`` when ``clip``, with ``gamma`` and
    ``eps`` in ``x``'s dtype (a tensor ``gamma`` already is)."""
    out = x + weak_scalar(gamma, x.dtype) * torch.sign(g)
    if clip:
        out = linfball_proj(center, eps, out)
    return out


def pgd_update(x: torch.Tensor, g: torch.Tensor,
               center: Optional[torch.Tensor] = None, *,
               gamma: Union[float, torch.Tensor],
               eps: Optional[float] = None, clip: bool = False
               ) -> torch.Tensor:
    """``x + gamma * sign(g)``, clamped into ``[center - eps, center +
    eps]`` when ``clip``, in a new tensor. On a CUDA tensor it launches the
    kernel (float32 or bfloat16) or raises."""
    if clip and (center is None or eps is None):
        raise ValueError("clip=True requires center and eps")
    if x.device.type == "cpu":
        return pgd_update_plain(x, g, center, gamma=gamma, eps=eps,
                                clip=clip)
    return kernels.pgd_update(
        x.contiguous(), g.contiguous(),
        center.contiguous() if clip else None, gamma=gamma, eps=eps,
        clip=clip)
