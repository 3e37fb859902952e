"""Feature- and input-space PGD — the PyTorch counterpart of
``afan/core/attack.py``.

:func:`pgd` is the one ascent every trainer uses, parameterized by a loss
closure ``loss_fn(x_adv) -> scalar``. The gradient is taken with
``torch.autograd.grad(loss, x_adv)`` only, so an ascent through a model's
tail leaves no ``.grad`` on its parameters. A sign step goes through
:func:`afan_torch.ops.pgd_step.pgd_update`: one hand-written kernel on the
card (step and L-inf projection fused), the same PyTorch ops as ``afan``'s
update (`attack.py:126-133`) on the CPU. A ``'grad'`` step stays eager.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from ..ops.pgd_step import pgd_update
from .project import linfball_proj

LossFn = Callable[[torch.Tensor], torch.Tensor]


def uniform_init(shape, scale, generator: Optional[torch.Generator] = None,
                 dtype=torch.float32, device=None) -> torch.Tensor:
    """Uniform noise in ``(-scale, scale)`` — the reference's
    ``(2 * rand - 1) * eps`` rand-init and ``noise_sd`` injection."""
    u = torch.rand(shape, generator=generator, dtype=dtype, device=device)
    return (2.0 * u - 1.0) * scale


def pgd(loss_fn: LossFn, x: torch.Tensor, *, steps: int, gamma: float,
        eps: Optional[float] = None, randinit: bool = False,
        clip: bool = False, generator: Optional[torch.Generator] = None,
        step_mode: str = "sign", random_steps: bool = False
        ) -> torch.Tensor:
    """k-step gradient ascent on ``x`` maximizing ``loss_fn``; returns the
    adversarial tensor, detached.

    Step order as the reference: grad → ``+= gamma * direction`` → optional
    L∞ projection onto the eps-ball around the original ``x``.
    ``step_mode='grad'`` steps along the raw gradient normalized per sample
    to unit L∞; ``random_steps`` draws each step size uniformly from
    ``(0, 2 * gamma)``. Randomness comes from ``generator`` (on ``x``'s
    device).
    """
    if step_mode not in ("sign", "grad"):
        raise ValueError(f"unknown step_mode {step_mode!r}")
    if clip and eps is None:
        raise ValueError("clip=True requires eps")
    x = x.detach()
    x_adv = x
    if randinit:
        if eps is None:
            raise ValueError("randinit=True requires eps")
        x_adv = x_adv + uniform_init(x.shape, eps, generator, x.dtype,
                                     x.device)
    if random_steps:
        u = torch.rand((steps,), generator=generator, dtype=torch.float64,
                       device=x.device)
        step_sizes = (2.0 * gamma * u).tolist()
    else:
        step_sizes = [gamma] * steps
    for gamma_t in step_sizes:
        x_adv = x_adv.detach().requires_grad_(True)
        with torch.enable_grad():
            (g,) = torch.autograd.grad(loss_fn(x_adv), x_adv)
        if step_mode == "sign":
            x_adv = pgd_update(x_adv.detach(), g, x, gamma=gamma_t, eps=eps,
                               clip=clip)
        else:
            x_adv = x_adv.detach() + gamma_t * _grad_direction(g)
            if clip:
                x_adv = linfball_proj(x, eps, x_adv)
    return x_adv.detach()


def _grad_direction(g: torch.Tensor) -> torch.Tensor:
    """The raw gradient normalized per sample to unit L-inf."""
    flat = g.abs().reshape(g.shape[0], -1) if g.dim() > 1 else \
        g.abs().reshape(1, -1)
    gmax = flat.amax(dim=1).clamp_min(1e-12)
    if g.dim() > 1:
        gmax = gmax.reshape((-1,) + (1,) * (g.dim() - 1))
    return g / gmax


def perturbation_norms(clean: torch.Tensor, adv: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-sample (L2, L∞) norms of ``adv - clean`` → two ``(batch,)``
    tensors."""
    delta = (adv - clean).reshape(clean.shape[0], -1)
    return (torch.linalg.vector_norm(delta, dim=1),
            delta.abs().amax(dim=1))
