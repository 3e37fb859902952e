"""Feature- and input-space PGD — the PyTorch counterpart of
``afan/core/attack.py``.

:func:`pgd` is the one ascent every trainer uses, parameterized by a loss
closure ``loss_fn(x_adv) -> scalar``. The gradient is taken with
``torch.autograd.grad(loss, x_adv)`` only, so an ascent through a model's
tail leaves no ``.grad`` on its parameters. A sign step goes through
:func:`afan_torch.ops.pgd_step.pgd_update`: one hand-written kernel on the
card (step and L-inf projection fused), the same PyTorch ops as ``afan``'s
update (`attack.py:126-133`) on the CPU. A ``'grad'`` step stays eager.

The sign and grad paths issue no host sync, so a CUDA graph can capture
them, ``random_steps`` included: its step sizes are drawn and rounded on the
device (:func:`random_step_sizes`) and the kernel reads each one there.
``bailout_tol`` (a host check of the loss per step) raises under a
capture.

The ascent runs in the attacked tensor's dtype, as ``afan``'s does
(`attack.py:104,112-114`): under bfloat16 each step size is rounded to
bfloat16 before it steps (``jnp.full((steps,), gamma, x.dtype)``), and so
are ``eps`` and the random start's scale, which meet bfloat16 arrays as
JAX's weak-typed Python scalars (:func:`afan_torch.core.project.weak_scalar`).

Inside a row-sharded step (:mod:`afan_torch.parallel.spatial`) ``row_axis``
names the attacked tensor's row axis: the random start is drawn at the
data row's whole shape and sliced, and a ``'grad'`` step's per-sample
maximum is taken over the spatial ranks too.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

from .pgd_step import pgd_update
from . import parallel as spatial
from .project import linfball_proj, weak_scalar

LossFn = Callable[[torch.Tensor], torch.Tensor]


def uniform_init(shape, scale, generator: Optional[torch.Generator] = None,
                 dtype=torch.float32, device=None) -> torch.Tensor:
    """Uniform noise in ``(-scale, scale)`` of ``dtype`` — the reference's
    ``(2 * rand - 1) * eps`` rand-init and ``noise_sd`` injection."""
    u = torch.rand(shape, generator=generator, dtype=dtype, device=device)
    return (2.0 * u - 1.0) * weak_scalar(scale, dtype)


def random_step_sizes(gamma: float, steps: int,
                      generator: Optional[torch.Generator],
                      dtype: torch.dtype, device) -> torch.Tensor:
    """``steps`` step sizes ``2 * gamma * u``, ``u`` uniform in [0, 1)
    drawn in float64 on ``device`` from ``generator``, each rounded to
    ``dtype`` as :func:`afan_torch.core.project.weak_scalar` rounds a Python
    number (float64 to float32, then to ``dtype``), all on the device:
    ``(steps,)`` of ``dtype``. Under a replayed CUDA graph whose generator
    is registered, each replay draws anew."""
    u = torch.rand((steps,), generator=generator, dtype=torch.float64,
                   device=device)
    return (2.0 * gamma * u).to(torch.float32).to(dtype)


def pgd(loss_fn: LossFn, x: torch.Tensor, *, steps: int, gamma: float,
        eps: Optional[float] = None, randinit: bool = False,
        clip: bool = False, generator: Optional[torch.Generator] = None,
        step_mode: str = "sign", random_steps: bool = False,
        bailout_tol: Optional[float] = None,
        row_axis: Optional[int] = None) -> torch.Tensor:
    """k-step gradient ascent on ``x`` maximizing ``loss_fn``; returns the
    adversarial tensor, detached.

    Step order as the reference: grad → ``+= gamma * direction`` → optional
    L∞ projection onto the eps-ball around the original ``x``.
    ``step_mode='grad'`` steps along the raw gradient normalized per sample
    to unit L∞; ``random_steps`` draws each step size uniformly from
    ``(0, 2 * gamma)``. Randomness comes from ``generator`` (on ``x``'s
    device).

    ``bailout_tol=t`` (evaluation only, ``afan``'s `attack.py:141-166`)
    stops after the step at which the relative change of the loss from the
    previous step, ``|l - l_prev| / max(|l|, 1)`` in float32, is at most
    ``t``; each step then reads its loss back to the host.

    ``row_axis`` is ``x``'s row axis in a row-sharded step (2 for NCHW
    features, 1 for NHWC images); it changes nothing outside one.
    """
    if step_mode not in ("sign", "grad"):
        raise ValueError(f"unknown step_mode {step_mode!r}")
    if clip and eps is None:
        raise ValueError("clip=True requires eps")
    if (bailout_tol is not None and x.is_cuda
            and torch.cuda.is_current_stream_capturing()):
        raise RuntimeError("bailout_tol checks the loss on the host at each "
                           "step and cannot run under a capture")
    x = x.detach()
    x_adv = x
    if randinit:
        if eps is None:
            raise ValueError("randinit=True requires eps")
        def start(shape):
            return uniform_init(shape, eps, generator, x.dtype, x.device)
        x_adv = x_adv + (start(x.shape) if row_axis is None
                         else spatial.draw_rows(start, x.shape, row_axis))
    if random_steps:
        sizes = random_step_sizes(gamma, steps, generator, x.dtype, x.device)
        step_sizes = [sizes[t:t + 1] for t in range(steps)]
    else:
        step_sizes = [weak_scalar(gamma, x.dtype)] * steps
    prev = None
    for gamma_t in step_sizes:
        x_adv = x_adv.detach().requires_grad_(True)
        with torch.enable_grad():
            loss = loss_fn(x_adv)
            (g,) = torch.autograd.grad(loss, x_adv)
        if step_mode == "sign":
            x_adv = pgd_update(x_adv.detach(), g, x, gamma=gamma_t, eps=eps,
                               clip=clip)
        else:
            x_adv = x_adv.detach() + gamma_t * _grad_direction(
                g, row_axis is not None)
            if clip:
                x_adv = linfball_proj(x, eps, x_adv)
        if bailout_tol is not None:
            cur = np.float32(float(loss.detach()))
            if prev is not None and (np.abs(cur - prev) / np.maximum(
                    np.abs(cur), np.float32(1.0))) <= bailout_tol:
                break
            prev = cur
    return x_adv.detach()


def input_pgd(loss_fn: LossFn, x: torch.Tensor, *, steps: int, gamma: float,
              eps: Optional[float] = None, randinit: bool = False,
              clip: bool = False, generator: Optional[torch.Generator] = None,
              step_mode: str = "sign", random_steps: bool = False,
              row_axis: Optional[int] = None) -> torch.Tensor:
    """Input-space PGD (``afan``'s `attack.py:163-183`): :func:`pgd` on an
    image in [0, 1], then a clamp of the result to [0, 1]."""
    x_adv = pgd(loss_fn, x, steps=steps, gamma=gamma, eps=eps,
                randinit=randinit, clip=clip, generator=generator,
                step_mode=step_mode, random_steps=random_steps,
                row_axis=row_axis)
    return x_adv.clamp(0.0, 1.0)


def _grad_direction(g: torch.Tensor, row_sharded: bool = False
                    ) -> torch.Tensor:
    """The raw gradient normalized per sample to unit L-inf (the maximum
    over the spatial ranks too, for a ``row_sharded`` ``g`` in a
    row-sharded step)."""
    flat = g.abs().reshape(g.shape[0], -1) if g.dim() > 1 else \
        g.abs().reshape(1, -1)
    if row_sharded and spatial.active() is not None:
        local = (flat.amax(dim=1) if flat.shape[1]
                 else flat.new_zeros(flat.shape[0]))
        gmax = spatial.spatial_max_(local).clamp_min(1e-12)
    else:
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
