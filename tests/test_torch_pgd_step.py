"""afan_torch's PGD step (``ops/pgd_step.py``) against afan's
(``afan/ops/kernels/pgd_step.py``) on the CPU, and the routing of
``core.attack.pgd`` through it.

The plain version must equal ``afan``'s Pallas kernel (interpret mode) and
its jnp reference bit for bit on finite values: both compute
``x + f32(gamma) * sign(g)`` (an exact product, one rounding) and clamp to
``[c - f32(eps), c + f32(eps)]``. On non-finite and denormal gradients the
two frameworks' CPU ``sign`` differ (jnp gives NaN for NaN and flushes
denormals to 0); the port follows torch, ``(g > 0) - (g < 0)``, which is
what the CUDA kernel reproduces on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py`` phase 11).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from afan.ops.kernels.pgd_step import pgd_update_pallas, pgd_update_reference
from afan_torch.core import attack
from afan_torch.core.project import linfball_proj
from afan_torch.ops import pgd_step
from afan_torch.ops.kernels import pgd_step as kernels
from torch_threads import one_torch_thread  # noqa: F401


def bits(a):
    return np.asarray(a, np.float32).view(np.int32)


def inputs(shape, seed, clip):
    rng = np.random.RandomState(seed)
    x, g, c = (rng.randn(*shape).astype(np.float32) for _ in range(3))
    return x, g, (c if clip else None)


# the cases of tests/test_kernels.py, plus an odd count and a clip sweep
@pytest.mark.parametrize("shape,gamma,eps,clip", [
    ((128,), 0.01, None, False), ((4, 33, 7), 0.01, None, False),
    ((2, 16, 16, 16), 0.01, None, False), ((3, 50), 0.05, 0.1, True),
    ((7, 13), 1.5 / 255, 2.0 / 255, True), ((5, 3, 11), 0.3, 0.2, True)])
def test_plain_is_bit_equal_to_afan(shape, gamma, eps, clip):
    x, g, c = inputs(shape, sum(shape), clip)
    got = pgd_step.pgd_update_plain(
        torch.from_numpy(x), torch.from_numpy(g),
        None if c is None else torch.from_numpy(c), gamma=gamma, eps=eps,
        clip=clip)
    jc = None if c is None else jnp.asarray(c)
    want_k = pgd_update_pallas(jnp.asarray(x), jnp.asarray(g), jc,
                               gamma=gamma, eps=eps, clip=clip,
                               interpret=True)
    want_r = pgd_update_reference(jnp.asarray(x), jnp.asarray(g), jc,
                                  gamma=gamma, eps=eps, clip=clip)
    assert np.array_equal(bits(got.numpy()), bits(want_k))
    assert np.array_equal(bits(got.numpy()), bits(want_r))
    if clip:
        assert float((got - torch.from_numpy(c)).abs().max()) <= eps + 1e-6


def test_plain_sign_of_zeros_denormals_and_nan():
    tiny = np.float32(1e-40)                       # a float32 denormal
    g = np.array([0.0, -0.0, tiny, -tiny, np.nan, 2.0, -3.0], np.float32)
    x = np.full_like(g, 0.5)
    got = pgd_step.pgd_update_plain(torch.from_numpy(x), torch.from_numpy(g),
                                    gamma=0.25).numpy()
    sign = (g > 0).astype(np.float32) - (g < 0).astype(np.float32)
    assert np.array_equal(bits(got), bits(x + np.float32(0.25) * sign))
    assert got.tolist() == [0.5, 0.5, 0.75, 0.25, 0.5, 0.75, 0.25]


def test_plain_clip_propagates_nan_like_torch_maximum():
    x = torch.tensor([np.nan, 1.0, 1.0, -5.0])
    c = torch.tensor([0.0, np.nan, 0.0, 0.0])
    got = pgd_step.pgd_update_plain(x, torch.ones(4), c, gamma=0.5, eps=1.0,
                                    clip=True)
    assert torch.isnan(got[:2]).all()
    assert got[2:].tolist() == [1.0, -1.0]


def test_dispatch_on_cpu_is_the_plain_version_and_launches_nothing():
    x, g, c = (torch.from_numpy(a) for a in inputs((6, 9), 3, True))
    before = kernels.launches
    for clip in (False, True):
        got = pgd_step.pgd_update(x, g, c, gamma=0.02, eps=0.05, clip=clip)
        want = pgd_step.pgd_update_plain(x, g, c, gamma=0.02, eps=0.05,
                                         clip=clip)
        assert torch.equal(got, want)
    assert kernels.launches == before
    with pytest.raises(ValueError):
        pgd_step.pgd_update(x, g, None, gamma=0.02, eps=0.05, clip=True)


def test_kernel_wrapper_refuses_cpu_tensors():
    x = torch.zeros(8)
    before = kernels.launches
    with pytest.raises(ValueError, match="device cpu"):
        kernels.pgd_update(x, x, gamma=0.1)
    with pytest.raises(ValueError, match="device cpu"):
        kernels.pgd_update(x.to(torch.bfloat16), x.to(torch.bfloat16),
                           gamma=0.1)
    with pytest.raises(ValueError):
        kernels.pgd_update(x, x, gamma=0.1, clip=True)
    assert kernels.launches == before


def _pgd_before_the_kernel(loss_fn, x, *, steps, gamma, eps=None,
                           clip=False, noise=None):
    """The sign ascent as it was written before it went through
    ``pgd_update``: eager sign, multiply, add, then the projection."""
    x = x.detach()
    x_adv = x if noise is None else x + noise
    for _ in range(steps):
        x_adv = x_adv.detach().requires_grad_(True)
        with torch.enable_grad():
            (g,) = torch.autograd.grad(loss_fn(x_adv), x_adv)
        x_adv = x_adv.detach() + gamma * torch.sign(g)
        if clip:
            x_adv = linfball_proj(x, eps, x_adv)
    return x_adv.detach()


@pytest.mark.parametrize("clip,randinit", [(False, False), (True, False),
                                           (True, True)])
def test_attack_pgd_on_cpu_is_unchanged(clip, randinit, monkeypatch):
    rng = np.random.RandomState(9)
    x, a, b = (torch.from_numpy(rng.randn(2, 3, 5, 4).astype(np.float32))
               for _ in range(3))
    noise = torch.from_numpy(
        rng.uniform(-0.04, 0.04, x.shape).astype(np.float32))
    monkeypatch.setattr(attack, "uniform_init", lambda *_, **__: noise)

    def loss(v):
        return torch.sum(a * torch.tanh(v) ** 2 + b * v)

    got = attack.pgd(loss, x, steps=4, gamma=0.03, eps=0.04, clip=clip,
                     randinit=randinit)
    want = _pgd_before_the_kernel(loss, x, steps=4, gamma=0.03, eps=0.04,
                                  clip=clip,
                                  noise=noise if randinit else None)
    assert torch.equal(got, want)
