"""afan_torch.core (projections, spectrum, AFN, PGD) against afan.core on
the same numpy inputs.

The port's activations are NCHW and ``afan``'s NHWC, so AFN runs on the
transposed tensor with the channel axis at 1. PGD's random draws cannot
match across frameworks: the test draws ``afan``'s init noise and step
sizes with its own key and patches them in where the port draws its own.

Tolerance: float32 element-wise math in both frameworks, within
``1e-6 * max|want|``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from afan.core import afn as jafn
from afan.core import attack as jattack
from afan.core import project as jproject
from afan.core import spectrum as jspectrum
from afan_torch.core import afn, attack, project, spectrum
from torch_threads import one_torch_thread  # noqa: F401

REL = 1e-6


def close(got, want, rel=REL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * max(np.abs(want).max(), 1e-6))


def t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("number", [2, 3, 5])
def test_sample_points(number):
    rng = np.random.RandomState(0)
    clean, adv = rng.randn(2, 4, 3, 3).astype(np.float32)
    want = jspectrum.sample_points(jnp.asarray(clean), jnp.asarray(adv),
                                   number)
    got = spectrum.sample_points(t(clean), t(adv), number)
    close(got.numpy(), want)
    assert torch.equal(got[0], t(clean))
    close(got[-1].numpy(), adv)


def test_spectrum_needs_two_points():
    with pytest.raises(ValueError):
        spectrum.spectrum_weights(1)


def test_mix_feature_nchw_matches_nhwc():
    rng = np.random.RandomState(1)
    clean = rng.randn(2, 5, 6, 8).astype(np.float32)        # NHWC
    adv = (clean + 0.3 * rng.randn(*clean.shape)).astype(np.float32)
    want = jafn.mix_feature(jnp.asarray(clean), jnp.asarray(adv))
    got = afn.mix_feature(t(clean).permute(0, 3, 1, 2),
                          t(adv).permute(0, 3, 1, 2))
    close(got.permute(0, 2, 3, 1).numpy(), want)


def test_mix_spectrum():
    rng = np.random.RandomState(2)
    clean = rng.randn(2, 4, 4, 6).astype(np.float32)
    spec = rng.randn(3, 2, 4, 4, 6).astype(np.float32)
    want = jafn.mix_spectrum(jnp.asarray(clean), jnp.asarray(spec), (0, 1, 1))
    got = afn.mix_spectrum(t(clean).permute(0, 3, 1, 2),
                           t(spec).permute(0, 1, 4, 2, 3), (0, 1, 1))
    close(got.permute(0, 1, 3, 4, 2).numpy(), want)


def test_projections():
    rng = np.random.RandomState(3)
    center, x = rng.randn(2, 3, 4, 5).astype(np.float32)
    x[1] = center[1]                       # a zero offset: the 0/0 fix
    close(project.linfball_proj(t(center), 0.3, t(x)).numpy(),
          jproject.linfball_proj(jnp.asarray(center), 0.3, jnp.asarray(x)))
    got = project.l2ball_proj(t(center), 0.5, t(x))
    close(got.numpy(),
          jproject.l2ball_proj(jnp.asarray(center), 0.5, jnp.asarray(x)))
    assert torch.equal(got[1], t(center[1]))
    lo, hi = center - 0.1, center + 0.2
    close(project.tensor_clamp(t(x), t(lo), t(hi)).numpy(),
          jproject.tensor_clamp(jnp.asarray(x), jnp.asarray(lo),
                                jnp.asarray(hi)))


def _quadratic(a, b):
    """loss(x) = sum(a * x^2 + b * x) — the same closure in both
    frameworks."""
    return (lambda x: jnp.sum(jnp.asarray(a) * x ** 2 + jnp.asarray(b) * x),
            lambda x: torch.sum(t(a) * x ** 2 + t(b) * x))


@pytest.mark.parametrize("step_mode,random_steps,clip", [
    ("sign", False, True), ("grad", False, False), ("sign", True, True)])
def test_pgd_on_a_quadratic_with_injected_noise(step_mode, random_steps,
                                                clip, monkeypatch):
    rng = np.random.RandomState(4)
    x, a, b = rng.randn(3, 2, 3, 4).astype(np.float32)
    jloss, tloss = _quadratic(a, b)
    key = jax.random.PRNGKey(7)
    steps, gamma, eps = 4, 0.05, 0.12
    want = jattack.pgd(jloss, jnp.asarray(x), steps=steps, gamma=gamma,
                       eps=eps, randinit=True, clip=clip, rng=key,
                       step_mode=step_mode, random_steps=random_steps)
    # afan's own draws, as its pgd makes them from ``key``, take the place
    # of the port's: the rand-init noise and the step-size uniforms
    noise = t(np.asarray(jattack.uniform_init(key, x.shape, eps)))
    u = torch.from_numpy(np.asarray(jax.random.uniform(
        jax.random.fold_in(key, 0x57C4), (steps,))).astype(np.float64))
    monkeypatch.setattr(attack, "uniform_init", lambda *_, **__: noise)
    monkeypatch.setattr(attack.torch, "rand", lambda *_, **__: u)
    got = attack.pgd(tloss, t(x), steps=steps, gamma=gamma, eps=eps,
                     randinit=True, clip=clip, step_mode=step_mode,
                     random_steps=random_steps)
    close(got.numpy(), want)


def test_pgd_leaves_no_parameter_grad():
    w = torch.nn.Parameter(torch.ones(3))
    adv = attack.pgd(lambda x: (w * x).sum() ** 2, torch.zeros(3) + 0.5,
                     steps=2, gamma=0.1)
    assert w.grad is None and not adv.requires_grad


def test_perturbation_norms():
    rng = np.random.RandomState(5)
    clean, adv = rng.randn(2, 3, 4, 5).astype(np.float32)
    want = jattack.perturbation_norms(jnp.asarray(clean), jnp.asarray(adv))
    got = attack.perturbation_norms(t(clean), t(adv))
    for g, w in zip(got, want):
        close(g.numpy(), w)
