"""afan_torch's robust evaluation against afan's
(``afan/eval/robustness.py:make_robust_eval_step``): input PGD against the
eval-mode ResNet-s, then top-1 on the adversarial images; ``pgd``'s
``bailout_tol`` against afan's; and ``infer_classify --pgd`` on the CPU.

The model is ``ResNetS(num_blocks=(1, 1, 1), num_classes=4)`` on 16x16
inputs at batch 8, with afan's weights carried by
``resnet_s_variables_to_state_dict``, as ``tests/test_torch_classify.py``.
Tolerance: the adversarial images within 1e-5 (three sign steps of 2/255
from the same start; a step taken the other way would move an entry by
2 * 2/255), the same ``correct`` and ``count``.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from afan.core import attack as jattack
from afan.eval import robustness as jrobust
from afan.models.resnet_s import ResNetS as JResNetS
from afan.train import loop as jloop
from afan.train import optim as joptim
from afan_torch.cli import infer_classify
from afan_torch.core import attack
from afan_torch.data import cifar
from afan_torch.eval import robustness
from afan_torch.interop.from_jax import resnet_s_variables_to_state_dict
from afan_torch.models.resnet_s import ResNetS, resnet56
from torch_threads import one_torch_thread  # noqa: F401

BLOCKS, NC, B = (1, 1, 1), 4, 8
EPS = 8.0 / 255


def batch(seed):
    """tests/test_torch_classify.py:batch: class-dependent means."""
    rng = np.random.RandomState(seed)
    y = rng.randint(0, NC, B)
    x = rng.rand(B, 16, 16, 3) * 0.1 + y[:, None, None, None] * 0.25
    return x.astype(np.float32), y.astype(np.int64)


@pytest.fixture(scope="module")
def models():
    jm = JResNetS(num_blocks=BLOCKS, num_classes=NC)
    x, _ = batch(0)
    vs = jax.device_get(jm.init(jax.random.PRNGKey(0), jnp.asarray(x), 0,
                                None, False))
    tm = ResNetS(BLOCKS, NC)
    tm.load_state_dict(resnet_s_variables_to_state_dict(vs), strict=True)
    return jm, vs, tm


def recording(monkeypatch, module, real, into, jax_side):
    def pgd(loss_fn, x, **kw):
        out = real(loss_fn, x, **kw)
        if jax_side:
            jax.debug.callback(lambda a: into.append(np.asarray(a)), out)
        else:
            into.append(out.detach().numpy())
        return out
    monkeypatch.setattr(module, "pgd", pgd)


@pytest.mark.parametrize("seed", [1, 2])
def test_robust_eval_step_matches_afan(models, monkeypatch, seed):
    jm, vs, tm = models
    x, y = batch(seed)
    jadv, tadv = [], []
    recording(monkeypatch, jrobust, jattack.pgd, jadv, True)
    recording(monkeypatch, robustness, attack.pgd, tadv, False)
    state = jloop.TrainState.create(vs, joptim.sgd(lambda c: 0.0))
    want = jrobust.make_robust_eval_step(jm, NC, randinit=False)(
        state, jnp.asarray(x), jnp.asarray(y), jax.random.PRNGKey(0))
    got = robustness.make_robust_eval_step(tm, NC, randinit=False)(
        torch.from_numpy(x), torch.from_numpy(y))
    jax.effects_barrier()
    assert len(jadv) == len(tadv) == 1
    assert np.abs(tadv[0] - jadv[0]).max() <= 1e-5
    assert np.abs(tadv[0] - x).max() > 0           # the ascent moved
    assert int(got["correct"]) == int(want["correct"])
    assert int(got["count"]) == int(want["count"]) == B


def test_robust_eval_random_start_lies_in_the_eps_ball(models, monkeypatch):
    _, _, tm = models
    x, y = batch(3)
    adv = []
    recording(monkeypatch, robustness, attack.pgd, adv, False)
    gen = torch.Generator().manual_seed(0)
    robustness.make_robust_eval_step(tm, NC, steps=0, eps=EPS,
                                     generator=gen)(torch.from_numpy(x),
                                                    torch.from_numpy(y))
    noise = adv[0] - x
    assert np.abs(noise).max() < EPS + 1e-6     # + the rounding of x + noise
    assert noise.min() < -EPS / 2 and noise.max() > EPS / 2
    assert abs(noise.mean()) < EPS / 10


def test_bailout_tol_stops_at_afan_step():
    """A loss that rises for three steps and then plateaus (below float32
    resolution): both stop after the fifth step; the final iterate counts
    the steps taken (each moves every entry by gamma)."""
    def jloss(v):
        return jnp.sum(jnp.minimum(v, 0.25)) + 1e-9 * jnp.sum(v)

    def tloss(v):
        return torch.sum(torch.minimum(v, torch.tensor(0.25))) + \
            1e-9 * torch.sum(v)

    x = np.zeros(8, np.float32)
    for tol in (1e-3, None):
        want = jattack.pgd(jloss, jnp.asarray(x), steps=12, gamma=0.1,
                           bailout_tol=tol)
        got = attack.pgd(tloss, torch.from_numpy(x), steps=12, gamma=0.1,
                         bailout_tol=tol)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
        assert got[0] == pytest.approx(0.5 if tol else 1.2)


def small_loaders(train_batch_size, test_batch_size, data_dir, seed):
    tx, ty, ex, ey = cifar.synthetic_arrays(64, 16, 10, seed)
    return (cifar.CifarLoader(tx[:48], ty[:48], train_batch_size, True, seed),
            cifar.CifarLoader(tx[48:], ty[48:], test_batch_size, False),
            cifar.CifarLoader(ex, ey, test_batch_size, False))


def learned_checkpoint(path):
    """A ResNet-56 that has learned the small split: 14 epochs of 3 base
    steps (batch 16, lr 0.01, no augmentation) from seed 0 take it to 100%
    on its 16 test images. Near chance, robust accuracy can exceed clean
    (a random start flips wrong guesses as often as right ones)."""
    from afan_torch.train import loop, optim
    tx, ty, _, _ = cifar.synthetic_arrays(64, 16, 10, 0)
    model = resnet56(generator=torch.Generator().manual_seed(0))
    opt, count = optim.capturable_sgd(
        list(model.parameters()),
        lambda c: torch.full_like(c, 0.01, dtype=torch.float64), 0.01, 0.9,
        5e-4)
    step = loop.make_base_step(model, opt, count)
    x = torch.from_numpy(tx[:48]).float() / 255
    y = torch.from_numpy(ty[:48])
    for _ in range(14):
        for i in range(0, 48, 16):
            step(x[i:i + 16], y[i:i + 16])
    torch.save({"state_dict": model.state_dict()}, path)


def test_infer_classify_pgd_on_cpu(tmp_path, monkeypatch):
    """``--pgd`` on a checkpoint that has learned: clean accuracy at least
    75%, robust below clean (100% and 0% here); the ascent takes ``--pgd_steps`` updates per
    batch and moves every batch, within ``eps + steps * gamma``."""
    monkeypatch.setattr(infer_classify, "cifar10_dataloaders", small_loaders)
    path = os.path.join(str(tmp_path), "model.pt")
    learned_checkpoint(path)
    argv = ["--device", "cpu", "--batch_size", "8", "--pretrained", path]
    logs, moved, updates = [], [], []
    monkeypatch.setattr(infer_classify.Log, "i", logs.append)

    def counting(*a, **kw):
        updates.append(a[0].shape)
        return real_update(*a, **kw)

    def recording(loss_fn, x, **kw):
        adv = real_pgd(loss_fn, x, **kw)
        moved.append(float((adv - x).abs().max()))
        return adv

    real_update, real_pgd = attack.pgd_update, robustness.pgd
    clean = infer_classify.main(argv)
    monkeypatch.setattr(attack, "pgd_update", counting)
    monkeypatch.setattr(robustness, "pgd", recording)
    robust = infer_classify.main(argv + ["--pgd", "--pgd_steps", "2"])
    assert clean >= 75.0
    assert 0.0 <= robust < clean <= 100.0
    assert updates == [(8, 32, 32, 3)] * 4          # 2 batches x 2 steps
    assert len(moved) == 2
    assert all(0 < m <= (8.0 + 2 * 2.0) / 255 + 1e-6 for m in moved)
    assert any("robust accuracy (PGD-2)" in m for m in logs)
