"""afan_torch's classification trainer under bfloat16 (``--bf16``) against
afan's bfloat16 path, at the size of ``tests/test_torch_classify.py``
(``ResNetS(num_blocks=(1, 1, 1), num_classes=4)``, 16x16 inputs, batch 8),
whose weights, batches and schedules this file reuses.

- The CE is optax's ``softmax_cross_entropy_with_integer_labels(...).mean()``
  on bfloat16 logits as ``afan``'s jitted steps compute it: the value within
  one bf16 ulp and the gradient within one bf16 ulp of each entry (the two
  libraries' float32 ``exp`` differ in the last bit).
- The bf16 forward's logits agree with ``afan``'s bf16 forward within twice
  ``afan``'s own bf16-vs-f32 gap.
- One base, one ALFA (tap 5, 2 PGD steps) and one learnable-η (taps (2, 5,
  7), 1 step) step from the same weights and batch: the loss and every
  updated parameter and running statistic (by norm) within twice ``afan``'s
  own bf16-vs-f32 gap plus 1e-3, the rule of ``tests/test_torch_bf16.py``;
  the test prints both gaps.
- The CLI with ``--bf16 --epoch_scan`` runs its eager path on the CPU: a
  bf16-compute model with float32 parameters, trained, and a float32
  checkpoint (the base mode: ``tests/test_torch_classify.py``; every mode
  at full width: ``chip_smoke.py --only clsbf16``).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from afan.models.resnet_s import ResNetS as JResNetS
from afan.train import loop as jloop
from afan.train import optim as joptim
from afan_torch.cli import train_classify
from afan_torch.interop.from_jax import resnet_s_variables_to_state_dict
from afan_torch.models.resnet_s import ResNetS
from afan_torch.train import loop, optim
from afan_torch.train.checkpoint import load_training_state

# ``variables`` is that file's module-scoped fixture and ``one_torch_thread``
# its autouse one, shared here
from test_torch_classify import (BLOCKS, LR, MOMENTUM, NC, W_LR, WD, batch,
                                 one_torch_thread, schedules, small_loaders,
                                 variables)

BF16 = torch.bfloat16


def to_jax(x):
    return jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)


def as_f32(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def within_one_ulp(got, want):
    got, want = as_f32(got), as_f32(want)
    ulp = np.maximum(np.abs(want), np.float32(2.0 ** -126)) * 2.0 ** -7
    diff = np.abs(got - want)
    assert (diff <= ulp).all(), float((diff / ulp).max())
    return int((diff > 0).sum())


def rel_gap(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-12))


def test_cross_entropy_bf16_is_optax():
    rng = np.random.RandomState(0)
    for n, c in ((512, 10), (128, 100)):
        logits = torch.from_numpy(rng.randn(n, c).astype(np.float32) * 4
                                  ).to(BF16)
        labels = torch.from_numpy(rng.randint(0, c, n))

        def j_ce(lo):
            return optax.softmax_cross_entropy_with_integer_labels(
                lo, jnp.asarray(labels.numpy())).mean()

        want, want_g = jax.jit(jax.value_and_grad(j_ce))(to_jax(logits))
        x = logits.clone().requires_grad_(True)
        got = loop.cross_entropy(x, labels)
        (g,) = torch.autograd.grad(got, x)
        assert got.dtype == g.dtype == BF16 and want.dtype == jnp.bfloat16
        within_one_ulp(got, want)
        n_g = within_one_ulp(g, want_g)
        print(f"CE ({n}, {c}): {float(got)} against optax's {float(want)}; "
              f"{n_g} of {g.numel()} gradient entries one bf16 ulp apart")


def port_model(vs, dtype, init=1.0 / 9):
    tm = ResNetS(BLOCKS, NC, init, dtype=dtype)
    tm.load_state_dict(resnet_s_variables_to_state_dict(vs), strict=True)
    return tm


def test_bf16_forward_matches_afan(variables):
    _, vs = variables
    x, _ = batch(3)
    out = {}
    for name, dt in (("f32", jnp.float32), ("bf16", jnp.bfloat16)):
        jm = JResNetS(num_blocks=BLOCKS, num_classes=NC, dtype=dt)
        lo = jax.jit(lambda v, x: jm.apply(v, x, 0, None, True,
                                           mutable=["batch_stats"])[0])(
            vs, jnp.asarray(x))
        out[name] = as_f32(lo)
    assert lo.dtype == jnp.bfloat16
    tm = port_model(vs, BF16).train()
    got = tm(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert got.dtype == BF16
    assert {p.dtype for p in tm.parameters()} == {torch.float32}
    port_gap = rel_gap(as_f32(got), out["bf16"])
    own_gap = rel_gap(out["bf16"], out["f32"])
    print(f"logits: port-vs-afan (bf16) {port_gap:.3e}; afan bf16-vs-f32 "
          f"{own_gap:.3e}")
    assert port_gap <= 2 * own_gap


def afan_step(jm_dtype, vs, mode, x, y):
    jsched, _ = schedules()
    jm = JResNetS(num_blocks=BLOCKS, num_classes=NC, init_weight=1.0 / 9,
                  dtype=jm_dtype)
    if mode == "learnable":
        tx = joptim.learnable_tx(jsched, W_LR, MOMENTUM, WD)
        step = jloop.make_learnable_step(
            jm, tx, jloop.LearnableConfig(taps=(2, 5, 7), steps=1))
    else:
        tx = joptim.sgd(jsched, MOMENTUM, WD)
        step = (jloop.make_base_step(jm, tx) if mode == "base" else
                jloop.make_alfa_step(jm, tx, jloop.AlfaConfig(tap=5,
                                                              steps=2)))
    state = jloop.TrainState.create(vs, tx)
    args = (state, jnp.asarray(x), jnp.asarray(y))
    if mode != "base":
        args += (jax.random.PRNGKey(0),)
    state, metrics = step(*args)
    return resnet_s_variables_to_state_dict(jax.device_get(
        {"params": state.params, "batch_stats": state.batch_stats})), \
        float(metrics["loss"])


@pytest.mark.parametrize("mode", ["base", "alfa", "learnable"])
def test_bf16_step_matches_afans(variables, mode):
    _, vs = variables
    x, y = batch(1)
    j16, loss16 = afan_step(jnp.bfloat16, vs, mode, x, y)
    j32, loss32 = afan_step(jnp.float32, vs, mode, x, y)
    _, tsched = schedules()
    tm = port_model(vs, BF16)
    if mode == "learnable":
        opt, sched = optim.learnable_sgd(tm, tsched, LR, W_LR, MOMENTUM, WD)
        step = loop.make_learnable_step(
            tm, opt, sched, loop.LearnableConfig(taps=(2, 5, 7), steps=1))
    else:
        opt, sched = optim.sgd([{"params": list(tm.parameters())}], tsched,
                               LR, MOMENTUM, WD)
        step = (loop.make_base_step(tm, opt, sched) if mode == "base" else
                loop.make_alfa_step(tm, opt, sched,
                                    loop.AlfaConfig(tap=5, steps=2)))
    out = step(torch.from_numpy(x), torch.from_numpy(y))
    want_dtype = torch.float32 if mode == "learnable" else BF16
    assert out["loss"].dtype == want_dtype
    loss = float(out["loss"])
    port_gap = abs(loss - loss16) / abs(loss16)
    own_gap = abs(loss16 - loss32) / abs(loss16)
    print(f"{mode} loss: port {loss:.6f}, afan bf16 {loss16:.6f}, f32 "
          f"{loss32:.6f}; port-vs-afan {port_gap:.3e}, afan bf16-vs-f32 "
          f"{own_gap:.3e}")
    assert port_gap <= 2 * own_gap + 1e-3
    before = resnet_s_variables_to_state_dict(vs)
    got = tm.state_dict()
    worst = (0.0, "")
    for k, w in j16.items():
        if k.endswith("num_batches_tracked"):
            continue
        assert got[k].dtype == torch.float32, k
        g, w, f, b = (got[k].numpy(), w.numpy(), j32[k].numpy(),
                      before[k].numpy())
        scale = max(np.linalg.norm(w - b), 1e-12)
        port = np.linalg.norm(g - w) / scale
        own = np.linalg.norm(w - f) / scale
        worst = max(worst, (port / (2 * own + 1e-3), k))
        assert port <= 2 * own + 1e-3, (k, port, own)
    print(f"updates: the largest port-vs-afan gap is {worst[0]:.3f} of its "
          f"bound ({worst[1]})")


def test_cli_bf16_epoch_scan_runs_eagerly_on_the_cpu(tmp_path, monkeypatch):
    flags = ["--mode", "alfa", "--epoch_scan"]
    monkeypatch.setattr(train_classify, "cifar10_dataloaders", small_loaders)
    built = []
    real = train_classify.build_model

    def recording(args, generator):
        model = real(args, generator)
        built.append((model.dtype, {p.dtype for p in model.parameters()}))
        return model
    monkeypatch.setattr(train_classify, "build_model", recording)
    scans = []
    real_scan = train_classify.scan_epoch

    def scan_recording(epoch_fn, *a):
        seen = real_scan(epoch_fn, *a)
        scans.append((epoch_fn.eager_steps, epoch_fn.replays))
        return seen
    monkeypatch.setattr(train_classify, "scan_epoch", scan_recording)
    d = str(tmp_path)
    best = train_classify.main(
        ["--device", "cpu", "--epochs", "1", "--limit_batches", "2",
         "--batch_size", "8", "--print_freq", "1", "--save_dir", d, "--bf16"]
        + flags)
    assert np.isfinite(best)
    assert built == [(BF16, {torch.float32})]
    assert scans == [(0, 0)]        # every step eager: no warm-up, no graph
    saved = load_training_state(os.path.join(d, "checkpoint.pt"))
    assert saved["step"] == 2
    assert all(v.dtype != BF16 for v in saved["state_dict"].values())
