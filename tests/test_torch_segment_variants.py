"""afan_torch's segmentation variants against afan's: the input-adversarial
step (``advtrain``), and the A-FAN step with input-adversarial training
(``afan --input_adv``), the SAT presets, the multi-layer taps with their
preset, and ``sat_multi`` with ``--mix_all`` and SD ``aspp``, from the same
weights and batch as ``tests/test_torch_segment.py``; the CLI's variant →
config mapping for afan's nine variants; the upsample + CE and PGD-update
calls per step of each weight mode; the step lr policy; ``input_pgd``; and
one CLI run on the CPU.

The input ascent's random start is ``afan``'s draw (``r_inp``, the sixth of
the step's six keys; ``r_init``, the third of three, in ``advtrain``),
patched in for the port's. ``advtrain``'s ascent takes 2 steps where the
CLI's recipe takes its ``--steps``, and the A-FAN family's input ascent one
(random start, sign step, projection) where the CLI's takes 3: the
family's second step meets gradient entries near zero whose sign the two
frameworks' float noise sets differently (25 of 13068 pixels), and one
pixel moved by 2 * gamma moves the stem BatchNorm bias's update by 10%.
The step counts are arguments and config fields, so the path is the same.
``afan``'s steps run without the fused kernel, as in
``tests/test_torch_segment.py``, whose tolerances hold here: losses within
1e-4 relative, each updated parameter and running-statistics tensor within
1e-4 of its norm and each parameter's update within 2e-3 of its norm.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from afan.cli import train_segment as j_train_segment
from afan.core import attack as j_attack
from afan.train import segment_loop as jloop
from afan_torch.cli import train_segment
from afan_torch.core import attack
from afan_torch.models.deeplab import DeepLab
from afan_torch.models.deeplab.modeling import segmentation_param_groups
from afan_torch.train import segment_loop
from afan_torch.train.checkpoint import load_training_state
from afan_torch.train.optim import sgd

import chip_smoke
from test_torch_segment import flax_no_dropout, setup  # noqa: F401
from test_torch_segment import (NC, close, compare_states, jax_state,
                                port_model, recipe_flags)

INPUT_STEPS, ADVTRAIN_STEPS = 1, 2
MULTI = dict(tap_se=3, extra_taps=(1, 2, 4),
             extra_gammas=(0.001 / 255,) * 3, gamma_se=0.1 / 255)
VARIANT_CONFIGS = {
    "afan_input_adv": dict(sd="concat", mix_mask=(0, 0, 1), mix_sd=True,
                           input_adv=True),
    "sat1": dict(sd="concat", mix_mask=(0, 0, 1), input_adv=True,
                 weight_mode="sat_preset", loss_setting=1),
    "sat4": dict(sd="concat", mix_mask=(0, 0, 1), input_adv=True,
                 weight_mode="sat_preset", loss_setting=4),
    "multi": dict(MULTI, sd="concat", spectrum=2, mix_mask=(0, 0),
                  input_adv=True, weight_mode="multi_preset", loss_setting=2),
    "sat_multi_mix_all_aspp": dict(
        MULTI, sd="aspp", spectrum=3, mix_mask=(0, 1, 1), mix_sd=True,
        mix_all=True, input_adv=True, weight_mode="multi_preset"),
}
# The port runs "multi" in float64: with the spectrum on layer 3 the layer-3
# and layer-4 BatchNorm updates are near-cancellations over 3x3 maps, where
# the port's float32 step alone is 4e-3 of the update from its float64 step
# (afan's float32 step 1.2e-3).
FLOAT64 = ("multi",)


def inject_noise(monkeypatch, key, shape, eps, dtype=torch.float32):
    """The port's random start of the input ascent ← ``afan``'s draw."""
    noise = torch.from_numpy(np.array(j_attack.uniform_init(key, shape,
                                                            eps))).to(dtype)
    monkeypatch.setattr(attack, "uniform_init", lambda *_, **__: noise)


def test_input_pgd_clamps_01():
    """``tests/test_core.py:test_input_pgd_clamps_01`` on the port, and the
    same result as afan's ``input_pgd``."""
    for start, sign in ((0.99, 1.0), (0.01, -1.0)):
        x = np.full((4,), start, np.float32)
        got = attack.input_pgd(lambda z: sign * torch.sum(z),
                               torch.from_numpy(x), steps=5, gamma=0.1)
        want = j_attack.input_pgd(lambda z: sign * jnp.sum(z),
                                  jnp.asarray(x), steps=5, gamma=0.1)
        assert 0.0 <= float(got.min()) and float(got.max()) <= 1.0
        close(got.numpy(), want, 1e-6)


def test_advtrain_step(setup, flax_no_dropout, monkeypatch):
    jm, variables, images, labels = setup
    state, tx = jax_state(variables)
    key = jax.random.PRNGKey(2)
    jstep = jloop.make_seg_advtrain_step(jm, tx, steps=ADVTRAIN_STEPS,
                                         fused_ce=False)
    state, metrics = jstep(state, jnp.asarray(images), jnp.asarray(labels),
                           key)
    inject_noise(monkeypatch, jax.random.split(key, 3)[2], images.shape,
                 8.0 / 255)
    tm, opt, sched = port_model(variables)
    out = segment_loop.make_seg_advtrain_step(tm, opt, sched,
                                              steps=ADVTRAIN_STEPS)(
        torch.from_numpy(images), torch.from_numpy(labels))
    close(float(out["loss"]), float(metrics["loss"]))
    compare_states(tm, variables, state)


@pytest.mark.parametrize("name", list(VARIANT_CONFIGS))
def test_variant_step(setup, flax_no_dropout, monkeypatch, name):
    jm, variables, images, labels = setup
    kw = dict(VARIANT_CONFIGS[name], input_adv_steps=INPUT_STEPS)
    state, tx = jax_state(variables)
    key = jax.random.PRNGKey(3)
    jstep = jloop.make_afan_seg_step(
        jm, tx, jloop.SegAfanConfig(fused_ce=False, **kw))
    state, metrics = jstep(state, jnp.asarray(images), jnp.asarray(labels),
                           key)
    cfg = segment_loop.SegAfanConfig(**kw)
    dtype = torch.float64 if name in FLOAT64 else torch.float32
    inject_noise(monkeypatch, jax.random.split(key, 6)[5], images.shape,
                 cfg.input_adv_eps, dtype)
    tm, opt, sched = port_model(variables)
    out = segment_loop.make_afan_seg_step(tm.to(dtype), opt, sched, cfg)(
        torch.from_numpy(images).to(dtype), torch.from_numpy(labels))
    for k in ("loss", "loss_clean", "loss_spectrum", "loss_sd"):
        close(float(out[k]), float(metrics[k]), msg=k)
    compare_states(tm, variables, state)


@pytest.mark.parametrize("mode,setting,n_adv,want", [
    ("sat_preset", 1, 3, (0.25, 0.25)), ("sat_preset", 2, 3, (0.5, 0.5 / 3)),
    ("sat_preset", 3, 3, (0.8, 0.2 / 3)), ("sat_preset", 4, 3, (0.9, 0.1 / 3)),
    ("multi_preset", 1, 5, (0.8, 0.04)), ("multi_preset", 2, 5, (0.6, 0.08)),
    ("final", 3, 3, (0.7, 0.1))])
def test_loss_weights(mode, setting, n_adv, want):
    """The presets' weights (``afan/train/segment_loop.py:466-481``) for
    ``n_adv`` adversarial terms: the flagship's 3 (2 spectrum tails and
    SD); multi's 5 (1 tail, SD and 3 extra taps)."""
    kw = MULTI if n_adv == 5 else {}
    cfg = segment_loop.SegAfanConfig(
        weight_mode=mode, loss_setting=setting, spectrum=3 - (n_adv == 5),
        mix_mask=(0,) * (3 - (n_adv == 5)), **kw)
    assert segment_loop.loss_weights(cfg) == pytest.approx(want)


def test_unknown_preset_raises():
    with pytest.raises(ValueError):
        segment_loop.make_afan_seg_step(
            None, None, None, segment_loop.SegAfanConfig(
                weight_mode="multi_preset", loss_setting=3))


# ---------- launches per step ----------

def tiny_port():
    tm = DeepLab("resnet18", NC, 16)
    tm.reset_parameters(torch.Generator().manual_seed(0))
    return (tm,) + sgd(segmentation_param_groups(tm), lambda c: 0.01, 0.01,
                       0.9, 1e-4)


def counting(monkeypatch, module, name):
    calls = []
    real = getattr(module, name)

    def wrapper(*a, **kw):
        calls.append(1)
        return real(*a, **kw)
    monkeypatch.setattr(module, name, wrapper)
    return calls


@pytest.mark.parametrize("name", ["advtrain", "afan_input_adv", "sat1",
                                  "multi"])
def test_steps_run_the_sites_and_the_update_per_step(setup, monkeypatch,
                                                     name):
    """Per step, as ``chip_smoke.seg_launches_per_step`` counts them: one
    upsample + CE per forward of an ascent step or loss site, one PGD
    update per ascent step; ``sat1`` (``sat_preset``) and
    ``afan_input_adv`` (``final``) run 8 sites at the recipe's one SE and
    one SD step and 3 input steps, ``multi`` (``multi_preset``) 14."""
    _, _, images, labels = setup
    tm, opt, sched = tiny_port()
    if name == "advtrain":
        step = segment_loop.make_seg_advtrain_step(tm, opt, sched, steps=3)
        want = chip_smoke.seg_launches_per_step(None, 3)
    else:
        cfg = segment_loop.SegAfanConfig(**VARIANT_CONFIGS[name])
        step = segment_loop.make_afan_seg_step(tm, opt, sched, cfg)
        want = chip_smoke.seg_launches_per_step(cfg)
        assert want[0] == (14 if name == "multi" else 8)
    sites = counting(monkeypatch, segment_loop, "fused_resize_nll_sums")
    updates = counting(monkeypatch, attack, "pgd_update")
    out = step(torch.from_numpy(images), torch.from_numpy(labels))
    assert np.isfinite([float(v) for v in out.values()]).all()
    assert (len(sites), len(updates)) == want


# ---------- the CLI ----------

VARIANT_FLAGS = [
    ("baseline", []), ("advtrain", ["--steps", "3"]), ("afan", []),
    ("afan", ["--input_adv"]), ("sat", ["--loss_settings", "3"]),
    ("sat_clean", []), ("multi", ["--mix_all"]), ("multi_clean", []),
    ("sat_multi", ["--mix_all", "--loss_settings", "2"]),
    ("sat_multi_clean", ["--pertub_idx_sd", "aspp"])]


def built_step(module, build, args, monkeypatch):
    """(factory, its config or keyword arguments) that ``build`` calls for
    ``args`` in ``module``."""
    got = []
    for name in ("make_seg_base_step", "make_seg_advtrain_step",
                 "make_afan_seg_step"):
        monkeypatch.setattr(module, name, lambda *a, name=name, **kw: (
            got.append((name, a[-1] if name == "make_afan_seg_step"
                        else {k: v for k, v in kw.items()
                              if k != "fused_ce"}))))
    build(args)
    return got[0]


@pytest.mark.parametrize("variant,extra", VARIANT_FLAGS,
                         ids=[" ".join([v] + e) for v, e in VARIANT_FLAGS])
def test_cli_maps_each_variant_as_afan(variant, extra, monkeypatch):
    """The recipe's flags with each of afan's nine variants: the port's CLI
    builds the step that afan's builds, with afan's config (the A-FAN
    family) or arguments (``advtrain``)."""
    flags = ([f for f in recipe_flags(N="1", GAMMASE="0.02", MIX="01")
              if f != "--bf16"] + ["--variant", variant] + extra)
    j_args = j_train_segment.get_parser().parse_args(flags)
    args = train_segment.get_parser().parse_args(flags)
    want = built_step(j_train_segment, lambda a: j_train_segment.
                      _build_variant_step(a, None, None, False), j_args,
                      monkeypatch)
    got = built_step(train_segment, lambda a: train_segment.build_step(
        a, None, None, None), args, monkeypatch)
    assert got[0] == want[0]
    if got[0] != "make_afan_seg_step":
        assert got[1] == want[1]
        return
    cfg, j_cfg = got[1], want[1]
    fields = cfg.__dataclass_fields__
    assert {f: getattr(cfg, f) for f in fields} == {
        f: getattr(j_cfg, f) for f in fields}
    assert j_cfg == jloop.SegAfanConfig(
        fused_ce=False, **{f: getattr(cfg, f) for f in fields})


class _Schedule(Exception):
    pass


def test_step_lr_policy_matches_afan(tmp_path, monkeypatch):
    """``--lr_policy step --step_size 3``: the lr of each count, in both
    parameter groups, as afan's CLI schedules it."""
    monkeypatch.chdir(tmp_path)
    flags = ["--dataset", "synthetic", "--data_root", "/nonexistent",
             "--crop_size", "32", "--batch_size", "2", "--lr", "0.1",
             "--lr_policy", "step", "--step_size", "3"]

    def capture(schedule, *a, **kw):
        raise _Schedule(schedule)
    monkeypatch.setattr(j_train_segment, "segmentation_tx", capture)
    with pytest.raises(_Schedule) as hit:
        j_train_segment.main(flags)
    want = hit.value.args[0]
    args = train_segment.get_parser().parse_args(flags)
    w = torch.nn.Parameter(torch.zeros(2))
    b = torch.nn.Parameter(torch.zeros(2))
    opt, sched = sgd([{"params": [b], "lr_scale": 0.1}, {"params": [w]}],
                     train_segment.lr_schedule(args), args.lr)
    lrs = []
    for count in range(11):
        lr = float(want(jnp.asarray(count)))
        np.testing.assert_allclose([g["lr"] for g in opt.param_groups],
                                   [0.1 * lr, lr], rtol=1e-6)
        lrs.append(lr)
        opt.step()
        sched.step()
    np.testing.assert_allclose(lrs[::3], [0.1, 0.01, 1e-3, 1e-4], rtol=1e-6)


def test_cli_runs_a_variant_on_cpu(tmp_path, monkeypatch):
    """``--variant multi --mix_all --loss_settings 2`` with the step lr
    policy and grad-mode PGD: two iterations, a validation and a
    checkpoint, on the cheapest model (SMOKE_TINY's)."""
    monkeypatch.chdir(tmp_path)
    score = train_segment.main(
        ["--device", "cpu", "--dataset", "synthetic", "--crop_size", "32",
         "--batch_size", "2", "--lr", "0.1", "--limit_itrs", "2",
         "--val_interval", "2", "--print_interval", "1", "--variant",
         "multi", "--mix_all", "--loss_settings", "2", "--lr_policy",
         "step", "--step_size", "1", "--pgd_step_mode", "grad",
         "--model", "deeplabv3plus_mobilenet"])
    assert np.isfinite(score)
    exp = os.listdir("checkpoints")[0]
    saved = load_training_state(os.path.join(
        "checkpoints", exp, "latest_deeplabv3plus_mobilenet_synthetic.pt"))
    assert saved["cur_itrs"] == 2
    assert saved["optimizer_state"]["param_groups"][1]["lr"] == \
        pytest.approx(1e-3)
