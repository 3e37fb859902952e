"""afan_torch's detection variants against afan's: the input-adversarial
step (``advtrain``), and the A-FAN family's SAT (input-adversarial clean
term, ``sat_preset``), multi-layer (input-adversarial, three SE taps, SD on
the pooled ROI vector) and single-point variants, from the same weights and
batch as ``tests/test_torch_detect_train.py``; the CLI's variant → config
mapping for all 13 variants; the proposal-NMS and PGD-update calls per step
of each weight mode; and one CLI run on the CPU.

Randomness is ``afan``'s: the input ascent's random start is drawn from
``afan``'s key (``r_inp``, the sixth of the step's six keys; ``r_init``,
the third of three, in ``advtrain``) and patched in for the port's draw;
the samples are ``afan``'s targets (``share_proposals``) or, where every
forward samples its own (``advtrain``), ``afan``'s sampling uniforms.
The A-FAN family's input ascents take 2 steps, where the CLI's take 5, to
keep the suite short; ``advtrain``'s takes one, where the CLI's takes 5:
with two, its updated parameters differ from afan's by 7.5e-4 of their
norm, as a second sign step meets gradient entries near zero whose sign
float noise sets (``tests/test_torch_segment_variants.py`` measures the
mechanism). The step counts are arguments and config fields, so the path
is the same.

Tolerances are those of ``tests/test_torch_detect_train.py``: losses
within ``1e-4 * max|x|``, updated parameters within 1e-4 of their norm and
each update within 2e-3 of its norm, frozen parameters bit-unchanged.
"""
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from afan.cli import train_detect as j_train_detect
from afan.core import attack as j_attack
from afan.ops import roi_align as j_roi_align
from afan.train import detect_loop as j_loop
from afan_torch.cli import train_detect
from afan_torch.core import attack
from afan_torch.models.frcnn import sampling
from afan_torch.ops import nms as tnms
from afan_torch.ops import roi_align
from afan_torch.train import detect_loop
from afan_torch.train.optim import sgd, warmup_multistep_schedule

import chip_smoke
from test_torch_detect_train import setup  # noqa: F401 (the fixture)
from test_torch_detect_train import (LR, batched_priorities, close,
                                     compare_states, counting, j_targets,
                                     jax_state, port_model, smoke_tiny_flags,
                                     t, to_torch)
from torch_threads import one_torch_thread  # noqa: F401

INPUT_STEPS, ADVTRAIN_STEPS = 2, 1
VARIANT_CONFIGS = {
    "sat": dict(taps_se=(2,), gammas_se=(1.0 / 255,), spectrum=3,
                mix_mask=(0, 1, 0), sd=None, weight_mode="sat_preset",
                loss_setting=2, input_adv=True),
    "multi": dict(taps_se=(3, 1, 2), gammas_se=(1.0 / 255, 0.1 / 255,
                                                0.1 / 255),
                  spectrum=2, mix_mask=(0, 0), sd="roi", mix_sd=True,
                  input_adv=True),
    "single": dict(taps_se=(2,), gammas_se=(1.0 / 255,), spectrum=2,
                   mix_mask=(0, 0), sd=None, weight_mode="single"),
}

def port_optimizer(tm):
    return sgd(detect_loop.detection_param_groups(tm),
               warmup_multistep_schedule(LR, [10], 0.1, 1.0 / 3, 5), LR, 0.9,
               5e-4)


def inject_noise(monkeypatch, key, shape, eps):
    """The port's random start of the input ascent ← ``afan``'s draw."""
    noise = t(np.asarray(j_attack.uniform_init(key, shape, eps)))
    monkeypatch.setattr(attack, "uniform_init", lambda *_, **__: noise)


@pytest.mark.parametrize("mode", ["align", "pooling"])
def test_pooler_splits_tied_maxima_as_afan(mode):
    """The pooler's max over tied values (ReLU zeros under a whole bin)
    sends each of them an equal share of the gradient, as afan's
    ``jnp.max`` does: the gradient with respect to a feature with zeros
    equals afan's."""
    rng = np.random.RandomState(7)
    feat = np.maximum(rng.randn(2, 6, 10, 12), 0).astype(np.float32)
    feat[:, :, 2:6, 3:8] = 0.0                           # a block of ties
    xy = rng.rand(2, 5, 2) * np.array([12 * 16, 10 * 16]) * 0.6
    boxes = np.concatenate([xy, xy + 24 + rng.rand(2, 5, 2) * 90],
                           -1).astype(np.float32)
    cot = rng.randn(10, 6, 7, 7).astype(np.float32)
    f = t(feat).requires_grad_(True)
    got = roi_align.pool_rois(f, t(boxes), None, mode)
    (g,) = torch.autograd.grad(got, f, t(cot))
    jf = jnp.asarray(feat.transpose(0, 2, 3, 1))
    bidx = jnp.repeat(jnp.arange(2, dtype=jnp.int32), 5)
    jout, vjp = jax.vjp(lambda x: j_roi_align.pool_rois(
        x, jnp.asarray(boxes.reshape(-1, 4)), bidx, mode), jf)
    close(got.detach().permute(0, 2, 3, 1).numpy(), jout, 1e-6)
    (jg,) = vjp(jnp.asarray(cot.transpose(0, 2, 3, 1)))
    close(g.permute(0, 2, 3, 1).numpy(), jg, 1e-5)


def test_feature_gradient_at_tap_3_matches_afan(setup):
    """The multi variants' main SE tap, layer 3, is the pooler's input
    (36% ReLU zeros here): the SE ascent's gradient there equals afan's."""
    jm, variables, images, jgt, tgt = setup
    key = jax.random.PRNGKey(9)
    jt = j_targets(jm, variables, images, jgt, key)
    x = jnp.asarray(images)
    feat = jax.jit(lambda v: jm.apply(v, x, 3, method=jm.backbone_head))(
        variables)
    assert float(jnp.mean(feat == 0)) > 0.2
    want = jax.jit(jax.grad(lambda f: jm.apply(
        variables, x, *jt, key, 3, f,
        method=jm.losses_from_targets).total()))(feat)
    f = t(feat).permute(0, 3, 1, 2).contiguous().requires_grad_(True)
    loss = port_model(variables).losses_from_targets(
        t(images), *to_torch(jt), 3, f).total()
    (g,) = torch.autograd.grad(loss, f)
    close(g.permute(0, 2, 3, 1).numpy(), want, msg="SE gradient at tap 3")


def test_advtrain_step(setup, monkeypatch):
    jm, variables, images, jgt, tgt = setup
    state, tx = jax_state(variables)
    key = jax.random.PRNGKey(21)
    jstep = j_loop.make_advtrain_det_step(jm, tx, steps=ADVTRAIN_STEPS)
    state, metrics = jstep(state, jnp.asarray(images), *jgt, key)
    # `afan/train/detect_loop.py:106`: every ascent forward samples from
    # r_attack, the loss forward from r_loss
    r_attack, r_loss, r_init = jax.random.split(key, 3)
    draws = []
    for k in [r_attack] * ADVTRAIN_STEPS + [r_loss]:
        keys = jax.random.split(k, 2 * len(images))
        draws += [keys[:len(images)], keys[len(images):]]
    draws = iter(draws)
    monkeypatch.setattr(sampling, "draw_priorities",
                        lambda shape, g, device=None: batched_priorities(
                            next(draws), shape[-1]))
    inject_noise(monkeypatch, r_init, images.shape, 8.0 / 255)
    tm = port_model(variables)
    step = detect_loop.make_advtrain_det_step(tm, *port_optimizer(tm),
                                              steps=ADVTRAIN_STEPS)
    out = step(t(images), *tgt)
    assert next(draws, None) is None
    close(float(out["loss"]), float(metrics["loss"]), msg="loss")
    compare_states(tm, variables, state)


@pytest.mark.parametrize("variant", list(VARIANT_CONFIGS))
def test_variant_step(setup, monkeypatch, variant):
    jm, variables, images, jgt, tgt = setup
    kw = dict(VARIANT_CONFIGS[variant], input_adv_steps=INPUT_STEPS)
    state, tx = jax_state(variables)
    key = jax.random.PRNGKey(22)
    jstep = j_loop.make_afan_det_step(jm, tx, j_loop.DetAfanConfig(**kw))
    # the step's own key split (`afan/train/detect_loop.py:221`)
    _, r_sd, r_clean, _, _, r_inp = jax.random.split(key, 6)
    targets = {"clean": to_torch(j_targets(jm, variables, images, jgt,
                                           r_clean)),
               "sd": to_torch(j_targets(jm, variables, images, jgt, r_sd))}
    state, metrics = jstep(state, jnp.asarray(images), *jgt, key)
    cfg = detect_loop.DetAfanConfig(**kw)
    inject_noise(monkeypatch, r_inp, images.shape, cfg.input_adv_eps)
    tm = port_model(variables)
    out = detect_loop.make_afan_det_step(tm, *port_optimizer(tm), cfg)(
        t(images), *tgt, targets=targets)
    for k in ("loss", "loss_clean", "loss_spectrum", "loss_sd"):
        close(float(out[k]), float(metrics[k]), msg=k)
    assert float(out["loss_spectrum"]) > 0
    assert (float(out["loss_sd"]) > 0) == (cfg.sd is not None)
    compare_states(tm, variables, state)


def test_sd_loss_stays_out_of_the_presets(setup):
    """Under ``sat_preset`` and ``single`` an SD tap still runs its ascent
    and reports ``loss_sd``, but the loss and the update leave it out, as
    ``afan``'s weight modes do: the reported loss is the preset's mix of
    the clean and SE terms."""
    jm, variables, images, jgt, tgt = setup
    for mode, setting, (c0, cse) in (("sat_preset", 3, (0.68, 0.08)),
                                     ("single", 1, (0.5, 0.5))):
        cfg = detect_loop.DetAfanConfig(
            taps_se=(2,), gammas_se=(1.0 / 255,), spectrum=3,
            mix_mask=(0, 0, 0), sd="roi", weight_mode=mode,
            loss_setting=setting)
        assert detect_loop.loss_weights(cfg) == pytest.approx((c0, cse, 0))
        tm = port_model(variables)
        out = detect_loop.make_afan_det_step(tm, *port_optimizer(tm), cfg)(
            t(images), *tgt, torch.Generator().manual_seed(0))
        assert float(out["loss_sd"]) > 0
        np.testing.assert_allclose(
            float(out["loss"]), c0 * float(out["loss_clean"])
            + cse * float(out["loss_spectrum"]), rtol=1e-6)


# ---------- launches per step ----------

@pytest.mark.parametrize("variant", ["advtrain", "afan", "sat", "multi",
                                     "single"])
def test_steps_run_the_proposal_nms_and_the_update_per_step(
        setup, monkeypatch, variant):
    """Per step, as ``chip_smoke.det_launches_per_step`` counts them:
    ``advtrain`` one NMS per forward (2 ascent steps and the loss), one
    update per ascent step; the A-FAN family with ``share_proposals`` one
    NMS for the shared sample and one for the SD pass, and one update per
    ascent step of the input and of each tap."""
    jm, variables, images, jgt, tgt = setup
    tm = port_model(variables)
    opt, sched = port_optimizer(tm)
    if variant == "advtrain":
        step = detect_loop.make_advtrain_det_step(tm, opt, sched,
                                                  steps=INPUT_STEPS)
        want = chip_smoke.det_launches_per_step(None, INPUT_STEPS)
    else:
        kw = VARIANT_CONFIGS.get(variant, dict(
            taps_se=(2,), gammas_se=(1.0 / 255,), spectrum=3,
            mix_mask=(0, 1, 0), sd="roi", input_adv=True))
        cfg = detect_loop.DetAfanConfig(input_adv_steps=INPUT_STEPS, **kw)
        step = detect_loop.make_afan_det_step(tm, opt, sched, cfg)
        want = chip_smoke.det_launches_per_step(cfg)
    nms_calls = counting(monkeypatch, tnms, "nms_sorted_mask")
    updates = counting(monkeypatch, attack, "pgd_update")
    out = step(t(images), *tgt, torch.Generator().manual_seed(0))
    assert np.isfinite([float(v) for v in out.values()]).all()
    assert (len(nms_calls), len(updates)) == want


# ---------- the CLI ----------

class _Factory(Exception):
    pass


@pytest.mark.parametrize("variant", j_train_detect.VARIANTS)
def test_cli_maps_each_variant_as_afan(tmp_path, monkeypatch, variant):
    """Each of afan's 13 variants, from the recipe's A-FAN flags and
    ``--loss_settings 3``: the CLI builds the step that afan's builds
    (``baseline`` and ``advtrain`` with the factories' defaults, which
    agree), the A-FAN family's with afan's config."""
    flags = ["--variant", variant, "--loss_settings", "3", "--mix_layer",
             "0011", "--gamma_se", "1.0", "--gamma_sd", "0.1",
             "--sd_adv_loss_weight", "0.3", "--only_roi_sd"]
    built = []
    for name in ("baseline", "advtrain", "afan"):
        def factory(*a, name=name):
            built.append((name, a[3] if name == "afan" else None))
            raise _Factory
        monkeypatch.setattr(train_detect, f"make_{name}_det_step", factory)
    with pytest.raises(_Factory):
        train_detect.main(flags + ["--device", "cpu", "-o", str(tmp_path)]
                          + smoke_tiny_flags())
    (name, cfg), = built
    assert name == {"baseline": "baseline", "advtrain": "advtrain"}.get(
        variant, "afan")
    if name == "advtrain":
        got = inspect.signature(detect_loop.make_advtrain_det_step)
        want = inspect.signature(j_loop.make_advtrain_det_step)
        for k in ("steps", "gamma", "eps", "randinit"):
            assert got.parameters[k].default == want.parameters[k].default
    if name != "afan":
        return
    want = j_train_detect.afan_config_for(
        j_train_detect.get_parser().parse_args(flags))
    fields = cfg.__dataclass_fields__
    assert want == j_loop.DetAfanConfig(
        **{f: getattr(cfg, f) for f in fields})
    assert cfg.loss_setting == 3 and cfg.input_adv_steps == 5


def test_cli_runs_a_variant_on_cpu(tmp_path):
    """``--variant sat_multi``: input PGD, three SE taps, the SD tap; two
    steps, a checkpoint and the mAP."""
    out = str(tmp_path)
    mean_ap = train_detect.main(["--device", "cpu", "--variant", "sat_multi",
                                 "-o", out] + smoke_tiny_flags())
    assert 0.0 <= mean_ap <= 1.0
    saved = torch.load(f"{out}/model-2.pt", weights_only=True)
    assert saved["step"] == 2
