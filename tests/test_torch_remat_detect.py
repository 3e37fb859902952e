"""afan_torch's detection step with ``remat_tails`` against afan's
``jax.checkpoint`` of the spectrum tails, and against the port's own step
without recomputation (``tests/test_torch_detect_train.py``'s model, batch
and tolerances).

- The A-FAN step with ``share_proposals`` on and off and with the RPN SD
  tap: its losses and update against ``afan``'s; against the port's step
  without recomputation bit for bit, with the explicit generator's state
  after the step equal. Without ``share_proposals`` each tail samples its
  own: ``afan``'s uniforms are injected by a draw that reads a tag from the
  step's generator, so that the recompute, which replays the generator,
  gets the forward's sample again, as ``afan``'s key gives it.
- The proposal NMS and PGD-update calls per step, as
  ``chip_smoke.det_launches_per_step`` counts them.
- ``afan``'s detection backbone, which recomputes its four stages (the
  default of ``afan``'s ``ResNetTorso``, which its ``FasterRCNN`` keeps),
  against the port's, which does not: the SE ascent's feature gradient and
  the parameter gradients of the four losses.
"""
import jax
import jax.numpy as jnp
import pytest
import torch

from afan.train import detect_loop as j_detect_loop
from afan_torch.core import attack
from afan_torch.interop.from_jax import frcnn_variables_to_state_dict
from afan_torch.models.frcnn import sampling
from afan_torch.ops import nms as tnms
from afan_torch.train import detect_loop
from afan_torch.train.optim import sgd, warmup_multistep_schedule

import chip_smoke
import test_torch_detect_train as det
from test_torch_coco import RPN, afan_sd_priorities
from test_torch_detect_train import setup  # noqa: F401 (the fixture)
from test_torch_remat import state_equal
from torch_threads import one_torch_thread  # noqa: F401


DET_CASES = {
    "shared": dict(det.AFAN),
    "resample": dict(det.AFAN, share_proposals=False),
    "rpn": dict(RPN),
}


def tagged_draws(monkeypatch, keys):
    """The port's sampling uniforms ← ``afan``'s, one ``keys`` entry per
    draw in the forwards' order. Each draw reads a tag from the generator
    and a tag met before gets its first draw's uniforms again, as a
    recomputed forward must."""
    order, seen = iter(keys), {}

    def draw(shape, g, device=None):
        tag = int(torch.randint(0, 1 << 62, (1,), generator=g))
        if tag not in seen:
            seen[tag] = det.batched_priorities(next(order), shape[-1])
        return seen[tag]
    monkeypatch.setattr(sampling, "draw_priorities", draw)
    return order


def det_port_step(variables, kw, images, tgt, targets, remat_tails):
    tm = det.port_model(variables)
    opt, sched = sgd(detect_loop.detection_param_groups(tm),
                     warmup_multistep_schedule(det.LR, [10], 0.1, 1.0 / 3, 5),
                     det.LR, 0.9, 5e-4)
    step = detect_loop.make_afan_det_step(
        tm, opt, sched, detect_loop.DetAfanConfig(remat_tails=remat_tails,
                                                  **kw))
    g = torch.Generator().manual_seed(6)
    out = step(det.t(images), *tgt, g, targets=dict(targets))
    return tm, out, g.get_state()


@pytest.mark.parametrize("case", list(DET_CASES))
def test_det_afan_step(setup, monkeypatch, case):
    jm, variables, images, jgt, tgt = setup
    kw = DET_CASES[case]
    state, tx = det.jax_state(variables)
    key = jax.random.PRNGKey(15)
    jstep = j_detect_loop.make_afan_det_step(
        jm, tx, j_detect_loop.DetAfanConfig(remat_tails=True, **kw))
    # the step's own key split (`afan/train/detect_loop.py:221`)
    r_se, r_sd, r_clean, r_spec, _, _ = jax.random.split(key, 6)
    targets = {"clean": det.to_torch(det.j_targets(jm, variables, images,
                                                   jgt, r_clean))}
    if case == "rpn":
        targets["sd_priorities"] = afan_sd_priorities(r_sd)
    else:
        targets["sd"] = det.to_torch(det.j_targets(jm, variables, images,
                                                   jgt, r_sd))
    state, metrics = jstep(state, jnp.asarray(images), *jgt, key)
    runs = {}
    for recompute in (False, True):
        if case == "resample":
            keys = []
            for k in [r_se] + list(jax.random.split(r_spec,
                                                    kw["spectrum"] - 1)):
                split = jax.random.split(k, 2 * len(images))
                keys += [split[:len(images)], split[len(images):]]
            left = tagged_draws(monkeypatch, keys)
        runs[recompute] = det_port_step(variables, kw, images, tgt, targets,
                                        recompute)
        if case == "resample":
            assert next(left, None) is None
    (tm, out, g_state), (plain_tm, plain_out, plain_g) = (runs[True],
                                                          runs[False])
    assert torch.equal(g_state, plain_g)
    for k in ("loss", "loss_clean", "loss_spectrum", "loss_sd"):
        assert torch.equal(out[k], plain_out[k]), k
        det.close(float(out[k]), float(metrics[k]), msg=k)
    assert float(out["loss_spectrum"]) > 0
    state_equal(tm.state_dict(), plain_tm.state_dict())
    det.compare_states(tm, variables, state)


def test_afans_recomputed_detection_backbone_matches_the_ports(setup):
    """``afan``'s detection model recomputes its torso's four stages (its
    ``ResNetTorso`` default, which its ``FasterRCNN`` keeps); the port's
    does not. The SE ascent's gradient at tap 2 and the parameter
    gradients of the four losses agree."""
    jm, variables, images, jgt, tgt = setup
    assert jm.cfg.backbone == "resnet18"
    key = jax.random.PRNGKey(16)
    jt = det.j_targets(jm, variables, images, jgt, key)
    targets = det.to_torch(jt)
    x = jnp.asarray(images)

    def j_total(params, f):
        v = {"params": params, "batch_stats": variables["batch_stats"]}
        return jm.apply(v, x, *jt, key, 2, f,
                        method=jm.losses_from_targets).total()

    feat = jax.jit(lambda v: jm.apply(v, x, 2, method=jm.backbone_head))(
        variables)
    want_gp, want_gf = jax.jit(jax.grad(j_total, argnums=(0, 1)))(
        variables["params"], feat)
    tm = det.port_model(variables)
    f = det.t(feat).permute(0, 3, 1, 2).contiguous().requires_grad_(True)
    tm.losses_from_targets(det.t(images), *targets, 2, f).total().backward()
    det.close(f.grad.permute(0, 2, 3, 1).numpy(), want_gf,
              msg="SE gradient")
    want = frcnn_variables_to_state_dict(
        {"params": jax.device_get(want_gp),
         "batch_stats": variables["batch_stats"]})
    compared = 0
    for name, p in tm.named_parameters():
        if name.startswith("features.layer3") and p.grad is not None:
            det.close(p.grad.numpy(), want[name].numpy(), msg=name)
            compared += 1
    assert compared > 5


@pytest.mark.parametrize("case", list(DET_CASES))
def test_det_step_launches_as_the_smoke_script_counts(setup, monkeypatch,
                                                      case):
    """Per step with ``remat_tails``: the proposal NMS of a tail that
    samples its own runs again in its recompute; the updates do not
    change (``chip_smoke.det_launches_per_step``)."""
    jm, variables, images, jgt, tgt = setup
    cfg = detect_loop.DetAfanConfig(remat_tails=True, **DET_CASES[case])
    tm = det.port_model(variables)
    opt, sched = sgd(detect_loop.detection_param_groups(tm),
                     warmup_multistep_schedule(det.LR, [10], 0.1, 1.0 / 3, 5),
                     det.LR, 0.9, 5e-4)
    step = detect_loop.make_afan_det_step(tm, opt, sched, cfg)
    nms_calls = det.counting(monkeypatch, tnms, "nms_sorted_mask")
    updates = det.counting(monkeypatch, attack, "pgd_update")
    step(det.t(images), *tgt, torch.Generator().manual_seed(0))
    assert (len(nms_calls), len(updates)) == \
        chip_smoke.det_launches_per_step(cfg)
    if not cfg.share_proposals:
        assert len(nms_calls) == chip_smoke.det_launches_per_step(
            detect_loop.DetAfanConfig(**DET_CASES[case]))[0] + \
            cfg.spectrum - 1
