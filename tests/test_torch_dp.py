"""afan_torch's data-parallel steps (``--num_devices 2``) against afan's,
one case per section of afan's multi-device dryrun
(``__graft_entry__.py:147-273``): ``alfa``, ``learnable``, ``det``,
``det-rpn`` and ``seg``; and the three trainers' CLIs at
``--num_devices 2 --device cpu``.

The port runs each step at world 2, two gloo processes on the CPU
(``afan_torch.parallel.launch``, rank side in ``tests/torch_dp_ranks.py``,
which imports no jax), each on its rows of the global batch, and at world
1, one process on the whole batch. afan's side is its jitted step:

- ``alfa`` and ``learnable`` on ``make_mesh(2)`` of the conftest's 8 CPU
  devices, the batch sharded and the state replicated, as the dryrun runs
  them;
- ``det``, ``det-rpn`` and ``seg`` on one device on the same global batch:
  an afan step on N devices computes the function of its 1-device step
  (GSPMD reduces every statistic and mean over the global batch), and their
  mesh compiles take minutes (``MULTICHIP_r05.json``: 177 s for det, 157 s
  for seg).

Noise and samples are injected as in the one-process parity tests: the
model files' sizes, afan's sampled targets (``det``), its RPN SD uniforms
(``det-rpn``), no random start. ``seg``'s batch has 25 ignored pixels on
rank 0 and none on rank 1, so the global valid-pixel count matters.

Tolerances: the world-2 port against afan as the one-process parity tests
hold the port (losses within 1e-4 relative; every parameter, running
statistic and momentum buffer within 1e-4 of its norm). The world-2 port
against its own world-1 step: losses and metrics within 1e-5 relative, and
all parameters and running statistics together within 1e-5 of their norm
(not each tensor: AFN divides by each position's deviation over the
channels, which at near-zero activations magnifies the float noise between
convolutions of different batch sizes some hundredfold, and a BatchNorm
shift a few steps from zero can take 1e-4 of its own small norm); the
world-1 step goes on from the world-2 ascents' perturbations. The ascents
step by
``gamma * sign(g)``, and where ``g`` is within float noise of zero the two
worlds (whose convolutions see batches of different sizes) can take
opposite signs; the world-1 step's own ascents must equal the world-2 ones
but for at most ``FLIP_FRACTION`` of the elements, as the one-process
parity tests allow between the frameworks.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from afan.parallel import mesh as jmesh
from afan.train import detect_loop as jdet_loop
from afan.train import loop as jloop
from afan.train import optim as joptim
from afan.train import segment_loop as jseg_loop
from afan.train.loop import TrainState
from afan_torch.cli import train_classify, train_detect, train_segment
from afan_torch.interop.from_jax import (deeplab_variables_to_state_dict,
                                         frcnn_variables_to_state_dict,
                                         resnet_s_variables_to_state_dict)
from afan_torch.parallel.launch import launch

import torch_dp_ranks
import test_torch_classify as tcls
import test_torch_coco as tcoco
import test_torch_detect_train as tdet
import test_torch_segment as tseg
from test_torch_classify import variables  # noqa: F401
from test_torch_detect_train import setup as det_setup  # noqa: F401
from test_torch_segment import flax_no_dropout  # noqa: F401
from test_torch_segment import setup as seg_setup  # noqa: F401
from torch_threads import one_torch_thread  # noqa: F401

AFAN_REL = 1e-4     # world 2 against afan (the parity tests' tolerance)
WORLD_REL = 1e-5    # world 2 against world 1
FLIP_FRACTION = 1e-3
CLI_REL = 1e-3      # a CLI run at world 2 against world 1 (see the test)
ALFA = dict(tap=5, steps=2)
LEARNABLE = dict(taps=(2, 5, 7), steps=1)
SEG = dict(tap_se=2, sd="concat", spectrum=3, mix_mask=(0, 0, 1),
           mix_sd=True)


def close(got, want, rel, msg=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, msg
    err = np.abs(got - want).max()
    assert err <= rel * max(np.abs(want).max(), 1e-6), (msg, err)


def close_l2(got, want, rel, msg=""):
    err = np.linalg.norm(np.asarray(got, np.float64) - want) / max(
        np.linalg.norm(want), 1e-12)
    assert err <= rel, (msg, err)


def port_runs(section, payload, recomputed=None):
    """(world 2, world 1) results; the two ranks' states must agree
    exactly (the same summed gradients on replicated weights). The world-1
    run replays the world-2 ascents' results; its own may differ from them
    by sign flips only. ``recomputed``, the payload with recomputation on,
    runs in the same launch after ``payload`` and must give its step bit
    for bit on each rank (``tests/test_torch_remat.py`` at world 1)."""
    payloads = [payload] + ([recomputed] if recomputed else [])
    both = launch(torch_dp_ranks.runs, 2, (section, payloads), device="cpu",
                  timeout=600)
    two = [r[0] for r in both]
    for plain, *others in both:
        for again in others:
            assert again["metrics"] == plain["metrics"]
            for k, v in plain["state"].items():
                np.testing.assert_array_equal(again["state"][k], v,
                                              err_msg=k)
            for k, v in plain["momenta"].items():
                np.testing.assert_array_equal(again["momenta"][k], v,
                                              err_msg=k)
    assert [r["rank"] for r in two] == [0, 1]
    assert all(r["size"] == 2 for r in two)
    for k, v in two[0]["state"].items():
        np.testing.assert_array_equal(v, two[1]["state"][k], err_msg=k)
    assert two[0]["metrics"] == two[1]["metrics"]
    replay = [np.concatenate([a0, a1]) for (a0, _), (a1, _) in zip(
        two[0]["ascents"], two[1]["ascents"])]
    one = torch_dp_ranks.run(0, section, dict(payload, replay=replay))
    assert one["size"] == 1 and len(one["ascents"]) == len(replay) > 0
    for i, ((own, gamma), other) in enumerate(zip(one["ascents"], replay)):
        flips = np.abs(own - other) > gamma / 2
        assert flips.mean() <= FLIP_FRACTION, (i, flips.mean())
    return two[0], one


def against_world_one(two, one):
    """Metrics within ``WORLD_REL``; every parameter and running statistic
    together within ``WORLD_REL`` of their norm."""
    for m2, m1 in zip(two["metrics"], one["metrics"]):
        for k, v in m1.items():
            close(m2[k], v, WORLD_REL, f"world 2 {k}")
    keys = [k for k in one["state"] if not k.endswith("num_batches_tracked")]
    close_l2(np.concatenate([np.ravel(two["state"][k]) for k in keys]),
             np.concatenate([np.ravel(one["state"][k]) for k in keys]),
             WORLD_REL, "world 2: all parameters and statistics")


# ---------- afan's sides ----------

def classify_case(variables, section):
    jm, vs = variables
    jsched, _ = tcls.schedules()
    if section == "learnable":
        tx = joptim.learnable_tx(jsched, tcls.W_LR, tcls.MOMENTUM, tcls.WD)
        jstep = jloop.make_learnable_step(jm, tx,
                                          jloop.LearnableConfig(**LEARNABLE))
        cfg = LEARNABLE
    else:
        tx = joptim.sgd(jsched, tcls.MOMENTUM, tcls.WD)
        jstep = jloop.make_alfa_step(jm, tx, jloop.AlfaConfig(**ALFA))
        cfg = ALFA
    mesh = jmesh.make_mesh(2)
    jmesh.check_divisible(tcls.B, mesh)
    state = jmesh.replicate_state(mesh, TrainState.create(vs, tx))
    batches, want = [], []
    for i in range(2):
        x, y = tcls.batch(i + 1)
        xb, yb = jmesh.shard_batch(mesh, jnp.asarray(x), jnp.asarray(y))
        state, m = jstep(state, xb, yb,
                         jmesh.replicate_state(mesh, jax.random.PRNGKey(i)))
        want.append({k: np.asarray(v) for k, v in m.items()})
        batches.append({"inputs": [x, y]})
    payload = dict(blocks=tcls.BLOCKS, classes=tcls.NC, init_w=1.0 / 9,
                   state_dict=resnet_s_variables_to_state_dict(vs),
                   lr=tcls.LR, milestones=[tcls.MILESTONE], w_lr=tcls.W_LR,
                   momentum=tcls.MOMENTUM, wd=tcls.WD, cfg=cfg,
                   batches=batches)
    return payload, want, state, ("loss", "accuracy")


def check_classify_state(got, state):
    want = resnet_s_variables_to_state_dict(jax.device_get(
        {"params": state.params, "batch_stats": state.batch_stats}))
    for k, w in want.items():
        if not k.endswith("num_batches_tracked"):
            close_l2(got["state"][k], w.numpy(), AFAN_REL, k)
    want_m = resnet_s_variables_to_state_dict(
        {"params": tcls.traces(jax.device_get(state.opt_state))})
    assert set(want_m) == set(got["momenta"])
    for k, w in want_m.items():
        close_l2(got["momenta"][k], w.numpy(), AFAN_REL, f"momentum {k}")


def det_case(setup, section):
    jm, variables, images, jgt, tgt = setup
    tx = jdet_loop.detection_tx(tdet.j_schedule(tdet.LR, [10], 0.1,
                                                1.0 / 3, 5), 0.9, 5e-4)
    state = TrainState.create(variables, tx)
    key = jax.random.PRNGKey(21)
    _, r_sd, r_clean, _, _, _ = jax.random.split(key, 6)
    clean = tdet.to_torch(tdet.j_targets(jm, variables, images, jgt,
                                         r_clean))
    if section == "det":
        cfg = tdet.AFAN
        targets = {"clean": clean, "sd": tdet.to_torch(tdet.j_targets(
            jm, variables, images, jgt, r_sd))}
    else:
        cfg = tcoco.RPN_ONLY
        targets = {"clean": clean,
                   "sd_priorities": tcoco.afan_sd_priorities(r_sd)}
    jstep = jdet_loop.make_afan_det_step(jm, tx,
                                         jdet_loop.DetAfanConfig(**cfg))
    state, m = jstep(state, jnp.asarray(images), *jgt, key)
    inputs = [images] + [t.numpy() for t in tgt]
    payload = dict(frcnn=tdet.TINY, cfg=cfg, lr=tdet.LR,
                   state_dict=frcnn_variables_to_state_dict(variables),
                   batches=[{"inputs": inputs, "targets": targets}])
    return payload, [{k: np.asarray(v) for k, v in m.items()}], state, (
        "loss", "loss_clean", "loss_spectrum", "loss_sd")


def seg_case(setup):
    jm, variables, images, labels = setup
    assert (labels[:2] == 255).sum() == 25 and (labels[2:] == 255).sum() == 0
    state, tx = tseg.jax_state(variables)
    step = jseg_loop.make_afan_seg_step(
        jm, tx, jseg_loop.SegAfanConfig(fused_ce=False, **SEG))
    state, m = step(state, jnp.asarray(images), jnp.asarray(labels),
                    jax.random.PRNGKey(1))
    payload = dict(deeplab=("resnet18", tseg.NC, 16), cfg=SEG, lr=tseg.LR,
                   total=tseg.TOTAL,
                   state_dict=deeplab_variables_to_state_dict(variables),
                   batches=[{"inputs": [images, labels]}])
    return payload, [{k: np.asarray(v) for k, v in m.items()}], state, (
        "loss", "loss_clean", "loss_spectrum", "loss_sd")


def load_into(model, state):
    model.load_state_dict({k: torch.from_numpy(np.asarray(v))
                           for k, v in state.items()})
    return model


@pytest.mark.parametrize("section",
                         ["alfa", "learnable", "det", "det-rpn", "seg"])
def test_world_two_step_matches_afan_and_world_one(section, request):
    if section in ("alfa", "learnable"):
        payload, want, state, keys = classify_case(
            request.getfixturevalue("variables"), section)
    elif section.startswith("det"):
        setup = request.getfixturevalue("det_setup")
        payload, want, state, keys = det_case(setup, section)
    else:
        request.getfixturevalue("flax_no_dropout")
        setup = request.getfixturevalue("seg_setup")
        payload, want, state, keys = seg_case(setup)
    recomputed = None
    if section in ("det", "seg"):
        recomputed = dict(payload, cfg=dict(payload["cfg"], remat_tails=True),
                          backbone_remat=section == "seg")
    two, one = port_runs(section, payload, recomputed)
    for i, (got, w) in enumerate(zip(two["metrics"], want)):
        for k in keys:
            close(got[k], w[k], AFAN_REL, f"step {i} {k}")
    if section == "learnable":
        w = np.asarray(two["metrics"][-1]["w"])
        close(w, want[-1]["w"], AFAN_REL, "w")
        assert abs(w.sum() - 1.0) < 1e-6
    if section in ("alfa", "learnable"):
        check_classify_state(two, state)
    elif section.startswith("det"):
        setup = request.getfixturevalue("det_setup")
        tdet.compare_states(load_into(tdet.port_model(setup[1]),
                                      two["state"]), setup[1], state)
    else:
        setup = request.getfixturevalue("seg_setup")
        tm, _, _ = tseg.port_model(setup[1])
        tseg.compare_states(load_into(tm, two["state"]), setup[1], state)
    against_world_one(two, one)


# ---------- the CLIs ----------

def state_of(path, key):
    return torch.load(path, map_location="cpu", weights_only=False)[key]


@pytest.mark.parametrize("trainer", ["classify", "segment", "detect"])
def test_cli_with_two_ranks_trains_and_writes_one_checkpoint(
        trainer, tmp_path, monkeypatch):
    """``--num_devices 2 --device cpu``: two gloo ranks run 2 steps and rank
    0 writes the checkpoint. Classification with host augmentation draws no
    in-step noise, so its checkpoint equals the one-process run's within
    ``CLI_REL`` (all parameters and statistics together; 2 ascent steps of
    ``gamma * sign(g)`` per step and no replay, so sign flips of near-zero
    gradients show, which a small BatchNorm shift feels most); segmentation's
    dropout and detection's samplers draw per rank."""
    monkeypatch.chdir(tmp_path)
    if trainer == "classify":
        data = tcls.tiny_cifar(tmp_path / "data")
        argv = ["--mode", "alfa", "--device", "cpu", "--limit_batches", "2",
                "--batch_size", "8", "--epochs", "1", "--data", data,
                "--host_aug", "--steps", "2"]
        train_classify.main(argv + ["--save_dir", "one"])
        train_classify.main(argv + ["--save_dir", "two", "--num_devices",
                                    "2"])
        assert sorted(os.listdir("two")) == ["checkpoint.pt", "result.pkl",
                                             "result_norm.pkl"]
        one = state_of("one/checkpoint.pt", "state_dict")
        two = state_of("two/checkpoint.pt", "state_dict")
    elif trainer == "segment":
        argv = ["--device", "cpu", "--dataset", "synthetic", "--crop_size",
                "32", "--batch_size", "2", "--limit_itrs", "2",
                "--val_interval", "2", "--model", "deeplabv3plus_mobilenet",
                "--val_batch_size", "3", "--num_devices", "2"]
        train_segment.main(argv)
        (exp,) = os.listdir("checkpoints")
        assert sorted(f for f in os.listdir(os.path.join("checkpoints", exp))
                      if f.endswith(".pt")) == [
            "best_deeplabv3plus_mobilenet_synthetic.pt",
            "latest_deeplabv3plus_mobilenet_synthetic.pt"]
        return
    else:
        argv = ["--device", "cpu", "--variant", "afan", "-o", "det",
                "--num_devices", "2"] + tdet.smoke_tiny_flags()
        train_detect.main(argv)
        assert sorted(f for f in os.listdir("det")
                      if f.endswith(".pt")) == ["model-2.pt"]
        return
    assert set(one) == set(two)
    keys = [k for k, v in one.items() if v.is_floating_point()]
    close_l2(np.concatenate([two[k].numpy().ravel() for k in keys]),
             np.concatenate([one[k].numpy().ravel() for k in keys]), CLI_REL,
             "all parameters and statistics")
