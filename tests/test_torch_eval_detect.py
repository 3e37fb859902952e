"""afan_torch's detection evaluation against afan's: the input PGD of
``eval_rob_ori``, the SAT-layer detection (AFN off and on), the spectrum
features of ``sat_vis``, the input-space loss surface and the weight-space
loss probe, from the weights and batch of ``tests/test_torch_detect_train.py``
(ResNet-18, 4 classes, two 64x64 images), carried across by
``frcnn_variables_to_state_dict``; the weight directions' cover and norm;
NMS on NaN boxes; and one CPU run of each ``eval_detect`` task.

Randomness is ``afan``'s: every forward of an ``afan`` attack or probe
draws its anchor and proposal samples from one key, so the port's sampling
draw (``sampling.draw_priorities``) is patched to return the uniforms of
that key, the RPN's then the ROI head's, at every forward; the surface's
Rademacher direction is ``afan``'s draw (``robustness.rademacher``
patched); the probe's directions are ``afan``'s, converted.

Tolerances (float32 on the CPU): images and features after sign steps
agree within ``1e-5 * max(max|x|, 1)`` except entries where a sign flips (a
near-zero gradient entry that float order turns over: a whole step apart),
at most 1e-4 of the entries;
losses, features and detected boxes and probabilities within ``1e-4 *
max|x|``; keep masks equal; the surface's NaN at the same cell and its
other cells within 1e-4 relative; the probe's losses within 1e-4
relative; restored weights bit-equal.
"""
import itertools
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from afan.cli import eval_detect as j_eval_detect
from afan.eval import feature_vis as j_feature_vis
from afan.eval import robustness as j_robustness
from afan.ops.kernels.nms_kernel import nms_sorted_mask_pallas
from afan_torch.cli import eval_detect
from afan_torch.eval import feature_vis, robustness
from afan_torch.interop.from_jax import frcnn_variables_to_state_dict
from afan_torch.models.frcnn import sampling
from afan_torch.ops import nms as tnms

from chip_smoke import NMS_NAN_CASES, nan_mixed_boxes
from test_torch_detect_train import setup  # noqa: F401 (the fixture)
from test_torch_detect_train import (B, close, jax_state, port_model,
                                     batched_priorities, t)
from test_torch_nms import iou_words, word_scan

SHARE = 1e-4        # entries allowed a sign flip after sign steps


def afans_draws(monkeypatch, key):
    """Every sampling forward of the port draws ``afan``'s uniforms of
    ``key``: the RPN's (its first B keys), then the ROI head's."""
    keys = jax.random.split(key, 2 * B)
    draws = itertools.cycle([keys[:B], keys[B:]])
    monkeypatch.setattr(sampling, "draw_priorities",
                        lambda shape, g, device=None: batched_priorities(
                            next(draws), shape[-1]))


def close_signed(got, want, msg=""):
    """Within ``1e-5 * max(max|want|, 1)`` but at most ``SHARE`` of the
    entries."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, msg
    off = np.abs(got - want) > 1e-5 * max(np.abs(want).max(), 1.0)
    assert off.mean() <= SHARE, (msg, int(off.sum()), got.size)


def nhwc(x):
    return x.permute(0, 2, 3, 1).detach().numpy()


def test_detection_pgd_matches_afan(setup, monkeypatch):
    """Two sign steps (``eval_rob_ori``'s attack) on the images against the
    four training losses, no projection, no clamp."""
    jm, variables, images, jgt, tgt = setup
    state, _ = jax_state(variables)
    key = jax.random.PRNGKey(1)
    want = j_robustness.make_detection_pgd_fn(jm, 2, 2.0 / 255, 8.0 / 255)(
        state, jnp.asarray(images), *jgt, key)
    r_attack, _ = jax.random.split(key)
    afans_draws(monkeypatch, r_attack)
    tm = port_model(variables)
    got = robustness.make_detection_pgd_fn(tm, 2, 2.0 / 255, 8.0 / 255)(
        t(images), *tgt, torch.Generator())
    close_signed(got.numpy(), want, "adversarial images")
    # two steps of 2/255, nothing projected or clamped
    assert float((got - t(images)).abs().max()) == pytest.approx(
        4.0 / 255, abs=1e-6)


@pytest.mark.parametrize("mix", [False, True], ids=["plain", "mix"])
def test_sat_layer_detect_matches_afan(setup, monkeypatch, mix):
    """Tap 2, alpha 0.5, one sign step, AFN with the clean statistics in
    the reference's argument order under ``mix``: detections equal."""
    jm, variables, images, jgt, tgt = setup
    state, _ = jax_state(variables)
    key = jax.random.PRNGKey(2)
    jb, jp, jk = j_robustness.make_sat_layer_detect_fn(
        jm, 2, 0.5, attack_steps=1, gamma=0.9 / 255, mix=mix)(
            state, jnp.asarray(images), *jgt, key)
    afans_draws(monkeypatch, key)
    tm = port_model(variables)
    boxes, probs, keep = robustness.make_sat_layer_detect_fn(
        tm, 2, 0.5, attack_steps=1, gamma=0.9 / 255, mix=mix)(
            t(images), *tgt, torch.Generator())
    np.testing.assert_array_equal(keep.numpy(), np.asarray(jk))
    close(probs.numpy(), jp, msg="probs")
    k = np.asarray(jk)
    close(boxes.numpy()[k], np.asarray(jb)[k], msg="kept boxes")
    assert k.any()


def test_spectrum_features_match_afan(setup, monkeypatch):
    """``sat_vis``'s spectrum: 5 points from the clean to the adversarial
    tap-2 feature after 2 sign steps, (N, B, h, w, C)."""
    jm, variables, images, jgt, tgt = setup
    state, _ = jax_state(variables)
    key = jax.random.PRNGKey(3)
    want = j_feature_vis.make_spectrum_features_fn(
        jm, 2, 0.9 / 255, 2, 8.0 / 255, 5)(state, jnp.asarray(images), *jgt,
                                          key)
    afans_draws(monkeypatch, key)
    got = feature_vis.make_spectrum_features_fn(
        port_model(variables), 2, 0.9 / 255, 2, 8.0 / 255, 5)(
            t(images), *tgt, torch.Generator())
    assert tuple(got.shape) == tuple(want.shape)
    close(got[0].numpy(), want[0], msg="clean point")
    close_signed(got.numpy(), want, "spectrum")


def test_input_surface_matches_afan(setup, monkeypatch):
    """A 4x4 grid: ``afan``'s Rademacher direction injected, the NaN of the
    all-zero centre image at the same cell, the other losses equal."""
    jm, variables, images, jgt, tgt = setup
    state, _ = jax_state(variables)
    key = jax.random.PRNGKey(4)
    want = np.asarray(j_robustness.make_input_surface_fn(jm, 0.1, 4, 4)(
        state, jnp.asarray(images), *jgt, key))
    r2 = np.where(np.asarray(jax.random.uniform(key, images.shape)) > 0.5,
                  -1.0, 1.0).astype(np.float32)
    monkeypatch.setattr(robustness, "rademacher",
                        lambda shape, g, device=None: t(r2))
    afans_draws(monkeypatch, key)
    got = robustness.make_input_surface_fn(port_model(variables), 0.1, 4)(
        t(images), *tgt, torch.Generator()).numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    assert np.isnan(got[2, 2]) and np.isnan(got).sum() == 1
    ok = ~np.isnan(want)
    np.testing.assert_allclose(got[ok], want[ok], rtol=1e-4)
    np.testing.assert_array_equal(robustness.surface_grid(0.1, 4).numpy(),
                                  np.float32(-0.1) + np.float32(0.05)
                                  * np.arange(4, dtype=np.float32))


def port_directions(variables, dirs):
    """``afan``'s direction tree → the port's parameter names."""
    sd = frcnn_variables_to_state_dict(
        {"params": dirs, "batch_stats": variables["batch_stats"]})
    return {k: sd[k] for k in sd}


def test_weight_directions_cover_afans_params(setup):
    """One direction per parameter of ``afan``'s ``params`` collection
    (the frozen BatchNorms' scale and bias included, their statistics
    not), jointly of norm 1, on the port's parameter names."""
    jm, variables, images, jgt, tgt = setup
    tm = port_model(variables)
    dirs = robustness.perturb_weight_directions(tm,
                                                np.random.RandomState(0))
    leaves = jax.tree_util.tree_leaves(variables["params"])
    assert len(dirs) == len(leaves)
    names = set(port_directions(variables, variables["params"]))
    params = dict(tm.named_parameters())
    assert set(dirs) == set(params)
    assert set(dirs) == {k for k in names if k in params}
    assert sorted(int(np.prod(np.shape(x))) for x in leaves) == sorted(
        d.numel() for d in dirs.values())
    total = sum(float((d.double() ** 2).sum()) for d in dirs.values())
    assert total == pytest.approx(1.0, abs=1e-6)
    assert all(d.dtype == torch.float32 for d in dirs.values())


def test_loss_probe_matches_afan_and_restores_the_weights(setup,
                                                          monkeypatch):
    """``eval_loss_vis``: the losses at the weights moved along ``afan``'s
    direction by each scale; afterwards every weight is what it was, bit
    for bit."""
    jm, variables, images, jgt, tgt = setup
    state, _ = jax_state(variables)
    key = jax.random.PRNGKey(0)
    jdirs = j_robustness.perturb_weight_directions(
        state.params, np.random.RandomState(0))
    scales = [0.0, 0.5, 1.0, 2.0, 5.0]
    x = jnp.asarray(images)
    want = j_robustness.loss_landscape_probe(
        jax.jit(lambda p: jm.apply(
            {"params": p, "batch_stats": state.batch_stats}, x, *jgt, key,
            method=jm.losses).total()), state.params, jdirs, scales)
    afans_draws(monkeypatch, key)
    tm = port_model(variables)
    before = {k: v.clone() for k, v in tm.state_dict().items()}
    params = dict(tm.named_parameters())
    dirs = {k: v for k, v in port_directions(variables, jdirs).items()
            if k in params}
    got = robustness.loss_landscape_probe(
        lambda: tm.losses(t(images), *tgt, torch.Generator()).total(), tm,
        dirs, scales)
    np.testing.assert_allclose(got, want, rtol=1e-4)
    after = tm.state_dict()
    for k, v in before.items():
        assert torch.equal(after[k].view(torch.uint8)
                           if after[k].is_floating_point() else after[k],
                           v.view(torch.uint8) if v.is_floating_point()
                           else v), k


def test_loss_probe_restores_the_weights_when_the_loss_raises(setup):
    jm, variables, images, jgt, tgt = setup
    tm = port_model(variables)
    before = {k: v.clone() for k, v in tm.named_parameters()}
    dirs = robustness.perturb_weight_directions(tm,
                                                np.random.RandomState(1))

    def boom():
        raise FloatingPointError("loss")

    with pytest.raises(FloatingPointError):
        robustness.loss_landscape_probe(boom, tm, dirs, [3.0])
    for k, v in tm.named_parameters():
        assert torch.equal(v.detach(), before[k].detach()), k


# ---------- NMS on NaN boxes ----------

# the card's cases at sizes the CPU's N x N plain version and interpret
# mode take in a second
NAN_CASES = {k: v for k, v in NMS_NAN_CASES.items()
             if k in ("nan_mixed_0.3", "nan_invalid")}
NAN_CASES["nan_all_700"] = lambda: (np.full((700, 4), np.nan, np.float32),
                                    np.ones(700, bool), 0.7)
NAN_CASES["nan_mixed_1000"] = lambda: (nan_mixed_boxes(1000, 3),
                                       np.ones(1000, bool), 0.7)


@pytest.mark.parametrize("case", sorted(NAN_CASES))
def test_nms_on_nan_boxes_matches_afan_and_the_scan(case):
    """A pair with a NaN coordinate never suppresses: the plain version
    keeps what ``afan``'s Pallas kernel (interpret mode) keeps, and so does
    the numpy rehearsal of the CUDA kernel's mask pass and per-word scan
    (``tests/test_torch_nms.py``), whose maxima and minima pass a NaN on."""
    boxes, valid, thr = NAN_CASES[case]()
    want = np.asarray(nms_sorted_mask_pallas(
        jnp.asarray(boxes), jnp.asarray(valid), thr, interpret=True))
    got = tnms.nms_sorted_mask_plain(t(boxes)[None], t(valid)[None],
                                     thr)[0].numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(word_scan(iou_words(boxes, thr, True),
                                            valid), got)
    nan_box = np.isnan(boxes).any(1)
    assert (got[nan_box & valid]).all()


# ---------- the CLI on the CPU ----------

TINY_EVAL = ["--device", "cpu", "--data_dir", "/nonexistent", "--backbone",
             "resnet18", "--image_min_side", "64", "--image_max_side", "96",
             "--anchor_sizes", "[16,32]", "--rpn_pre_nms_top_n", "256",
             "--rpn_post_nms_top_n", "64", "--pgd_steps", "2"]


@pytest.fixture
def two_test_images(monkeypatch):
    """The test split cut to its first two images."""
    real = eval_detect.detection_loaders

    def cut(*a, **kw):
        train, ev, nc = real(*a, **kw)
        ev.samples = ev.samples[:2]
        return train, ev, nc

    monkeypatch.setattr(eval_detect, "detection_loaders", cut)


def test_parser_is_afans_with_device():
    ours = vars(eval_detect.get_parser().parse_args([]))
    theirs = vars(j_eval_detect.get_parser().parse_args([]))
    assert ours.pop("device") == "cuda"
    assert ours == theirs
    aliases = ["--steps", "4", "--gamma", "1", "--eps", "2", "--pertub_idx",
               "3", "--convert"]
    assert vars(eval_detect.get_parser().parse_args(aliases)) | {
        "device": None} == vars(j_eval_detect.get_parser().parse_args(
            aliases)) | {"device": None}


def test_cli_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        eval_detect.main(["--task", "map"])


def test_cli_tasks_on_cpu(tmp_path, two_test_images):
    """Each task at the SMOKE_TINY size, with a port checkpoint through
    ``--checkpoint`` and a reference-keyed one through
    ``--torch_checkpoint``: mAPs, the PNG count, the pickled surfaces and
    the probe's losses, in ``afan``'s forms."""
    model = eval_detect.build_model(
        eval_detect.get_parser().parse_args(TINY_EVAL), 21,
        torch.device("cpu"))
    ckpt = str(tmp_path / "model.pt")
    torch.save({"state_dict": model.state_dict()}, ckpt)
    ref = str(tmp_path / "reference.pth")
    torch.save(model.state_dict(), ref)
    base = TINY_EVAL + ["--checkpoint", ckpt]
    for task in ("map", "rob", "sat_layers"):
        extra = ["--mix"] if task == "sat_layers" else []
        mean_ap = eval_detect.main(base + ["--task", task] + extra)
        assert isinstance(mean_ap, float) and 0.0 <= mean_ap <= 1.0
    dump = tmp_path / "maps"
    assert eval_detect.main(base + ["--task", "sat_vis", "--limit_images",
                                    "1", "--spectrum", "3", "--dump_dir",
                                    str(dump)]) == 4
    assert sorted(os.listdir(dump)) == sorted(
        ["synth000000_input.png"] + [f"synth000000_spec{k}.png"
                                     for k in range(3)])
    out = str(tmp_path / "alp.pkl")
    surfaces = eval_detect.main(
        TINY_EVAL + ["--torch_checkpoint", ref, "--task", "input_surface",
                     "--grid_points", "2", "--limit_images", "1",
                     "--surface_out", out])
    with open(out, "rb") as f:
        saved = pickle.load(f)
    assert list(saved) == list(surfaces) == ["synth000000"]
    z = saved["synth000000"]
    assert isinstance(z, np.ndarray) and z.shape == (2, 2)
    assert np.isnan(z[1, 1]) and np.isfinite(z).sum() == 3
    losses = eval_detect.main(base + ["--task", "loss_vis"])
    assert len(losses) == 5 and all(isinstance(v, float) for v in losses)
