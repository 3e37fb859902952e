"""afan_torch's detection training against afan's, at the size of
``tests/test_detection.py``'s A-FAN step test (ResNet-18, 4 classes, 64x64
images, 128 → 32 proposals, 8 ROI slots with 2 fg, 16 RPN slots with 8 fg,
anchor sizes (32, 64)), with one set of weights carried across by
``frcnn_variables_to_state_dict``.

Randomness never matches across the two frameworks, so the port is fed
``afan``'s: the sampling priorities (the uniforms ``afan`` draws from its
keys) or whole targets (``afan``'s sample, converted to tensors).

Tolerances (float32 on the CPU): sampled indices, flags and anchor labels
are equal; losses and gradients agree within ``1e-4 * max|x|`` of the
compared tensor; updated parameters within 1e-4 of their norm and each
update within 2e-3 of its norm (``tests/test_torch_segment.py``'s
``compare_states``); frozen parameters are bit-unchanged; learning rates
agree within 1e-6 (optax's float32 schedule against Python's float64).
"""
import os
import shlex

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from afan.data import voc_det as j_voc_det
from afan.eval import det_map as j_det_map
from afan.models.frcnn import FasterRCNN as JFasterRCNN
from afan.models.frcnn import FRCNNConfig as JFRCNNConfig
from afan.models.frcnn import roi_head as j_roi_head
from afan.models.frcnn import rpn as j_rpn
from afan.models.frcnn import sampling as j_sampling
from afan.ops.roi_align import roi_align_einsum as j_roi_align_einsum
from afan.train import detect_loop as j_loop
from afan.train.loop import TrainState
from afan.train.optim import warmup_multistep_schedule as j_schedule
from afan_torch.cli import train_detect
from afan_torch.core import attack
from afan_torch.data import registry, voc_det
from afan_torch.eval import det_map
from afan_torch.interop.from_jax import frcnn_variables_to_state_dict
from afan_torch.models.frcnn import FasterRCNN, FRCNNConfig
from afan_torch.models.frcnn import roi_head, rpn, sampling
from afan_torch.models.frcnn.anchors import generate_anchors
from afan_torch.ops import nms as tnms
from afan_torch.ops import roi_align
from afan_torch.train import detect_loop
from afan_torch.train.checkpoint import load_checkpoint, load_training_state
from afan_torch.train.optim import sgd, warmup_multistep_schedule

from voc_oracle import oracle_voc_map
from torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(backbone="resnet18", num_classes=4, train_pre_nms_top_n=128,
            train_post_nms_top_n=32, eval_pre_nms_top_n=64,
            eval_post_nms_top_n=8, roi_samples=8, roi_fg_cap=2,
            rpn_samples=16, rpn_fg_cap=8, anchor_sizes=(32, 64))
B, HW, LR = 2, 64, 0.01
AFAN = dict(taps_se=(2,), gammas_se=(1.0 / 255,), spectrum=3,
            mix_mask=(0, 1, 0), sd="roi", mix_sd=True)


def close(got, want, rel=1e-4, msg=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, msg
    np.testing.assert_allclose(got, want, rtol=0, err_msg=msg,
                               atol=rel * max(np.abs(want).max(), 1e-6))


def t(x, dtype=None):
    out = torch.from_numpy(np.array(x))
    return out if dtype is None else out.to(dtype)


# ---------- sampling ----------

def j_priorities(key, n):
    """The two uniforms ``afan``'s ``sample_fg_bg`` draws from ``key``."""
    kf, kb = jax.random.split(key)
    return (np.asarray(jax.random.uniform(kf, (n,))),
            np.asarray(jax.random.uniform(kb, (n,))))


def batched_priorities(keys, n):
    fg, bg = zip(*(j_priorities(k, n) for k in keys))
    return t(np.stack(fg)), t(np.stack(bg))


def assert_same_sample(got, want):
    """Equal validity and fg flags, equal indices on the valid slots."""
    valid = np.asarray(want.valid)
    np.testing.assert_array_equal(got.valid.numpy(), valid)
    np.testing.assert_array_equal(got.is_fg.numpy(), np.asarray(want.is_fg))
    np.testing.assert_array_equal(got.indices.numpy()[valid],
                                  np.asarray(want.indices)[valid])


@pytest.mark.parametrize("n,total,cap,p_fg,p_bg", [
    (50, 16, 8, 0.2, 0.5), (50, 16, 8, 0.0, 0.5), (50, 16, 8, 0.6, 0.0),
    (5, 16, 2, 0.5, 0.5), (300, 128, 32, 0.1, 0.9)],
    ids=["mixed", "no_fg", "no_bg", "few_candidates", "roi_size"])
def test_select_fg_bg_matches_afan(n, total, cap, p_fg, p_bg):
    rng = np.random.RandomState(n + total)
    fg = rng.rand(3, n) < p_fg
    bg = ~fg & (rng.rand(3, n) < p_bg)
    keys = jax.random.split(jax.random.PRNGKey(n), 3)
    want = jax.vmap(j_sampling.sample_fg_bg,
                    in_axes=(0, 0, 0, None, None))(
        keys, jnp.asarray(fg), jnp.asarray(bg), total, cap)
    got = sampling.select_fg_bg(batched_priorities(keys, n), t(fg), t(bg),
                                total, cap)
    assert_same_sample(got, want)
    assert int(got.indices.min()) >= 0 and int(got.indices.max()) < n


@pytest.mark.parametrize("empty", [False, True], ids=["fg", "empty_fg"])
def test_masked_mean_and_smooth_l1_match_afan(empty):
    rng = np.random.RandomState(1)
    x = rng.randn(16, 4).astype(np.float32) * 2
    y = rng.randn(16, 4).astype(np.float32)
    mask = np.zeros(16, bool) if empty else rng.rand(16) < 0.4
    for beta in (1.0, 1.0 / 9):
        close(sampling.beta_smooth_l1(t(x), t(y), beta, t(mask)),
              j_sampling.beta_smooth_l1(jnp.asarray(x), jnp.asarray(y), beta,
                                        jnp.asarray(mask)), 1e-6)
    close(sampling.masked_mean(t(x[:, 0]), t(mask)),
          j_sampling.masked_mean(jnp.asarray(x[:, 0]), jnp.asarray(mask)),
          1e-6)


# ---------- targets ----------

def gt_batch(seed=0):
    """Two images' ground truth, padded to 5 boxes (3 and 1 valid)."""
    rng = np.random.RandomState(seed)
    boxes = np.zeros((B, 5, 4), np.float32)
    xy = rng.rand(B, 5, 2) * 24
    boxes[..., :2], boxes[..., 2:] = xy, xy + 24 + rng.rand(B, 5, 2) * 16
    valid = np.array([[1, 1, 1, 0, 0], [1, 0, 0, 0, 0]], bool)
    boxes[~valid] = 0
    classes = np.where(valid, rng.randint(1, 4, (B, 5)), 0).astype(np.int32)
    return boxes, classes, valid


def test_label_anchors_equal_afan():
    anchors = generate_anchors(HW, HW, 4, 4, sizes=(32, 64))
    boxes, _, valid = gt_batch()
    want = jax.vmap(j_rpn.label_anchors, in_axes=(None, 0, 0, None, None))(
        jnp.asarray(anchors), jnp.asarray(boxes), jnp.asarray(valid), HW, HW)
    got = rpn.label_anchors(t(anchors), t(boxes), t(valid), HW, HW)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert set(np.unique(got[0].numpy())) == {-1, 0, 1}


def test_rpn_and_roi_targets_match_afan():
    anchors = generate_anchors(HW, HW, 4, 4, sizes=(32, 64))
    boxes, classes, valid = gt_batch()
    keys = jax.random.split(jax.random.PRNGKey(3), B)
    want = jax.jit(jax.vmap(
        lambda k, a, b, v: j_rpn.rpn_targets(k, a, b, v, HW, HW, 16, 8),
        in_axes=(0, None, 0, 0)))(
        keys, jnp.asarray(anchors), jnp.asarray(boxes), jnp.asarray(valid))
    got = rpn.rpn_targets(t(anchors), t(boxes), t(valid), HW, HW, 16, 8,
                          priorities=batched_priorities(keys, len(anchors)))
    assert_same_sample(got.sample, want.sample)
    v = np.asarray(want.sample.valid)
    np.testing.assert_array_equal(got.gt_objectness.numpy()[v],
                                  np.asarray(want.gt_objectness)[v])
    close(got.gt_deltas.numpy()[v], np.asarray(want.gt_deltas)[v])

    rng = np.random.RandomState(4)
    xy = rng.rand(B, 40, 2) * 40
    props = np.concatenate([xy, xy + 5 + rng.rand(B, 40, 2) * 30], -1)
    props[:, :8] = boxes[:, :1] + rng.randn(B, 8, 4) * 2   # some fg
    props[:, -5:] = 0                                      # padding
    props = props.astype(np.float32)
    keys = jax.random.split(jax.random.PRNGKey(5), B)
    want = jax.jit(jax.vmap(
        lambda *a: j_roi_head.roi_targets(*a, 8, 2)))(
        keys, jnp.asarray(props), jnp.asarray(boxes), jnp.asarray(classes),
        jnp.asarray(valid))
    got = roi_head.roi_targets(t(props), t(boxes), t(classes), t(valid), 8,
                               2, priorities=batched_priorities(keys, 40))
    assert_same_sample(got.sample, want.sample)
    v = np.asarray(want.sample.valid)
    assert np.asarray(want.sample.is_fg).any()
    np.testing.assert_array_equal(got.gt_classes.numpy()[v],
                                  np.asarray(want.gt_classes)[v])
    close(got.boxes.numpy()[v], np.asarray(want.boxes)[v])
    close(got.gt_deltas.numpy()[v], np.asarray(want.gt_deltas)[v])


# ---------- ROI pooling per image ----------

@pytest.mark.parametrize("chunk", [256, 4], ids=["one_chunk", "chunks"])
def test_roi_align_per_image_and_its_gradient(monkeypatch, chunk):
    """Each image's ROIs against its own rows equals the concatenated
    contraction's oracle and afan's, and so does the feature gradient
    through the chunked writes."""
    monkeypatch.setattr(roi_align, "ROI_CHUNK", chunk)
    rng = np.random.RandomState(6)
    feat = rng.randn(3, 8, 12, 16).astype(np.float32)          # NCHW
    xy = rng.rand(3, 10, 2) * np.array([16 * 16, 12 * 16]) - 20
    boxes = np.concatenate([xy, xy + 2 + rng.rand(3, 10, 2) * 120],
                           -1).astype(np.float32)
    boxes[:, -2:] = 0                                          # padding
    cot = rng.randn(30, 8, 14, 14).astype(np.float32)
    bidx = np.repeat(np.arange(3), 10).astype(np.int32)
    f = t(feat).requires_grad_(True)
    got = roi_align.roi_align_per_image(f, t(boxes))
    (g,) = torch.autograd.grad(got, f, t(cot))
    f2 = t(feat).requires_grad_(True)
    want = roi_align.roi_align_gather(f2, t(boxes).reshape(-1, 4), t(bidx))
    (g2,) = torch.autograd.grad(want, f2, t(cot))
    close(got.detach().numpy(), want.detach().numpy())
    close(g.numpy(), g2.numpy())
    jf = jnp.asarray(feat.transpose(0, 2, 3, 1))
    jout, vjp = jax.vjp(lambda x: j_roi_align_einsum(
        x, jnp.asarray(boxes.reshape(-1, 4)), jnp.asarray(bidx)), jf)
    close(got.detach().permute(0, 2, 3, 1).numpy(), jout)
    (jg,) = vjp(jnp.asarray(cot.transpose(0, 2, 3, 1)))
    close(g.permute(0, 2, 3, 1).numpy(), jg)
    for mode in ("align", "pooling"):
        close(roi_align.pool_rois(t(feat), t(boxes), None, mode).numpy(),
              roi_align.pool_rois(t(feat), t(boxes).reshape(-1, 4), t(bidx),
                                  mode).numpy())


# ---------- the model ----------

def _randomize(variables, rng):
    """Non-trivial frozen-BN statistics and biases."""
    def walk(tree):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = walk(v)
                continue
            v = np.asarray(v)
            if k == "mean":
                v = rng.randn(*v.shape) * 0.1
            elif k == "var":
                v = rng.rand(*v.shape) + 0.5
            elif k == "scale":
                v = 1.0 + 0.1 * rng.randn(*v.shape)
            elif k == "bias":
                v = 0.1 * rng.randn(*v.shape)
            out[k] = v.astype(np.float32)
        return out
    return {c: walk(jax.device_get(variables[c])) for c in variables}


@pytest.fixture(scope="module")
def setup():
    jm = JFasterRCNN(cfg=JFRCNNConfig(**TINY))
    rng = np.random.RandomState(0)
    images = rng.rand(B, HW, HW, 3).astype(np.float32)
    boxes, classes, valid = gt_batch()
    jgt = tuple(jnp.asarray(a) for a in (boxes, classes, valid))
    variables = jax.jit(lambda k, x: jm.init({"params": k}, x,
                                             method=jm.detect))(
        jax.random.PRNGKey(0), jnp.asarray(images[:1]))
    variables = _randomize(variables, rng)
    # small box deltas, as a trained RPN gives them: proposals near the
    # anchors, some of them on the ground truth
    reg = variables["params"]["rpn"]["transformer"]
    reg["kernel"] = reg["kernel"] * 0.01
    reg["bias"] = reg["bias"] * 0.0
    tgt = (t(boxes), t(classes, torch.int64), t(valid))
    return jm, variables, images, jgt, tgt


def port_model(variables):
    tm = FasterRCNN(FRCNNConfig(**TINY))
    tm.load_state_dict(frcnn_variables_to_state_dict(variables), strict=True)
    return tm


def to_torch(tree):
    """``afan``'s targets (namedtuples of arrays) → the port's, int64
    indices and classes."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type_for(tree)(*(to_torch(x) for x in tree))
    if isinstance(tree, tuple):
        return tuple(to_torch(x) for x in tree)
    a = np.array(tree)
    return t(a.astype(np.int64) if a.dtype.kind == "i" else a)


def type_for(tree):
    return {"SampleResult": sampling.SampleResult,
            "RPNTargets": rpn.RPNTargets,
            "RoiTargets": roi_head.RoiTargets}[type(tree).__name__]


def j_targets(jm, variables, images, jgt, key):
    return jax.jit(lambda v, x, g, k: jm.apply(
        v, x, *g, k, method=jm.compute_targets))(
            variables, jnp.asarray(images), jgt, key)


def close_losses(got, want, msg=""):
    for name, g, w in zip(want._fields, got, want):
        close(g.detach().numpy(), w, msg=f"{msg} {name}")


def test_losses_on_afans_targets(setup):
    jm, variables, images, jgt, tgt = setup
    tm = port_model(variables)
    key = jax.random.PRNGKey(7)
    want = jax.jit(lambda v, x, g, k: jm.apply(v, x, *g, k,
                                               method=jm.losses))(
        variables, jnp.asarray(images), jgt, key)
    targets = to_torch(j_targets(jm, variables, images, jgt, key))
    assert targets[1].sample.is_fg.any()
    got = tm.losses(t(images), *tgt, targets=targets)
    close_losses(got, want, "losses")
    again = tm.losses_from_targets(t(images), *targets)
    close_losses(again, want, "losses_from_targets")


def test_compute_targets_on_afans_priorities(setup, monkeypatch):
    """``compute_targets`` with ``afan``'s uniforms in place of the draw
    gives ``afan``'s sample: the anchor labels, the proposal NMS at 0.7
    and the ROI labels agree."""
    jm, variables, images, jgt, tgt = setup
    tm = port_model(variables)
    key = jax.random.PRNGKey(8)
    keys = jax.random.split(key, 2 * B)
    draws = iter([keys[:B], keys[B:]])
    monkeypatch.setattr(sampling, "draw_priorities",
                        lambda shape, g, device=None: batched_priorities(
                            next(draws), shape[-1]))
    got = tm.compute_targets(t(images), *tgt)
    want = j_targets(jm, variables, images, jgt, key)
    for g, w in zip(got, want):
        assert_same_sample(g.sample, w.sample)
    v = np.asarray(want[1].sample.valid)
    close(got[1].boxes.numpy()[v], np.asarray(want[1].boxes)[v])
    np.testing.assert_array_equal(got[1].gt_classes.numpy()[v],
                                  np.asarray(want[1].gt_classes)[v])


def test_feature_gradients_match_afan(setup):
    """The SE ascent's gradient (tail from tap 2) and the SD ascent's
    (ROI tail from the pooled vector), on ``afan``'s targets."""
    jm, variables, images, jgt, tgt = setup
    tm = port_model(variables)
    key = jax.random.PRNGKey(9)
    jt = j_targets(jm, variables, images, jgt, key)
    targets = to_torch(jt)
    x = jnp.asarray(images)
    feat = jax.jit(lambda v: jm.apply(v, x, 2, method=jm.backbone_head))(
        variables)

    def j_se(f):
        return jm.apply(variables, x, *jt, key, 2, f,
                        method=jm.losses_from_targets).total()

    want_loss, want = jax.jit(jax.value_and_grad(j_se))(feat)
    f = t(feat).permute(0, 3, 1, 2).contiguous().requires_grad_(True)
    loss = tm.losses_from_targets(t(images), *targets, 2, f).total()
    close(float(loss.detach()), float(want_loss))
    (g,) = torch.autograd.grad(loss, f)
    close(g.permute(0, 2, 3, 1).numpy(), want, msg="SE gradient")

    jd = jax.jit(lambda v, g, k: jm.apply(v, x, *g, k,
                                          method=jm.roi_head_forward))(
        variables, jgt, key)
    rd = tm.roi_head_forward(t(images), *tgt, targets=targets)
    close(rd["roi_feature_map"].detach().numpy(), jd["roi_feature_map"])
    close(rd["anchor_objectness_losses"].detach().numpy(),
          jd["anchor_objectness_losses"])

    def j_sd(rf):
        L = jm.apply(variables, jd, rf, method=jm.roi_tail_losses)
        return L.proposal_class.mean() + L.proposal_transformer.mean()

    rf = rd["roi_feature_map"].detach().requires_grad_(True)
    L = tm.roi_tail_losses(rd, rf)
    close_losses(L, jm.apply(variables, jd, jd["roi_feature_map"],
                             method=jm.roi_tail_losses), "roi_tail")
    (g,) = torch.autograd.grad(L.proposal_class.mean()
                               + L.proposal_transformer.mean(), rf)
    close(g.numpy(), jax.jit(jax.grad(j_sd))(jd["roi_feature_map"]),
          msg="SD gradient")


# ---------- the steps ----------

def jax_state(variables):
    tx = j_loop.detection_tx(j_schedule(LR, [10], 0.1, 1.0 / 3, 5), 0.9,
                             5e-4)
    return TrainState.create(variables, tx), tx


def port_step(variables, afan):
    tm = port_model(variables)
    opt, sched = sgd(detect_loop.detection_param_groups(tm),
                     warmup_multistep_schedule(LR, [10], 0.1, 1.0 / 3, 5),
                     LR, 0.9, 5e-4)
    if afan:
        step = detect_loop.make_afan_det_step(
            tm, opt, sched, detect_loop.DetAfanConfig(**AFAN))
    else:
        step = detect_loop.make_baseline_det_step(tm, opt, sched)
    return tm, step


def close_l2(got, want, rel, msg):
    err = np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-12)
    assert err <= rel, (msg, err)


FROZEN = ("features.conv1.", "features.bn1.", "features.layer1.")


def compare_states(tm, variables, state):
    before = frcnn_variables_to_state_dict(variables)
    want = frcnn_variables_to_state_dict(jax.device_get(
        {"params": state.params, "batch_stats": state.batch_stats}))
    got = tm.state_dict()
    moved = 0
    for k, w in want.items():
        if k.endswith("num_batches_tracked"):
            continue
        g, w, b = got[k].numpy(), w.numpy(), before[k].numpy()
        frozen = (k.startswith(FROZEN) or ".bn" in k or "downsample.1" in k
                  or k.startswith("features.bn1"))
        if frozen and k.startswith(("features.", "detection.hidden.")):
            np.testing.assert_array_equal(g, b, err_msg=k)
            np.testing.assert_array_equal(w, b, err_msg=k)
            continue
        close_l2(g, w, 1e-4, k)
        if not np.array_equal(w, b):
            moved += 1
            close_l2(g - b, w - b, 2e-3, f"update of {k}")
    assert moved > 20


def test_baseline_step(setup):
    jm, variables, images, jgt, tgt = setup
    state, tx = jax_state(variables)
    key = jax.random.PRNGKey(11)
    state, metrics = j_loop.make_baseline_det_step(jm, tx)(
        state, jnp.asarray(images), *jgt, key)
    tm, step = port_step(variables, afan=False)
    targets = to_torch(j_targets(jm, variables, images, jgt, key))
    out = step(t(images), *tgt, targets=targets)
    close(float(out["loss"]), float(metrics["loss"]))
    compare_states(tm, variables, state)


def test_afan_step(setup):
    jm, variables, images, jgt, tgt = setup
    state, tx = jax_state(variables)
    key = jax.random.PRNGKey(12)
    jstep = j_loop.make_afan_det_step(jm, tx, j_loop.DetAfanConfig(**AFAN))
    # the step's own key split (`afan/train/detect_loop.py:221`)
    _, r_sd, r_clean, _, _, _ = jax.random.split(key, 6)
    targets = {"clean": to_torch(j_targets(jm, variables, images, jgt,
                                           r_clean)),
               "sd": to_torch(j_targets(jm, variables, images, jgt, r_sd))}
    state, metrics = jstep(state, jnp.asarray(images), *jgt, key)
    tm, step = port_step(variables, afan=True)
    out = step(t(images), *tgt, targets=targets)
    for k in ("loss", "loss_clean", "loss_spectrum", "loss_sd"):
        close(float(out[k]), float(metrics[k]), msg=k)
    assert float(out["loss_spectrum"]) > 0 and float(out["loss_sd"]) > 0
    compare_states(tm, variables, state)


def counting(monkeypatch, module, name):
    """Wrap ``module.name`` so that calls are counted."""
    calls = []
    real = getattr(module, name)

    def wrapper(*a, **kw):
        calls.append(1)
        return real(*a, **kw)
    monkeypatch.setattr(module, name, wrapper)
    return calls


@pytest.mark.parametrize("variant,share,nms", [
    ("baseline", True, 1), ("afan", True, 2), ("afan", False, 5)],
    ids=["baseline", "afan", "afan_resample"])
def test_steps_run_the_proposal_nms_and_the_update_per_step(
        setup, monkeypatch, variant, share, nms):
    """Per step: 1 proposal NMS for the baseline, 2 for A-FAN with
    ``share_proposals`` (the shared sample and the SD pass's), one per
    sampling forward without it (SE ascent, SD pass, clean forward, 2
    spectrum tails); 2 PGD updates per A-FAN step (SE and SD)."""
    jm, variables, images, jgt, tgt = setup
    tm = port_model(variables)
    opt, sched = sgd(detect_loop.detection_param_groups(tm),
                     lambda c: LR, LR, 0.9, 5e-4)
    if variant == "afan":
        step = detect_loop.make_afan_det_step(
            tm, opt, sched, detect_loop.DetAfanConfig(
                share_proposals=share, noise_sd=0.5, **AFAN))
    else:
        step = detect_loop.make_baseline_det_step(tm, opt, sched)
    nms_calls = counting(monkeypatch, tnms, "nms_sorted_mask")
    updates = counting(monkeypatch, attack, "pgd_update")
    out = step(t(images), *tgt, torch.Generator().manual_seed(0))
    assert np.isfinite([float(v) for v in out.values()]).all()
    assert len(nms_calls) == nms
    assert len(updates) == (2 if variant == "afan" else 0)


def test_unported_step_options_raise():
    """``remat_tails``, refused once, now runs: with the ROI and with the
    RPN SD tap, resampling in every forward, the step equals the one
    without recomputation bit for bit and leaves the generator where that
    one does (``tests/test_torch_remat_detect.py`` holds it to ``afan``)."""
    rng = np.random.RandomState(5)
    images = t(rng.rand(B, HW, HW, 3).astype(np.float32))
    boxes, classes, valid = gt_batch(1)
    gt = (t(boxes), t(classes, torch.int64), t(valid))
    for kw in (dict(AFAN), dict(AFAN, sd="rpn")):
        runs = []
        for remat_tails in (False, True):
            torch.manual_seed(0)
            tm = FasterRCNN(FRCNNConfig(**TINY))
            tm.reset_parameters(torch.Generator().manual_seed(0))
            opt, sched = sgd(detect_loop.detection_param_groups(tm),
                             lambda c: LR, LR)
            step = detect_loop.make_afan_det_step(
                tm, opt, sched, detect_loop.DetAfanConfig(
                    share_proposals=False, remat_tails=remat_tails, **kw))
            g = torch.Generator().manual_seed(1)
            out = step(images, *gt, g)
            runs.append((out, g.get_state(), tm.state_dict()))
        (out, g_state, state), (want, want_g, want_state) = runs[1], runs[0]
        assert np.isfinite(float(out["loss"]))
        assert torch.equal(g_state, want_g)
        for k in want:
            assert torch.equal(out[k], want[k]), k
        for k in want_state:
            assert torch.equal(state[k], want_state[k]), k


# ---------- schedule, data, mAP ----------

def test_warmup_multistep_lr_sequence_matches_afan():
    args = (0.008, [6, 9], 0.1, 0.3333, 5)
    want = j_schedule(*args)
    got = warmup_multistep_schedule(*args)
    for count in range(14):
        assert got(count) == pytest.approx(float(want(count)), rel=1e-6)


def batches_equal(got, want):
    for g, w in zip(got, want, strict=True):
        assert g.image_ids == w.image_ids
        for f in ("images", "scales", "boxes", "labels", "valid"):
            a, b = getattr(g, f), getattr(w, f)
            assert a.dtype == b.dtype and np.array_equal(a, b), f


@pytest.mark.parametrize("seed", [0, 3])
def test_loaders_are_byte_identical_to_afans(seed):
    """Train and eval loaders at a small canvas, tall and fat batches."""
    want = j_voc_det.voc_detection_loaders("/nonexistent", 4, 96, 160, seed)
    got = registry.detection_loaders("voc2007", "/nonexistent", 4, 96, 160,
                                     seed)
    assert got[2] == want[2] == 21
    train = list(got[0])
    assert {b.images.shape[1:3] for b in train} == {(96, 160), (160, 96)}
    batches_equal(train, list(want[0]))
    batches_equal(list(got[1])[:6], list(want[1])[:6])


def test_loader_refuses_what_is_not_ported(tmp_path):
    """A VOC tree without its split lists raises, for VOC and its cat/dog
    subset, as ``afan``'s loaders do (whole trees are read in
    ``tests/test_torch_data_disk.py``)."""
    os.makedirs(tmp_path / "VOC2007" / "Annotations")
    for loaders in (voc_det.voc_detection_loaders,
                    j_voc_det.voc_detection_loaders):
        with pytest.raises(FileNotFoundError, match="trainval.txt"):
            loaders(str(tmp_path), 2)
    for name in ("voc2007", "voc2007-cat-dog"):
        with pytest.raises(FileNotFoundError, match="trainval.txt"):
            registry.detection_loaders(name, str(tmp_path), 2, 600, 1000)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_voc_map_matches_afan_and_the_oracle(seed):
    rng = np.random.RandomState(seed)
    gt, ids, boxes, classes, probs = {}, [], [], [], []
    for i in range(6):
        n = rng.randint(1, 6)
        xy = rng.rand(n, 2) * 200
        b = np.concatenate([xy, xy + 20 + rng.rand(n, 2) * 60], 1)
        gt[f"im{i}"] = (b, rng.randint(1, 4, n), rng.rand(n) < 0.2)
        for j in range(rng.randint(3, 12)):
            k = rng.randint(n)
            ids.append(f"im{i}")
            boxes.append(b[k] + rng.randn(4) * (3 if j % 2 else 25))
            classes.append(rng.randint(1, 4))
    probs = rng.permutation(len(ids)) / len(ids) + 0.01   # distinct
    for metric07 in (True, False):
        args = (4, gt, ids, np.array(boxes), np.array(classes), probs)
        got = det_map.evaluate_detections(*args, use_07_metric=metric07)
        want = j_det_map.evaluate_detections(*args, use_07_metric=metric07)
        oracle = oracle_voc_map(*args, use_07_metric=metric07)
        assert got == want
        assert got[0] == pytest.approx(oracle[0], abs=1e-9)


# ---------- the CLI ----------

def smoke_tiny_flags():
    return shlex.split(
        "--data_dir /nonexistent --backbone resnet18 --batch_size 2 "
        "--image_min_side 64 --image_max_side 96 --anchor_sizes [16,32] "
        "--rpn_pre_nms_top_n 256 --rpn_post_nms_top_n 64 "
        "--num_steps_to_finish 2 --num_steps_to_snapshot 2 "
        "--num_steps_to_display 1")


def test_smoke_tiny_flags_are_the_recipes():
    with open(os.path.join(ROOT, "recipes", "_common.sh")) as f:
        text = f.read().replace("\\\n", " ")
    start = text.index('if [ -n "${SMOKE_TINY}" ]; then\n    echo')
    line = text[start:].split('echo "', 1)[1].split('"', 1)[0]
    assert shlex.split(line) == smoke_tiny_flags()


def test_cli_on_cpu_with_checkpoint_resume_and_map(tmp_path):
    out = str(tmp_path)
    argv = (["--device", "cpu", "--variant", "afan", "-o", out,
             "--mix_layer", "0011"] + smoke_tiny_flags())
    mean_ap = train_detect.main(argv)
    assert 0.0 <= mean_ap <= 1.0
    ckpt = os.path.join(out, "model-2.pt")
    saved = load_training_state(ckpt)
    assert saved["step"] == 2
    assert saved["scheduler_state_dict"]["last_epoch"] == 2
    assert len(saved["optimizer_state_dict"]["state"]) > 0
    weights = load_checkpoint(ckpt)
    args = [a if a != "2" else "3" for a in argv]   # finish at step 3
    train_detect.main(args + ["--resume_checkpoint", ckpt])
    resumed = load_training_state(os.path.join(out, "model-3.pt"))
    assert resumed["step"] == 3
    assert resumed["scheduler_state_dict"]["last_epoch"] == 3
    # frozen weights stay, trained ones move on
    w = resumed["state_dict"]
    assert torch.equal(w["features.layer1.0.conv1.weight"],
                       weights["features.layer1.0.conv1.weight"])
    assert not torch.equal(w["rpn._features.0.weight"],
                           weights["rpn._features.0.weight"])


def test_cli_loads_a_torchvision_backbone(tmp_path):
    """``--pretrained_backbone`` overlap-loads a torchvision-keyed ResNet
    state dict (its ``fc`` ignored) into the torso, ``detection.hidden``
    (layer4) included; the frozen part leaves training unchanged."""
    torso = FasterRCNN(FRCNNConfig(backbone="resnet18")).features
    torso.reset_parameters(torch.Generator().manual_seed(5))
    for m in torso.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            m.running_var.fill_(2.0)
    sd = dict(torso.state_dict(), **{"fc.weight": torch.zeros(10, 512),
                                     "fc.bias": torch.zeros(10)})
    path = str(tmp_path / "resnet18.pth")
    torch.save(sd, path)
    out = str(tmp_path / "run")
    train_detect.main(["--device", "cpu", "--variant", "baseline", "-o", out,
                       "--pretrained_backbone", path] + smoke_tiny_flags())
    got = load_checkpoint(os.path.join(out, "model-2.pt"))
    for k in ("conv1.weight", "layer1.0.conv1.weight", "bn1.running_var",
              "layer4.1.bn2.running_var"):
        assert torch.equal(got[f"features.{k}"], sd[k]), k
    assert torch.equal(got["detection.hidden.1.bn2.running_var"],
                       sd["layer4.1.bn2.running_var"])


def test_cli_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_detect.main(["--variant", "baseline"] + smoke_tiny_flags())


def recipe_flags():
    """The flags ``recipes/detect_voc07_final_setting1.sh`` passes to
    afan's detection CLI, its data flags at their full-size value."""
    with open(os.path.join(ROOT, "recipes",
                           "detect_voc07_final_setting1.sh")) as f:
        text = f.read().replace("\\\n", " ")
    line = next(ln for ln in text.splitlines()
                if "-m afan.cli.train_detect" in ln)
    line = line.replace('"${OUT}"', "./outputs/voc07_final1")
    line = line.replace("$(det_smoke_flags)", "")
    assert "$" not in line, line
    argv = shlex.split(line)
    return argv[argv.index("afan.cli.train_detect") + 1:]


def test_cli_takes_the_recipe_flags():
    flags = recipe_flags()
    assert "--bf16" in flags
    args = train_detect.get_parser().parse_args(flags)
    assert args.bf16
    cfg = train_detect.afan_config_for(args)
    assert (args.variant, args.backbone, args.batch_size) == (
        "afan", "resnet50", 8)
    assert cfg.mix_mask == (0, 0, 0, 1, 1) and cfg.taps_se == (2,)
    assert cfg.gammas_se == (1.0 / 255,) and cfg.gamma_sd == 0.1 / 255
    assert cfg.sd == "roi" and cfg.sd_weight == 0.3 and cfg.share_proposals
    from afan.cli import train_detect as j_train_detect
    j_args = j_train_detect.get_parser().parse_args(flags)
    assert cfg == train_detect.afan_config_for(j_args)
    assert j_train_detect.afan_config_for(j_args) == j_loop.DetAfanConfig(
        **{f: getattr(cfg, f) for f in cfg.__dataclass_fields__})
    assert args.bf16 == j_args.bf16


@pytest.mark.parametrize("flags", [["--num_devices", "2"],
                                   ["--remat_tails"]],
                         ids=["num_devices", "remat_tails"])
def test_cli_refuses_unported_flags(flags, tmp_path, monkeypatch):
    """The flags that were not ported once, and are now, train:
    ``--num_devices 2`` (data parallelism) on two gloo processes, where
    rank 0 writes the checkpoint, and ``--remat_tails`` with the A-FAN
    step's spectrum tails recomputed."""
    argv = ["--device", "cpu", "-o", str(tmp_path)] + flags + \
        smoke_tiny_flags()
    configs = []
    real = train_detect.make_afan_det_step
    monkeypatch.setattr(train_detect, "make_afan_det_step", lambda *a, **kw:
                        configs.append(a[3]) or real(*a, **kw))
    train_detect.main(argv + ["--num_steps_to_finish", "1",
                              "--num_steps_to_snapshot", "1"])
    assert os.path.isfile(tmp_path / "model-1.pt")
    assert [c.remat_tails for c in configs] == (
        [True] if flags == ["--remat_tails"] else [])


def test_cli_bf16_builds_a_bf16_model_and_runs_a_step(tmp_path, monkeypatch):
    """``--bf16`` makes bfloat16 the model's compute dtype; its parameters
    and checkpoint stay float32 (``tests/test_torch_detect_bf16.py`` holds
    the bf16 steps to ``afan``'s)."""
    built, losses = [], []
    real_model, real_step = train_detect.FasterRCNN, \
        train_detect.make_baseline_det_step

    def model_recording(*a):
        model = real_model(*a)
        built.append((model.dtype, {p.dtype for p in model.parameters()}))
        return model

    def step_recording(*a):
        step = real_step(*a)

        def run(*args):
            out = step(*args)
            losses.append(float(out["loss"]))
            return out
        return run
    monkeypatch.setattr(train_detect, "FasterRCNN", model_recording)
    monkeypatch.setattr(train_detect, "make_baseline_det_step",
                        step_recording)
    out = str(tmp_path)
    flags = [a if a != "2" else "1" for a in smoke_tiny_flags()]
    mean_ap = train_detect.main(["--device", "cpu", "--variant", "baseline",
                                 "-o", out, "--bf16"] + flags)
    assert built == [(torch.bfloat16, {torch.float32})]
    assert len(losses) == 1 and np.isfinite(losses).all()
    assert 0.0 <= mean_ap <= 1.0
    weights = load_checkpoint(os.path.join(out, "model-1.pt"))
    assert {v.dtype for v in weights.values()
            if v.is_floating_point()} == {torch.float32}
