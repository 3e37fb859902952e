"""afan_torch's detection stack under bfloat16 (``--bf16``) against afan's
bfloat16 path, at the size of ``tests/test_torch_detect_train.py``
(ResNet-18, 4 classes, 64x64 images, 128 → 32 proposals), whose setup,
converters and injection of ``afan``'s randomness (sampling priorities,
whole targets) this file reuses.

Module-level checks, each on the same bfloat16 inputs on both sides:

- frozen BatchNorm is Flax's ``(x - mean) * (rsqrt(var + eps) * scale) +
  bias`` rounded once, with the multiply-add fused as in ``afan``'s jitted
  steps: within one bf16 ulp, the count printed (0 on these inputs; the
  unfused formula is 2 entries apart here);
- ROIAlign and its feature gradient equal ``afan``'s ``roi_align_einsum``
  within one bf16 ulp (bf16 weights, float32 contractions summed in
  another order, one rounding);
- ``generate_proposals`` fed ``afan``'s own bf16 RPN outputs gives its
  keep masks and its proposals within float32 noise (``afan``'s jitted
  ``exp`` and the port's differ in the last float32 bit), and NMS takes
  float32 boxes;
- the RPN heads and predictors, layer by layer on ``afan``'s inputs, within
  one bf16 ulp of the product (summed in another order) and one of its sum
  with the bias (Flax's ``Conv`` and ``Dense`` round both), the CE of the
  losses within one bf16 ulp, the float32 smooth-L1 within 1e-6 relative,
  the detections' softmax within two (it divides two rounded values).

Step-level checks: the bf16 baseline and A-FAN steps against ``afan``'s
bf16 steps from the same weights and targets, the loss and every updated
parameter (by norm) within twice ``afan``'s own bf16-vs-f32 gap plus 1e-3,
as ``tests/test_torch_bf16.py``; the test prints both gaps.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from afan.models.frcnn import FasterRCNN as JFasterRCNN
from afan.models.frcnn import FRCNNConfig as JFRCNNConfig
from afan.models.frcnn import roi_head as j_roi_head
from afan.models.frcnn import rpn as j_rpn
from afan.models.resnet import FrozenBatchNorm as JFrozenBatchNorm
from afan.ops.roi_align import roi_align_einsum as j_roi_align_einsum
from afan.train import detect_loop as j_loop
from afan_torch.interop.from_jax import frcnn_variables_to_state_dict
from afan_torch.models.frcnn import FasterRCNN, FRCNNConfig
from afan_torch.models.frcnn import roi_head, rpn
from afan_torch.models.frcnn.anchors import generate_anchors
from afan_torch.models.resnet import FrozenBatchNorm
from afan_torch.ops import lowp
from afan_torch.ops import nms as tnms
from afan_torch.ops import roi_align
from afan_torch.train import detect_loop
from afan_torch.train.optim import sgd, warmup_multistep_schedule

# ``setup`` is that file's module-scoped fixture, shared here
from test_torch_detect_train import (AFAN, HW, LR, TINY, jax_state,
                                     j_targets, setup, t, to_torch)
from torch_threads import one_torch_thread  # noqa: F401

BF16 = torch.bfloat16


def to_jax(x):
    return jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)


def as_f32(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def ulp(a):
    """A bound of one bf16 ulp at ``a`` (2^-7 of its magnitude)."""
    return np.maximum(np.abs(a), np.float32(2.0 ** -126)) * 2.0 ** -7


def ulps_apart(got, want, before_bias=None, ulps=1):
    """The number of entries that differ; asserts that each is within
    ``ulps`` bf16 ulps, or, for a layer that rounds its product and then
    its sum with a bias (Flax's ``Conv`` and ``Dense``), within one ulp of
    each (``before_bias``: the product, ``want - bias``)."""
    got, want = as_f32(got), as_f32(want)
    assert got.shape == want.shape
    bound = ulps * ulp(want)
    if before_bias is not None:
        bound = bound + ulp(before_bias)
    diff = np.abs(got - want)
    assert (diff <= bound).all(), float((diff / bound).max())
    return int((diff > 0).sum())


def bias_of(variables, *path):
    node = variables["params"]
    for k in path:
        node = node[k]
    return np.asarray(node["bias"], np.float32)


def bf16_model(variables):
    tm = FasterRCNN(FRCNNConfig(**TINY), BF16)
    tm.load_state_dict(frcnn_variables_to_state_dict(variables), strict=True)
    return tm


def j_bf16():
    return JFasterRCNN(cfg=JFRCNNConfig(**TINY), dtype=jnp.bfloat16)


# ---------- modules ----------

def test_frozen_batchnorm_bf16_is_flax():
    rng = np.random.RandomState(0)
    for c, shape in ((64, (4, 9, 9)), (256, (2, 5, 7))):
        mean = rng.randn(c).astype(np.float32) * 0.5
        var = (rng.rand(c) + 0.3).astype(np.float32)
        scale = (1 + 0.1 * rng.randn(c)).astype(np.float32)
        bias = (0.1 * rng.randn(c)).astype(np.float32)
        x = torch.from_numpy(rng.randn(shape[0], c, *shape[1:]).astype(
            np.float32) * 3).to(BF16)
        jm = JFrozenBatchNorm(dtype=jnp.bfloat16)
        v = {"params": {"bn": {"scale": scale, "bias": bias}},
             "batch_stats": {"bn": {"mean": mean, "var": var}}}
        want = jax.jit(jm.apply)(v, to_jax(x.permute(0, 2, 3, 1)))
        bn = FrozenBatchNorm(c)
        with torch.no_grad():
            for p, a in ((bn.weight, scale), (bn.bias, bias),
                         (bn.running_mean, mean), (bn.running_var, var)):
                p.copy_(torch.from_numpy(a))
        got = bn(x)
        assert got.dtype == BF16 and want.dtype == jnp.bfloat16
        n = ulps_apart(got.permute(0, 2, 3, 1), want)
        print(f"frozen BatchNorm C={c}: {n} of {x.numel()} entries one bf16 "
              f"ulp from Flax's")


def test_roi_align_bf16_and_its_gradient_match_afan():
    rng = np.random.RandomState(6)
    feat = torch.from_numpy(rng.randn(3, 8, 12, 16).astype(np.float32)
                            ).to(BF16)
    xy = rng.rand(3, 10, 2) * np.array([16 * 16, 12 * 16]) - 20
    boxes = np.concatenate([xy, xy + 2 + rng.rand(3, 10, 2) * 120],
                           -1).astype(np.float32)
    boxes[:, -2:] = 0
    bidx = np.repeat(np.arange(3), 10).astype(np.int32)
    cot = torch.from_numpy(rng.randn(30, 8, 14, 14).astype(np.float32)
                           ).to(BF16)
    jout, vjp = jax.vjp(lambda x: j_roi_align_einsum(
        x, jnp.asarray(boxes.reshape(-1, 4)), jnp.asarray(bidx)),
        to_jax(feat.permute(0, 2, 3, 1)))
    (jg,) = vjp(to_jax(cot.permute(0, 2, 3, 1)))
    assert jout.dtype == jg.dtype == jnp.bfloat16
    for name, fn in (
            ("per image", lambda f: roi_align.roi_align_per_image(
                f, t(boxes))),
            ("concatenated", lambda f: roi_align.roi_align_einsum(
                f, t(boxes).reshape(-1, 4), t(bidx)))):
        f = feat.clone().requires_grad_(True)
        got = fn(f)
        (g,) = torch.autograd.grad(got, f, cot)
        assert got.dtype == g.dtype == BF16
        n_out = ulps_apart(got.permute(0, 2, 3, 1), jout)
        n_grad = ulps_apart(g.permute(0, 2, 3, 1), jg)
        print(f"ROIAlign {name}: {n_out} of {got.numel()} outputs and "
              f"{n_grad} of {g.numel()} gradient entries one bf16 ulp from "
              f"afan's")
    # the 2x2 max splits the gradient among bf16 ties, as jnp.max does
    pooled = roi_align.pool_rois(feat, t(boxes))
    want = jnp.max(jout.reshape(30, 7, 2, 7, 2, 8), axis=(2, 4))
    assert pooled.dtype == BF16
    ulps_apart(pooled.permute(0, 2, 3, 1), want)


def test_generate_proposals_on_afans_bf16_rpn_outputs(setup, monkeypatch):
    jm, variables, images, _, _ = setup
    jb = j_bf16()
    feats = jax.jit(lambda v, x: jb.apply(v, x, method=jb.features_clean))(
        variables, jnp.asarray(images))
    obj, reg = jax.jit(lambda v, f: jb.apply(
        v, f, method=lambda m, f: m.rpn(f)))(variables, feats)
    assert obj.dtype == reg.dtype == jnp.bfloat16
    cfg = JFRCNNConfig(**TINY)
    fh, fw = feats.shape[1:3]
    anchors = jnp.asarray(generate_anchors(HW, HW, fw, fh,
                                           sizes=TINY["anchor_sizes"]))
    want_boxes, want_valid = jax.jit(jax.vmap(
        lambda o, r: j_rpn.generate_proposals(
            anchors, o, r, HW, HW, cfg.train_pre_nms_top_n,
            cfg.train_post_nms_top_n)))(obj, reg)
    seen = []
    real = tnms.nms_sorted_mask

    def recording(boxes, valid, thr, plus_one=True):
        seen.append(boxes.dtype)
        return real(boxes, valid, thr, plus_one)
    monkeypatch.setattr(tnms, "nms_sorted_mask", recording)
    o = torch.from_numpy(as_f32(obj)).to(BF16)
    r = torch.from_numpy(as_f32(reg)).to(BF16)
    boxes, valid = rpn.generate_proposals(
        t(np.asarray(anchors)), o, r, HW, HW, cfg.train_pre_nms_top_n,
        cfg.train_post_nms_top_n)
    assert seen == [torch.float32] and boxes.dtype == torch.float32
    np.testing.assert_array_equal(valid.numpy(), np.asarray(want_valid))
    np.testing.assert_allclose(boxes.numpy(), np.asarray(want_boxes),
                               rtol=1e-6, atol=1e-5)
    scores = as_f32(obj)[..., 1]
    ties = sum(len(s) - len(np.unique(s)) for s in scores)
    print(f"proposals equal afan's; {ties} tied bf16 fg logits among "
          f"{scores.size}; kept {valid.sum(1).tolist()}")


def test_bf16_heads_losses_and_softmax_match_afan(setup):
    jm, variables, images, jgt, _ = setup
    jb = j_bf16()
    tm = bf16_model(variables)
    key = jax.random.PRNGKey(7)
    feats = jax.jit(lambda v, x: jb.apply(v, x, method=jb.features_clean))(
        variables, jnp.asarray(images))
    f = torch.from_numpy(as_f32(feats)).to(BF16).permute(0, 3, 1, 2)
    obj, reg = jax.jit(lambda v, f: jb.apply(
        v, f, method=lambda m, f: m.rpn(f)))(variables, feats)
    # layer by layer, each on afan's input: a bf16 conv, then its bias
    trunk = jax.jit(lambda v, f: jb.apply(
        v, f, method=lambda m, f: m.rpn.trunk_conv(f)))(variables, feats)
    got = tm.rpn._features[0](f)
    n = ulps_apart(got.permute(0, 2, 3, 1), trunk, as_f32(trunk)
                   - bias_of(variables, "rpn", "trunk"))
    trunk = jax.nn.relu(trunk)
    t_in = torch.from_numpy(as_f32(trunk)).to(BF16).permute(0, 3, 1, 2)
    count = got.numel()
    for name, conv in (("objectness", tm.rpn._anchor_objectness),
                       ("transformer", tm.rpn._anchor_transformer)):
        want = jax.jit(lambda v, x, name=name: jb.apply(
            v, x, method=lambda m, x: getattr(m.rpn, name + "_conv")(x))
        )(variables, trunk)
        got = conv(t_in)
        assert got.dtype == BF16
        n += ulps_apart(got.permute(0, 2, 3, 1), want, as_f32(want)
                        - bias_of(variables, "rpn", name))
        count += got.numel()
    print(f"RPN heads: {n} of {count} outputs apart from afan's (within one "
          f"bf16 ulp of the conv and one of the bias sum)")

    jt = j_targets(jb, variables, images, jgt, key)
    tt = to_torch(jt)
    ce, l1 = jax.vmap(j_rpn.rpn_loss, in_axes=(0, 0, 0, None))(
        obj, reg, jt[0], 1.0)
    o, r = (torch.from_numpy(as_f32(a)).to(BF16) for a in (obj, reg))
    tce, tl1 = rpn.rpn_loss(o, r, tt[0], 1.0)
    assert tce.dtype == BF16 and ce.dtype == jnp.bfloat16
    assert tl1.dtype == torch.float32 and l1.dtype == jnp.float32
    ulps_apart(tce, ce)
    np.testing.assert_allclose(tl1.numpy(), np.asarray(l1), rtol=1e-6)

    rng = np.random.RandomState(3)
    s = jt[1].boxes.shape[1]
    hv = torch.from_numpy(rng.randn(2 * s, 512).astype(np.float32)).to(BF16)
    cls, rg = jax.jit(lambda v, h: jb.apply(
        v, h, method=lambda m, h: m.roi_pred(h)))(variables, to_jax(hv))
    tcls, trg = tm.detection(hv)
    assert tcls.dtype == trg.dtype == BF16
    n = ulps_apart(tcls, cls) + ulps_apart(trg, rg)
    print(f"predictors: {n} of {tcls.numel() + trg.numel()} outputs one "
          f"bf16 ulp from afan's")
    cls, rg = cls.reshape(2, s, -1), rg.reshape(2, s, -1)
    ce, l1 = jax.vmap(j_roi_head.roi_loss, in_axes=(0, 0, 0, None, None))(
        cls, rg, jt[1], 1.0, 4)
    c, g = (torch.from_numpy(as_f32(a)).to(BF16) for a in (cls, rg))
    tce, tl1 = roi_head.roi_loss(c, g, tt[1], 1.0, 4)
    assert tce.dtype == BF16 and tl1.dtype == torch.float32
    ulps_apart(tce, ce)
    np.testing.assert_allclose(tl1.numpy(), np.asarray(l1), rtol=1e-6)
    # the softmax divides two rounded values (the exp and the sum of the
    # float32 exp), each of which may land one ulp apart
    n = (ulps_apart(lowp.softmax(c, -1), jax.nn.softmax(cls, -1), ulps=2)
         + ulps_apart(lowp.log_softmax(c, -1), jax.nn.log_softmax(cls, -1)))
    print(f"softmax and log_softmax: {n} of {2 * c.numel()} entries apart "
          f"from jax.nn's")


def test_bf16_model_keeps_float32_parameters_and_detects(setup):
    _, variables, images, _, _ = setup
    tm = bf16_model(variables)
    assert {p.dtype for p in tm.parameters()} == {torch.float32}
    with torch.no_grad():
        boxes, probs, keep = tm.detect(t(images))
        loss = tm.losses(t(images), *setup[4], torch.Generator().manual_seed(0)
                         ).total()
    assert boxes.dtype == torch.float32 and probs.dtype == BF16
    assert loss.dtype == torch.float32 and np.isfinite(float(loss))
    _, probs32, _ = detect_loop.make_detect_fn(tm)(t(images))
    assert probs32.dtype == torch.float32


# ---------- steps ----------

def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-12))


def afan_det_step(variables, images, jgt, key, afan, dtype):
    jm = JFasterRCNN(cfg=JFRCNNConfig(**TINY), dtype=dtype)
    state, tx = jax_state(variables)
    step = (j_loop.make_afan_det_step(jm, tx, j_loop.DetAfanConfig(**AFAN))
            if afan else j_loop.make_baseline_det_step(jm, tx))
    state, metrics = step(state, jnp.asarray(images), *jgt, key)
    return frcnn_variables_to_state_dict(jax.device_get(
        {"params": state.params, "batch_stats": state.batch_stats})), \
        float(metrics["loss"])


@pytest.mark.parametrize("afan", [False, True], ids=["baseline", "afan"])
def test_bf16_step_matches_afans(setup, afan):
    _, variables, images, jgt, tgt = setup
    key = jax.random.PRNGKey(12 if afan else 11)
    jb = j_bf16()
    if afan:
        _, r_sd, r_clean, _, _, _ = jax.random.split(key, 6)
        targets = {"clean": to_torch(j_targets(jb, variables, images, jgt,
                                               r_clean)),
                   "sd": to_torch(j_targets(jb, variables, images, jgt,
                                            r_sd))}
    else:
        targets = to_torch(j_targets(jb, variables, images, jgt, key))
    j16, loss16 = afan_det_step(variables, images, jgt, key, afan,
                                jnp.bfloat16)
    j32, loss32 = afan_det_step(variables, images, jgt, key, afan,
                                jnp.float32)
    tm = bf16_model(variables)
    opt, sched = sgd(detect_loop.detection_param_groups(tm),
                     warmup_multistep_schedule(LR, [10], 0.1, 1.0 / 3, 5),
                     LR, 0.9, 5e-4)
    step = (detect_loop.make_afan_det_step(
        tm, opt, sched, detect_loop.DetAfanConfig(**AFAN)) if afan
        else detect_loop.make_baseline_det_step(tm, opt, sched))
    out = step(t(images), *tgt, targets=targets)
    loss = float(out["loss"])
    port_gap = abs(loss - loss16) / abs(loss16)
    own_gap = abs(loss16 - loss32) / abs(loss16)
    print(f"{'A-FAN' if afan else 'baseline'} loss: port {loss:.6f}, afan "
          f"bf16 {loss16:.6f}, f32 {loss32:.6f}; port-vs-afan "
          f"{port_gap:.3e}, afan bf16-vs-f32 {own_gap:.3e}")
    assert port_gap <= 2 * own_gap + 1e-3
    before = frcnn_variables_to_state_dict(variables)
    got = tm.state_dict()
    worst, moved = (0.0, ""), 0
    for k, w in j16.items():
        if k.endswith("num_batches_tracked"):
            continue
        g, w, f, b = (got[k].numpy(), w.numpy(), j32[k].numpy(),
                      before[k].numpy())
        assert got[k].dtype == torch.float32, k
        if np.array_equal(w, b):
            np.testing.assert_array_equal(g, b, err_msg=k)
            continue
        moved += 1
        scale = max(np.linalg.norm(w - b), 1e-12)
        port = np.linalg.norm(g - w) / scale
        own = np.linalg.norm(w - f) / scale
        worst = max(worst, (port / (2 * own + 1e-3), k))
        assert port <= 2 * own + 1e-3, (k, port, own)
    assert moved > 20
    print(f"updates of {moved} tensors: the largest port-vs-afan gap is "
          f"{worst[0]:.3f} of its bound ({worst[1]})")


def test_sd_noise_is_drawn_in_float32(setup, monkeypatch):
    """``afan``'s ``uniform_init`` draws the SD noise in its default float32
    whatever the pooled vector's dtype, and the sum promotes it; the
    predictors cast it back to bf16."""
    _, variables, images, _, tgt = setup
    drawn = []
    real = detect_loop.uniform_init

    def recording(shape, scale, generator=None, dtype=torch.float32,
                  device=None):
        drawn.append(dtype)
        return real(shape, scale, generator, dtype, device)
    monkeypatch.setattr(detect_loop, "uniform_init", recording)
    tm = bf16_model(variables)
    opt, sched = sgd(detect_loop.detection_param_groups(tm), lambda c: LR,
                     LR, 0.9, 5e-4)
    step = detect_loop.make_afan_det_step(
        tm, opt, sched, detect_loop.DetAfanConfig(noise_sd=0.5, **AFAN))
    out = step(t(images), *tgt, torch.Generator().manual_seed(0))
    assert drawn == [torch.float32]
    assert all(np.isfinite(float(v)) for v in out.values())
