"""afan_torch's Faster R-CNN against afan's on a tiny configuration
(ResNet-18, 4 classes, anchor sizes (32, 64), 64 → 8 eval proposals,
64x64 images), with one set of weights carried across by
``frcnn_variables_to_state_dict``.

Tolerances (float32 on the CPU): continuous outputs agree within
``atol = 1e-4 * max|x|`` of the compared tensor — convolutions and
contractions sum in another order in XLA and in PyTorch, so the last bits
differ in proportion to the magnitude. Discrete outputs (which proposals
survive, the keep masks) must be exactly equal; where they rest on a sort of
scores that differ by float noise, the test also asserts that adjacent
sorted scores are more than ten times that noise apart, so that a flip reads
as a bug and not as noise.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from afan.interop.torch_zoo import convert_torch_frcnn
from afan.models.frcnn import FasterRCNN as JFasterRCNN
from afan.models.frcnn import FRCNNConfig as JFRCNNConfig
from afan.models.frcnn.roi_head import generate_detections as j_gen_dets
from afan.models.frcnn.rpn import generate_proposals as j_gen_props
from afan.ops.roi_align import pool_rois as j_pool_rois
from afan.ops.roi_align import roi_align_einsum as j_roi_align
from afan_torch.interop.from_jax import frcnn_variables_to_state_dict
from afan_torch.models.frcnn import FasterRCNN, FRCNNConfig
from afan_torch.models.frcnn.roi_head import generate_detections
from afan_torch.models.frcnn.rpn import generate_proposals
from afan_torch.ops.roi_align import (pool_rois, roi_align_einsum,
                                      roi_align_gather)
from afan_torch.train.detect_loop import make_detect_fn
from torch_threads import one_torch_thread  # noqa: F401

TINY = dict(backbone="resnet18", num_classes=4, anchor_sizes=(32, 64),
            eval_pre_nms_top_n=64, eval_post_nms_top_n=8)
HW = 64


def close(got, want, rel=1e-4):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * max(np.abs(want).max(), 1e-6))


def nhwc(t):
    return t.permute(0, 2, 3, 1).detach().numpy()


def assert_separated(scores, noise, k):
    """The first ``k + 1`` sorted scores along the last axis are more than
    ten times ``noise`` apart (so the top-k set and its order are stable)."""
    s = -np.sort(-np.asarray(scores), axis=-1)[..., :k + 1]
    gap = np.min(s[..., :-1] - s[..., 1:])
    assert gap > 10 * noise, (gap, noise)


def _randomize(variables, rng):
    """Non-trivial BN statistics and biases, so a mis-mapped leaf shows."""
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
def pair():
    jm = JFasterRCNN(cfg=JFRCNNConfig(**TINY))
    # seed 3: adjacent sorted scores are well apart (see assert_separated)
    rng = np.random.RandomState(3)
    images = rng.rand(2, HW, HW, 3).astype(np.float32)
    variables = jm.init({"params": jax.random.PRNGKey(0)},
                        jnp.asarray(images), method=jm.detect)
    variables = _randomize(variables, rng)
    tm = FasterRCNN(FRCNNConfig(**TINY))
    tm.load_state_dict(frcnn_variables_to_state_dict(variables), strict=True)
    tm.eval()
    return jm, variables, tm, images


def japply(jm, variables, fn, *args):
    return jm.apply(variables, *args, method=fn)


def test_weight_round_trip_is_exact(pair):
    _, variables, tm, _ = pair
    sd = {k: v.numpy() for k, v in
          frcnn_variables_to_state_dict(variables).items()}
    assert set(sd) == set(tm.state_dict())
    params, stats, skipped = convert_torch_frcnn(sd)
    assert skipped == []
    for got, want in ((params, variables["params"]),
                      (stats, variables["batch_stats"])):
        gl = jax.tree_util.tree_leaves_with_path(got)
        wl = jax.tree_util.tree_leaves_with_path(want)
        assert [p for p, _ in gl] == [p for p, _ in wl]
        for (_, g), (_, w) in zip(gl, wl):
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("tap", [1, 2, 3])
def test_torso_features(pair, tap):
    jm, variables, tm, images = pair
    want = japply(jm, variables, lambda m, x: m.backbone_head(x, tap),
                  jnp.asarray(images))
    with torch.no_grad():
        got = tm.features(torch.from_numpy(images).permute(0, 3, 1, 2), 0, tap)
    close(nhwc(got), want)


def test_hidden_layer4(pair):
    jm, variables, tm, images = pair
    feat = japply(jm, variables, lambda m, x: m.features_clean(x),
                  jnp.asarray(images))
    want = japply(jm, variables, lambda m, x: m.backbone.run_stage(x, 3),
                  feat)
    with torch.no_grad():
        got = tm.detection.hidden(torch.from_numpy(np.array(feat))
                                  .permute(0, 3, 1, 2))
    close(nhwc(got), want)


def test_rpn_heads(pair):
    jm, variables, tm, images = pair
    feat = japply(jm, variables, lambda m, x: m.features_clean(x),
                  jnp.asarray(images))
    jo, jr = japply(jm, variables, lambda m, f: m.rpn(f), feat)
    with torch.no_grad():
        to, tr = tm.rpn(torch.from_numpy(np.array(feat)).permute(0, 3, 1, 2))
    close(to.numpy(), jo)
    close(tr.numpy(), jr)


def _feature_and_rois(seed=3):
    rng = np.random.RandomState(seed)
    feat = rng.randn(2, 12, 16, 8).astype(np.float32)   # NHWC, stride 16
    xy = rng.rand(40, 2) * np.array([16 * 16, 12 * 16]) - 20
    wh = rng.rand(40, 2) * 120 + 2
    boxes = np.concatenate([xy, xy + wh], 1).astype(np.float32)
    bidx = rng.randint(0, 2, 40).astype(np.int32)
    return feat, boxes, bidx


@pytest.mark.parametrize("mode", ["align", "pooling"])
def test_pool_rois(mode):
    feat, boxes, bidx = _feature_and_rois()
    want = j_pool_rois(jnp.asarray(feat), jnp.asarray(boxes),
                       jnp.asarray(bidx), mode)
    got = pool_rois(torch.from_numpy(feat).permute(0, 3, 1, 2),
                    torch.from_numpy(boxes), torch.from_numpy(bidx), mode)
    close(nhwc(got), want)


def test_roi_align_einsum_matches_gather_oracle():
    feat, boxes, bidx = _feature_and_rois(4)
    args = (torch.from_numpy(feat).permute(0, 3, 1, 2),
            torch.from_numpy(boxes), torch.from_numpy(bidx))
    got = roi_align_einsum(*args)
    close(got.numpy(), roi_align_gather(*args).numpy())
    want = j_roi_align(jnp.asarray(feat), jnp.asarray(boxes),
                       jnp.asarray(bidx))
    close(nhwc(got), want)


@pytest.fixture(scope="module")
def rpn_out(pair):
    jm, variables, tm, images = pair
    feat = japply(jm, variables, lambda m, x: m.features_clean(x),
                  jnp.asarray(images))
    jo, jr = japply(jm, variables, lambda m, f: m.rpn(f), feat)
    anchors = japply(jm, variables, lambda m: m._anchors(
        (HW, HW), (feat.shape[1], feat.shape[2])))
    return feat, np.array(jo), np.array(jr), np.array(anchors)


def test_generate_proposals(rpn_out):
    _, jo, jr, anchors = rpn_out
    wb, wv = jax.vmap(j_gen_props, in_axes=(None, 0, 0, None, None, None,
                                            None))(
        jnp.asarray(anchors), jnp.asarray(jo), jnp.asarray(jr), HW, HW, 64, 8)
    gb, gv = generate_proposals(torch.from_numpy(anchors),
                                torch.from_numpy(jo), torch.from_numpy(jr),
                                HW, HW, 64, 8)
    assert_separated(jo[..., 1], 0.0, 64)   # same inputs on both sides
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
    close(gb.numpy(), wb)
    assert gv.numpy().any()


def test_generate_detections(pair, rpn_out):
    jm, variables, _, _ = pair
    feat, jo, jr, anchors = rpn_out
    props, _ = jax.vmap(j_gen_props, in_axes=(None, 0, 0, None, None, None,
                                              None))(
        jnp.asarray(anchors), jnp.asarray(jo), jnp.asarray(jr), HW, HW, 64, 8)
    rng = np.random.RandomState(5)
    logits = (rng.randn(2, 8, 4) * 2).astype(np.float32)
    reg = (rng.randn(2, 8, 16) * 0.5).astype(np.float32)
    wb, wp, wk = jax.vmap(j_gen_dets, in_axes=(0, 0, 0, None, None, None))(
        props, jnp.asarray(logits), jnp.asarray(reg), HW, HW, 4)
    gb, gp, gk = generate_detections(
        torch.from_numpy(np.array(props)), torch.from_numpy(logits),
        torch.from_numpy(reg), HW, HW, 4)
    noise = np.abs(gp.numpy() - np.asarray(wp)).max()
    assert_separated(np.swapaxes(np.asarray(wp), 1, 2), noise, 7)
    close(gb.numpy(), wb)
    close(gp.numpy(), wp)
    np.testing.assert_array_equal(gk.numpy(), np.asarray(wk))
    assert gk.numpy().any() and not gk.numpy()[..., 0].any()


def test_detect_end_to_end(pair, rpn_out):
    jm, variables, tm, images = pair
    _, jo, _, _ = rpn_out
    wb, wp, wk = jax.jit(lambda v, x: jm.apply(v, x, method=jm.detect))(
        variables, jnp.asarray(images))
    with torch.no_grad():
        to, _ = tm.rpn(tm.features_clean(
            torch.from_numpy(images).permute(0, 3, 1, 2)))
    gb, gp, gk = make_detect_fn(tm)(torch.from_numpy(images))
    # the discrete choices rest on sorts of scores computed on both sides
    assert_separated(jo[..., 1], np.abs(to.numpy() - jo).max(), 64)
    assert_separated(np.swapaxes(np.asarray(wp), 1, 2),
                     np.abs(gp.numpy() - np.asarray(wp)).max(), 7)
    np.testing.assert_array_equal(gk.numpy(), np.asarray(wk))
    close(gb.numpy(), wb)
    close(gp.numpy(), wp)
    assert gk.numpy().any()


def test_box_arithmetic():
    from afan.models.frcnn import boxes as JB
    from afan_torch.models.frcnn import boxes as TB
    rng = np.random.RandomState(8)
    xy = rng.rand(2, 30, 2) * 200
    a = np.concatenate([xy, xy + rng.rand(2, 30, 2) * 80 + 1], -1)
    xy = rng.rand(2, 20, 2) * 200
    b = np.concatenate([xy, xy + rng.rand(2, 20, 2) * 80 + 1], -1)
    a, b = a.astype(np.float32), b.astype(np.float32)
    d = (rng.randn(2, 30, 4) * 0.5).astype(np.float32)
    ta, tb, td = map(torch.from_numpy, (a, b, d))
    close(TB.decode_deltas(ta, td).numpy(), JB.decode_deltas(a, d))
    close(TB.encode_deltas(ta, ta.flip(1)).numpy(),
          JB.encode_deltas(a, a[:, ::-1]))
    close(TB.iou(ta, tb).numpy(), JB.iou(a, b))
    close(TB.clip(ta, 10, 20, 150, 120).numpy(),
          JB.clip(a, 10, 20, 150, 120))


def test_checkpoint_overlap_restore(tmp_path):
    from afan_torch.train.checkpoint import load_checkpoint, overlap_restore
    src = FasterRCNN(FRCNNConfig(**TINY))
    src.reset_parameters(torch.Generator().manual_seed(1))
    sd = {f"module.{k}": v for k, v in src.state_dict().items()}
    sd["module.rpn._anchor_objectness.weight"] = torch.zeros(3, 3)  # shape
    sd["module.not_a_module.weight"] = torch.ones(2)                 # key
    path = tmp_path / "ckpt.pth"
    torch.save({"state_dict": sd, "step": 7}, path)
    dst = FasterRCNN(FRCNNConfig(**TINY))
    dst.reset_parameters(torch.Generator().manual_seed(2))
    before = dst.rpn._anchor_objectness.weight.clone()
    frac = overlap_restore(dst, load_checkpoint(str(path)))
    n = len(dst.state_dict())
    assert frac == (n - 1) / n
    assert torch.equal(dst.rpn._anchor_objectness.weight, before)
    assert torch.equal(dst.features.conv1.weight, src.features.conv1.weight)
    assert dst.detection.hidden is dst.features.layer4
