"""afan_torch's dilated ResNet and DeepLab against afan's, with one set of
weights carried across by ``deeplab_variables_to_state_dict``: DeepLabv3+
on ResNet-18 at 33x33 (4 classes) in eval and train mode, the torso at
output stride 16 and 8, one ResNet-50 forward, the running statistics after
a train forward, and the weight round trip through ``afan``'s own
``convert_torch_deeplab``.

ASPP's ``Dropout(0.1)`` draws masks that cannot match across frameworks:
train-mode comparisons neutralize it on both sides (``p = 0`` on the port's
modules, flax's ``Dropout.__call__`` patched to the identity), and the
dropout itself is tested alone.

Tolerance: convolutions sum in another order in XLA and in PyTorch, and
train-mode BatchNorm divides by batch statistics of small maps, so outputs
agree within ``1e-4 * max|x|`` of the compared tensor (1e-5 for the weight
round trip, which is exact).
"""
import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from afan.interop.torch_zoo import convert_torch_deeplab
from afan.models.deeplab import modeling as jmodeling
from afan.models.resnet import from_name as j_resnet
from afan_torch.interop.from_jax import deeplab_variables_to_state_dict
from afan_torch.models.deeplab import DeepLab, build_model
from afan_torch.models.resnet import from_name, frozen_bn_stats, BatchNorm

HW = 33
NC = 4


def close(got, want, rel=1e-4):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * max(np.abs(want).max(), 1e-6))


def nhwc(t):
    return t.permute(0, 2, 3, 1).detach().numpy()


def randomize(variables, rng):
    """Non-trivial BatchNorm statistics and biases, so that a mis-mapped
    leaf shows."""
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


def no_dropout(model):
    for m in model.modules():
        if isinstance(m, torch.nn.Dropout):
            m.p = 0.0
    return model


@pytest.fixture
def flax_no_dropout(monkeypatch):
    monkeypatch.setattr(fnn.Dropout, "__call__",
                        lambda self, inputs, *a, **k: inputs)


def batch(rng, n=2):
    """Images whose global means differ from entry to entry: ASPP's image
    pooling normalizes one value per entry, and flax's BatchNorm takes the
    variance as E[x^2] - E[x]^2, which loses the digits of a variance much
    smaller than the squared mean (alike noise images give one)."""
    scale = np.linspace(0.4, 1.0, n, dtype=np.float32)[:, None, None, None]
    return (rng.rand(n, HW, HW, 3) * scale).astype(np.float32)


def make_pair(backbone, plus=True, output_stride=16, seed=0):
    jm = jmodeling.DeepLab(backbone_name=backbone, num_classes=NC,
                           output_stride=output_stride, plus=plus)
    rng = np.random.RandomState(seed)
    images = batch(rng)
    key = jax.random.PRNGKey(seed)
    variables = jm.init({"params": key, "dropout": key},
                        jnp.asarray(images), False)
    variables = randomize(variables, rng)
    tm = DeepLab(backbone, NC, output_stride, plus)
    tm.load_state_dict(deeplab_variables_to_state_dict(variables, plus),
                       strict=True)
    return jm, variables, tm, images


@pytest.fixture(scope="module")
def pair():
    return make_pair("resnet18")


def japply(jm, variables, method, *args, train=False):
    if train:
        return jm.apply(variables, *args, True, method=method,
                        mutable=["batch_stats"])[0]
    return jm.apply(variables, *args, False, method=method)


@pytest.mark.parametrize("plus", [True, False])
def test_weight_round_trip_is_exact(plus):
    _, variables, tm, _ = make_pair("resnet18", plus=plus, seed=1)
    sd = {k: v.numpy() for k, v in tm.state_dict().items()}
    params, stats, skipped = convert_torch_deeplab(sd, plus)
    assert skipped == []
    for got, want in ((params, variables["params"]),
                      (stats, variables["batch_stats"])):
        gl = jax.tree_util.tree_leaves_with_path(got)
        wl = dict(jax.tree_util.tree_leaves_with_path(want))
        assert len(gl) == len(wl)
        for path, g in gl:
            np.testing.assert_array_equal(g, wl[path])


@pytest.mark.parametrize("output_stride", [16, 8])
@pytest.mark.parametrize("train", [False, True])
def test_dilated_torso(output_stride, train):
    jt = j_resnet("resnet18", output_stride=output_stride, frozen_bn=False,
                  bn_momentum=0.99, remat=False)
    rng = np.random.RandomState(2)
    x = batch(rng)
    variables = randomize(jt.init(jax.random.PRNGKey(2), jnp.asarray(x)),
                          rng)
    sd = deeplab_variables_to_state_dict(
        {c: {"backbone": variables[c]} for c in variables})
    tt = from_name("resnet18", output_stride=output_stride, norm=BatchNorm)
    tt.load_state_dict({k[len("backbone."):]: v for k, v in sd.items()})
    tt.train(train)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    for tap in (1, 2, 3, 4):
        kw = dict(mutable=["batch_stats"]) if train else {}
        want = jt.apply(variables, jnp.asarray(x), tap, train,
                        method=jt.head, with_low_level=True, **kw)
        want = want[0] if train else want
        with frozen_bn_stats(tt):
            feat, low = tt.head(xt, tap)
        close(nhwc(feat), want[0])
        close(nhwc(low), want[1])
    stride = {16: 3, 8: 5}[output_stride]          # 33 / os, rounded up
    assert feat.shape[2:] == (stride, stride)


@pytest.mark.parametrize("train", [False, True])
def test_deeplab_methods(pair, flax_no_dropout, train):
    jm, variables, tm, images = pair
    no_dropout(tm).train(train)
    x = jnp.asarray(images)
    xt = torch.from_numpy(images).permute(0, 3, 1, 2)
    with frozen_bn_stats(tm), torch.no_grad():
        close(nhwc(tm.forward_logits(xt)),
              japply(jm, variables, jm.forward_logits, x, train=train))
        close(nhwc(tm.low_level_feature(xt)),
              japply(jm, variables, jm.low_level_feature, x, train=train))
        if not train:
            close(nhwc(tm(xt)), jm.apply(variables, x, False))
        for which in ("aspp", "concat"):
            sd = tm.sd_head(xt, which)
            want = japply(jm, variables,
                          lambda m, *a: m.sd_head(*a), x, which, train=train)
            for k in ("adv", "low_level", "out"):
                close(nhwc(sd[k]), want[k])
            adv = sd["adv"] * 1.1
            want_adv = jnp.asarray(nhwc(adv))
            close(nhwc(tm.sd_tail_logits(sd, which, adv)),
                  japply(jm, variables,
                         lambda m, d, a, t: m.sd_tail_logits(d, which, a, t),
                         {k: jnp.asarray(nhwc(v)) for k, v in sd.items()},
                         want_adv, train=train))
            feat, low, sd2 = tm.attack_features(xt, 2, which)
            jf, jl, jsd = japply(
                jm, variables,
                lambda m, a, t: m.attack_features(a, 2, which, t), x,
                train=train)
            close(nhwc(feat), jf)
            close(nhwc(low), jl)
            close(nhwc(sd2["adv"]), jsd["adv"])
        feat, low = tm.backbone_head(xt, 2)
        f = feat * 0.9
        close(nhwc(tm.forward_tail_logits(f, low, 2)),
              japply(jm, variables,
                     lambda m, a, b, t: m.forward_tail_logits(a, b, 2, t),
                     jnp.asarray(nhwc(f)), jnp.asarray(nhwc(low)),
                     train=train))


def test_running_stats_follow_flax_and_ascent_leaves_them(pair,
                                                          flax_no_dropout):
    jm, variables, _, images = pair
    tm = DeepLab("resnet18", NC, 16)
    tm.load_state_dict(deeplab_variables_to_state_dict(variables))
    no_dropout(tm).train()
    xt = torch.from_numpy(images).permute(0, 3, 1, 2)
    before = {k: v.clone() for k, v in tm.state_dict().items()}
    with frozen_bn_stats(tm), torch.no_grad():
        tm.forward_logits(xt)
    for k, v in tm.state_dict().items():
        assert torch.equal(v, before[k]), k
    with torch.no_grad():
        tm.forward_logits(xt)
    _, updates = jm.apply(variables, jnp.asarray(images), True,
                          method=jm.forward_logits, mutable=["batch_stats"])
    want = deeplab_variables_to_state_dict(
        {"batch_stats": jax.device_get(updates["batch_stats"])})
    got = tm.state_dict()
    for k, v in want.items():
        if k.endswith("num_batches_tracked"):
            continue
        close(got[k].numpy(), v.numpy(), rel=1e-5)
        if k.endswith("running_var"):
            assert not torch.allclose(got[k], before[k])


def test_resnet50_forward():
    jm, variables, tm, images = make_pair("resnet50", seed=3)
    tm.eval()
    with torch.no_grad():
        got = tm.forward_logits(torch.from_numpy(images).permute(0, 3, 1, 2))
    close(nhwc(got), jm.apply(variables, jnp.asarray(images), False,
                              method=jm.forward_logits))


def test_dropout_is_active_in_train_mode_only():
    """ASPP's Dropout(0.1): zeroes about a tenth of the projected feature
    in train mode and scales the rest by 1/0.9; eval mode is the
    identity."""
    tm = DeepLab("resnet18", NC, 16)
    drop = tm.classifier.aspp.project[3]
    assert isinstance(drop, torch.nn.Dropout) and drop.p == 0.1
    y = torch.ones(2, 256, 20, 20)
    torch.manual_seed(0)
    tm.train()
    out = drop(y)
    zero = float((out == 0).float().mean())
    assert 0.08 < zero < 0.12
    assert torch.allclose(out[out != 0], torch.full_like(out[out != 0],
                                                         1 / 0.9))
    tm.eval()
    assert torch.equal(drop(y), y)


def test_build_model_names():
    m = build_model("deeplabv3_resnet50", 19, 8)
    assert m.backbone.layer4[0].conv2.dilation == (2, 2)
    m = build_model("deeplabv3plus_mobilenet", 19, 8)
    assert m.backbone.b6_0.depthwise.dilation == (4, 4)
    with pytest.raises(ValueError):
        build_model("nope", 19)
