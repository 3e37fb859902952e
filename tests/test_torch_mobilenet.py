"""afan_torch's DeepLab MobileNetV2, ``--separable_conv`` and
``--pretrained_backbone`` against afan's, with one set of weights carried
across by ``deeplab_variables_to_state_dict``.

- The MobileNetV2 backbone's ``head`` / ``tail`` at taps 1-4, output
  stride 8 and 16, in eval mode with non-trivial BatchNorm statistics.
- ``deeplabv3{,plus}_mobilenet`` with and without ``--separable_conv``, and
  DeepLabv3+ on ResNet-18 with it: ``forward_logits``,
  ``attack_features`` and ``sd_tail_logits`` on a scaled SD feature, in
  eval mode.
- The bf16 MobileNet forward (train mode), within twice ``afan``'s own
  bf16-vs-f32 gap, as ``tests/test_torch_bf16.py`` holds the ResNet.
- One A-FAN step on ``deeplabv3plus_mobilenet`` (4 classes, 33x33, batch 4;
  SE tap 3 and a spectrum of 2, which keep the compile of ``afan``'s jitted
  step short: the backbone tests hold every tap) against ``afan``'s jitted
  step: losses within 1e-4, each running
  statistic within 1e-4 of its norm (as ``tests/test_torch_segment.py``),
  each parameter's update (both start from the same values) within 2e-3 of
  its norm plus twice the port's own float32 error there (its float32
  update against its float64 one).
  MobileNetV2's linear bottleneck (no ReLU after ``project_bn``) feeds 1x1
  convolutions into train-mode BatchNorm, whose input gradient sums to zero
  per channel, so the gradient of most ``project_bn`` biases vanishes:
  their update is the weight decay, and float32 leaves 1-4% of it as
  rounding in either framework (several BatchNorm scales, whose gradient
  nearly cancels their weight decay, 0.3-0.5%).
- ``--pretrained_backbone`` from a torchvision-keyed ``state_dict`` the test
  writes: the backbone's tensors and the two logged fractions equal
  ``afan``'s, for a ResNet (every entry) and a MobileNetV2 (none: ``afan``
  has no MobileNet ImageNet loader).
- The CLI with ``--model deeplabv3plus_mobilenet --separable_conv
  --pretrained_backbone`` on the CPU, and ``eval_segment`` on the model.

Tolerance of the f32 eval-mode comparisons: ``1e-5 * max|x|`` of the
compared tensor (convolutions summed in another order).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from afan.interop.torch_zoo import load_torchvision_backbone
from afan.models.deeplab import modeling as jmodeling
from afan.models.deeplab.mobilenetv2 import \
    MobileNetV2Backbone as JMobileNetV2
from afan.train import checkpoint as j_checkpoint
from afan.train import segment_loop as jloop
from afan.train.loop import TrainState
from afan.train.optim import poly_schedule as j_poly
from afan_torch.cli import eval_segment, train_segment
from afan_torch.interop.from_jax import deeplab_variables_to_state_dict
from afan_torch.models.deeplab import DeepLab, build_model
from afan_torch.models.deeplab.mobilenetv2 import MobileNetV2Backbone
from afan_torch.models.deeplab.modeling import segmentation_param_groups
from afan_torch.models.resnet import from_name
from afan_torch.train import segment_loop
from afan_torch.train.checkpoint import (load_checkpoint,
                                         restore_pretrained_backbone)
from afan_torch.train.optim import poly_schedule, sgd
from afan_torch.utils.logging import Log

from test_torch_bf16 import rel_gap
from test_torch_deeplab import (batch, close, flax_no_dropout,  # noqa: F401
                                nhwc, no_dropout)
from test_torch_segment import LR, TOTAL, close_l2
from torch_threads import one_torch_thread  # noqa: F401

NC, B = 4, 4
TIGHT = 1e-5


def seeded_variables(module, rng, x, *static, method=None):
    """``module``'s variables with numpy-seeded values: the tree from
    ``jax.eval_shape`` of its init on ``x`` (nothing compiled), kernels
    from the distributions of ``afan``'s init (MobileNetV2: Flax's default
    lecun normal, truncated; a ResNet backbone normal with variance
    2/fan_out; the heads 2/fan_in), non-trivial BatchNorm scales, biases
    and statistics. (Untruncated MobileNetV2 kernels put the A-FAN step
    near ReLU6's kinks, where float32 moves about 1% of each update in
    either framework.)"""
    key = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(lambda x: module.init(
        {"params": key, "dropout": key}, x, *static, method=method), x)
    backbone = shapes["params"].get("backbone", shapes["params"])
    resnet = "conv1" in backbone

    def fill(path, leaf):
        name, shape = path[-1].key, leaf.shape
        if name == "kernel":
            if path[1].key == "classifier":
                var = 2.0 / np.prod(shape[:-1])
            elif resnet:
                var = 2.0 / (np.prod(shape[:-2]) * shape[-1])
            else:               # Flax's lecun_normal: truncated at 2 std
                var = 1.0 / np.prod(shape[:-1]) / .87962566103423978 ** 2
            v = rng.randn(*shape)
            if not resnet and path[1].key != "classifier":
                while (np.abs(v) > 2).any():
                    out = np.abs(v) > 2
                    v[out] = rng.randn(int(out.sum()))
            v = v * np.sqrt(var)
        elif name == "scale":
            v = 1.0 + 0.1 * rng.randn(*shape)
        elif name in ("bias", "mean"):
            v = 0.1 * rng.randn(*shape)
        else:
            v = rng.rand(*shape) + 0.5
        return v.astype(np.float32)
    return jax.tree_util.tree_map_with_path(fill, shapes)


def make_pair(backbone, plus=True, separable=False, output_stride=16,
              seed=0, n=2):
    jm = jmodeling.DeepLab(backbone_name=backbone, num_classes=NC,
                           output_stride=output_stride, plus=plus,
                           separable_conv=separable)
    rng = np.random.RandomState(seed)
    images = batch(rng, n)
    variables = seeded_variables(jm, rng, jnp.asarray(images), False)
    tm = DeepLab(backbone, NC, output_stride, plus,
                 separable_conv=separable)
    tm.load_state_dict(deeplab_variables_to_state_dict(variables, plus),
                       strict=True)
    return jm, variables, tm, images


# ---------- the backbone ----------

@pytest.fixture(scope="module")
def backbones():
    """{output stride: (afan's head and tail at every tap, the port's
    backbone, the image)}; one set of weights serves both strides (the
    stride changes no parameter's shape)."""
    out = {}
    rng = np.random.RandomState(5)
    x = batch(rng)
    variables = seeded_variables(JMobileNetV2(), rng, jnp.asarray(x), 4,
                                 False, True, method=JMobileNetV2.head)
    sd = deeplab_variables_to_state_dict(
        {c: {"backbone": variables[c]} for c in variables})
    for os_ in (16, 8):
        jb = JMobileNetV2(output_stride=os_)

        def taps(v, x, jb=jb):
            """(feature, low_level, tail of the feature x 1.1) per tap; the
            features of taps 2-4 as ``afan``'s head computes them, stage
            after stage (its ``tail(f, tap, end)``), traced once."""
            f, low = jb.apply(v, x, 1, False, True, method=jb.head)
            res = {}
            for tap in (1, 2, 3, 4):
                if tap > 1:
                    f = jb.apply(v, f, tap - 1, tap, False, method=jb.tail)
                res[tap] = (f, low, jb.apply(v, f * 1.1, tap, 4, False,
                                             method=jb.tail))
            return res
        tb = MobileNetV2Backbone(os_)
        tb.load_state_dict({k[len("backbone."):]: v for k, v in sd.items()},
                           strict=True)
        out[os_] = (jax.jit(taps)(variables, jnp.asarray(x)), tb.eval(), x)
    return out


@pytest.mark.parametrize("tap", [1, 2, 3, 4])
@pytest.mark.parametrize("output_stride", [16, 8])
def test_backbone_head_and_tail_match_afan(backbones, output_stride, tap):
    want, tb, x = backbones[output_stride]
    feat, low, tail = want[tap]
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    with torch.no_grad():
        tfeat, tlow = tb.head(xt, tap)
        close(nhwc(tfeat), feat, TIGHT)
        close(nhwc(tlow), low, TIGHT)
        assert tlow.shape[1:] == (24, 9, 9)          # stride 4 of 33
        got = tb.tail(tfeat * 1.1, tap)
    close(nhwc(got), tail, TIGHT)
    side = {16: 3, 8: 5}[output_stride]
    assert got.shape[1:] == (320, side, side)
    if tap == 2:                                   # the recipes' SE tap
        assert tfeat.shape[1:] == (32, 5, 5)


# ---------- the models ----------

MODELS = [("mobilenet", True, False), ("mobilenet", True, True),
          ("mobilenet", False, False), ("mobilenet", False, True),
          ("resnet18", True, True)]


@pytest.mark.parametrize("backbone,plus,separable", MODELS,
                         ids=["v3plus_mobilenet", "v3plus_mobilenet_sep",
                              "v3_mobilenet", "v3_mobilenet_sep",
                              "v3plus_resnet18_sep"])
def test_deeplab_calls_match_afan(backbone, plus, separable):
    jm, variables, tm, images = make_pair(backbone, plus, separable, seed=1)
    tm.eval()
    if separable:
        conv = (tm.classifier.aspp.convs[1][0] if plus
                else tm.classifier.classifier[0].convs[1][0])
        assert conv.body[0].groups == conv.body[0].in_channels
    whiches = ("aspp", "concat") if plus else ("aspp",)

    def calls(v, x):
        """forward_logits; per SD tap attack_features and the SD tail of
        the SD feature x 1.1."""
        res = {"logits": jm.apply(v, x, False, method=jm.forward_logits)}
        for which in whiches:
            feat, low, sd = jm.apply(v, x, 2, which, False,
                                     method=jm.attack_features)
            res[which] = (feat, low, sd, jm.apply(
                v, sd, which, sd["adv"] * 1.1, False,
                method=jm.sd_tail_logits))
        return res
    want = jax.jit(calls)(variables, jnp.asarray(images))
    xt = torch.from_numpy(images).permute(0, 3, 1, 2)
    with torch.no_grad():
        close(nhwc(tm.forward_logits(xt)), want["logits"], TIGHT)
        for which in whiches:
            feat, low, sd = tm.attack_features(xt, 2, which)
            jf, jl, jsd, jtail = want[which]
            close(nhwc(feat), jf, TIGHT)
            close(nhwc(low), jl, TIGHT)
            for k in ("adv", "low_level", "out"):
                close(nhwc(sd[k]), jsd[k], TIGHT)
            close(nhwc(tm.sd_tail_logits(sd, which, sd["adv"] * 1.1)),
                  jtail, TIGHT)


def test_bf16_mobilenet_forward_matches_afan(flax_no_dropout):
    jm, variables, _, images = make_pair("mobilenet", seed=2, n=B)
    x = jnp.asarray(images)
    out = {}
    for name, dt in (("f32", jnp.float32), ("bf16", jnp.bfloat16)):
        jmd = jmodeling.DeepLab(backbone_name="mobilenet", num_classes=NC,
                                dtype=dt)
        lo = jax.jit(lambda v, x: jmd.apply(
            v, x, True, mutable=["batch_stats"],
            method=jmd.forward_logits)[0])(variables, x)
        out[name] = np.asarray(lo.astype(jnp.float32))
    tm = DeepLab("mobilenet", NC, 16, dtype=torch.bfloat16)
    tm.load_state_dict(deeplab_variables_to_state_dict(variables))
    no_dropout(tm).train()
    with torch.no_grad():
        got = tm.forward_logits(torch.from_numpy(images).permute(0, 3, 1, 2))
    assert got.dtype == torch.bfloat16
    port_gap = rel_gap(nhwc(got.float()), out["bf16"])
    own_gap = rel_gap(out["bf16"], out["f32"])
    print(f"os4 logits: port-vs-afan (bf16) {port_gap:.3e}; afan bf16-vs-f32 "
          f"{own_gap:.3e}")
    assert port_gap <= 2 * own_gap


# ---------- one A-FAN step ----------

def test_afan_step_on_mobilenet(flax_no_dropout):
    jm, variables, _, images = make_pair("mobilenet", seed=3, n=B)
    labels = np.random.RandomState(3).randint(0, NC, (B, 33, 33))
    labels = labels.astype(np.int32)
    labels[0, :5, :5] = 255
    kw = dict(tap_se=3, sd="concat", spectrum=2, mix_mask=(0, 1),
              mix_sd=True)
    tx = jloop.segmentation_tx(j_poly(LR, TOTAL), 0.9, 1e-4)
    state = jax.jit(lambda v: TrainState.create(v, tx))(variables)
    step = jloop.make_afan_seg_step(
        jm, tx, jloop.SegAfanConfig(fused_ce=False, **kw))
    state, metrics = step(state, jnp.asarray(images), jnp.asarray(labels),
                          jax.random.PRNGKey(1))
    got = {}
    for dt in (torch.float32, torch.float64):
        tm = DeepLab("mobilenet", NC, 16)
        tm.load_state_dict(deeplab_variables_to_state_dict(variables))
        no_dropout(tm).to(dt)
        opt, sched = sgd(segmentation_param_groups(tm),
                         poly_schedule(LR, TOTAL), LR, 0.9, 1e-4)
        out = segment_loop.make_afan_seg_step(
            tm, opt, sched, segment_loop.SegAfanConfig(**kw))(
                torch.from_numpy(images).to(dt), torch.from_numpy(labels))
        got[dt] = {k: v.double().numpy() for k, v in tm.state_dict().items()}
    for k in ("loss", "loss_clean", "loss_spectrum", "loss_sd"):
        want = float(metrics[k])
        assert abs(float(out[k]) - want) <= 1e-4 * max(abs(want), 1e-6), k
    before = deeplab_variables_to_state_dict(variables)
    after = deeplab_variables_to_state_dict(jax.device_get(
        {"params": state.params, "batch_stats": state.batch_stats}))
    for k, w in after.items():
        if k.endswith("num_batches_tracked"):
            continue
        b, w = before[k].double().numpy(), w.double().numpy()
        g, g64 = got[torch.float32][k], got[torch.float64][k]
        if k.endswith(("running_mean", "running_var")):
            close_l2(g, w, 1e-4, k)
            continue
        own = np.linalg.norm(g - g64) / max(np.linalg.norm(g64 - b), 1e-12)
        close_l2(g - b, w - b, 2e-3 + 2 * own, f"update of {k}")


# ---------- --pretrained_backbone ----------

def torchvision_resnet18(path):
    """A seeded ResNet-18 in torchvision's keys, its ``fc`` included, saved
    under ``module.`` as a DataParallel checkpoint is."""
    torso = from_name("resnet18")
    torso.reset_parameters(torch.Generator().manual_seed(7))
    for i, m in enumerate(torso.modules()):
        if isinstance(m, torch.nn.BatchNorm2d):
            m.running_mean.fill_(0.01 * i)
            m.running_var.fill_(1.0 + 0.1 * i)
            m.bias.data.fill_(-0.01 * i)
    sd = dict(torso.state_dict(), **{"fc.weight": torch.ones(10, 512),
                                     "fc.bias": torch.zeros(10)})
    torch.save({f"module.{k}": v for k, v in sd.items()}, path)
    return sd


@pytest.mark.parametrize("backbone,fractions", [("resnet18", (1.0, 1.0)),
                                                ("mobilenet", (0.0, 0.0))])
def test_pretrained_backbone_matches_afan(tmp_path, backbone, fractions):
    path = str(tmp_path / "resnet18.pth")
    torchvision_resnet18(path)
    jm, variables, tm, _ = make_pair(backbone, seed=4)
    bp, bs, _ = load_torchvision_backbone(path, frozen_bn=False)
    merged_p, fp = j_checkpoint.overlap_restore(
        variables["params"]["backbone"], bp)
    merged_s, fs = j_checkpoint.overlap_restore(
        variables["batch_stats"]["backbone"], bs)
    got = restore_pretrained_backbone(tm.backbone, path)
    assert got == (fp, fs) == fractions
    want = deeplab_variables_to_state_dict(
        {"params": {"backbone": jax.device_get(merged_p)},
         "batch_stats": {"backbone": jax.device_get(merged_s)}})
    own = tm.state_dict()
    for k, v in want.items():
        assert torch.equal(own[k], v), k


def test_cli_runs_mobilenet_with_separable_and_pretrained(tmp_path,
                                                         monkeypatch):
    """``train_segment --model deeplabv3plus_mobilenet --separable_conv
    --pretrained_backbone`` logs ``afan``'s fractions and writes a
    checkpoint with the separable head; ``eval_segment`` reads it."""
    path = str(tmp_path / "resnet18.pth")
    torchvision_resnet18(path)
    monkeypatch.chdir(tmp_path)
    logged = []
    real = Log.i
    monkeypatch.setattr(Log, "i", lambda msg: (logged.append(msg),
                                               real(msg))[1])
    score = train_segment.main(
        ["--device", "cpu", "--dataset", "synthetic", "--crop_size", "32",
         "--batch_size", "2", "--limit_itrs", "1", "--val_interval", "1",
         "--model", "deeplabv3plus_mobilenet", "--separable_conv",
         "--pretrained_backbone", path, "--pertub_idx_sd", "aspp"])
    assert np.isfinite(score)
    assert (f"ImageNet backbone loaded (params 0.0%, stats 0.0%) from "
            f"{path}") in logged
    exp = os.listdir("checkpoints")[0]
    ckpt = os.path.join("checkpoints", exp,
                        "latest_deeplabv3plus_mobilenet_synthetic.pt")
    weights = load_checkpoint(ckpt)
    assert weights["classifier.aspp.convs.1.0.body.0.weight"].shape == (
        320, 1, 3, 3)
    assert weights["backbone.b1_0.depthwise.weight"].shape == (96, 1, 3, 3)
    fresh = build_model("deeplabv3plus_mobilenet", 21, separable_conv=True)
    assert set(fresh.state_dict()) == set(weights)
    miou = eval_segment.main(
        ["--device", "cpu", "--task", "miou", "--crop_size", "32",
         "--crop_val", "--limit_images", "2", "--model",
         "deeplabv3plus_mobilenet", "--ckpt", ckpt])
    assert 0.0 <= miou <= 1.0
