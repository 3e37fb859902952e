"""afan_torch's segmentation trainer against afan's: one baseline step and
one A-FAN step (SD concat and aspp, AFN mask "01", ``mix_sd``) from the same
weights and batch, the lr sequence and SGD updates against optax, the
synthetic data, the streaming metrics, and the CLI on the CPU with a
checkpoint and a resume.

The models are DeepLabv3+ on ResNet-18 (4 classes, 33x33 crops, batch 4:
ASPP's image-pooling BatchNorm normalizes one value per entry, and its
gradient over two entries is a near-cancellation that float order moves by
half a percent), with weights carried by
``deeplab_variables_to_state_dict``. ASPP's dropout
is neutralized on both sides (its masks cannot match across frameworks;
``tests/test_torch_deeplab.py`` tests it alone). On the CPU the port's
upsample + CE is its plain version and ``afan``'s the XLA resize + CE.

Tolerance: losses agree within 1e-4 relative; each updated parameter and
running-statistics tensor within 1e-4 of its norm, and each parameter's
update within 2e-3 of the update's norm (float32 convolutions summed in
another order, gradients through train-mode BatchNorm over small maps). The
tensors are compared by norm, not element by element: a pre-activation
within float noise of zero can take the other side of a ReLU in the other
framework and move single gradient entries. A tensor that starts at zero,
such as a BatchNorm bias, equals its first update and is held by the update
tolerance alone. Learning rates agree within 1e-6 (optax's float32 schedule
against Python's float64).
"""
import os
import shlex

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from afan.cli import train_segment as j_train_segment
from afan.data import seg_data as jseg_data
from afan.eval import seg_miou as jmiou
from afan.models.deeplab import modeling as jmodeling
from afan.train import segment_loop as jloop
from afan.train.loop import TrainState
from afan.train.optim import poly_schedule as j_poly
from afan_torch.cli import train_segment
from afan_torch.data import seg_data
from afan_torch.eval import seg_miou
from afan_torch.interop.from_jax import deeplab_variables_to_state_dict
from afan_torch.models.deeplab import DeepLab, build_model
from afan_torch.models.deeplab.modeling import segmentation_param_groups
from afan_torch.train import segment_loop
from afan_torch.train.checkpoint import (load_checkpoint,
                                         load_training_state,
                                         overlap_restore)
from afan_torch.train.optim import poly_schedule, sgd
from torch_threads import one_torch_thread  # noqa: F401

B, HW, NC, LR, TOTAL = 4, 33, 4, 0.1, 20
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def close(got, want, rel=1e-4, msg=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, msg
    np.testing.assert_allclose(got, want, rtol=0, err_msg=msg,
                               atol=rel * max(np.abs(want).max(), 1e-6))


@pytest.fixture
def flax_no_dropout(monkeypatch):
    monkeypatch.setattr(fnn.Dropout, "__call__",
                        lambda self, inputs, *a, **k: inputs)


@pytest.fixture(scope="module")
def setup():
    jm = jmodeling.DeepLab(backbone_name="resnet18", num_classes=NC,
                           output_stride=16)
    rng = np.random.RandomState(0)
    # entries of different brightness (see test_torch_deeplab.batch)
    scale = np.linspace(0.4, 1.0, B, dtype=np.float32)[:, None, None, None]
    images = (rng.rand(B, HW, HW, 3) * scale).astype(np.float32)
    labels = rng.randint(0, NC, (B, HW, HW)).astype(np.int32)
    labels[0, :5, :5] = 255
    key = jax.random.PRNGKey(0)
    variables = jax.device_get(jm.init({"params": key, "dropout": key},
                                       jnp.asarray(images), False))
    return jm, variables, images, labels


def port_model(variables):
    tm = DeepLab("resnet18", NC, 16)
    tm.load_state_dict(deeplab_variables_to_state_dict(variables))
    for m in tm.modules():
        if isinstance(m, torch.nn.Dropout):
            m.p = 0.0
    opt, sched = sgd(segmentation_param_groups(tm), poly_schedule(LR, TOTAL),
                     LR, 0.9, 1e-4)
    return tm, opt, sched


def close_l2(got, want, rel, msg):
    err = np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-12)
    assert err <= rel, (msg, err)


def compare_states(tm, variables, state, rel=1e-4):
    before = deeplab_variables_to_state_dict(variables)
    want = deeplab_variables_to_state_dict(jax.device_get(
        {"params": state.params, "batch_stats": state.batch_stats}))
    got = tm.state_dict()
    for k, w in want.items():
        if k.endswith("num_batches_tracked"):
            continue
        g, w, b = got[k].numpy(), w.numpy(), before[k].numpy()
        if k.endswith(("running_mean", "running_var")) or np.abs(b).max():
            close_l2(g, w, rel, k)
        if not k.endswith(("running_mean", "running_var")):
            close_l2(g - b, w - b, 2e-3, f"update of {k}")


def jax_state(variables):
    tx = jloop.segmentation_tx(j_poly(LR, TOTAL), 0.9, 1e-4)
    return TrainState.create(variables, tx), tx


def test_base_step(setup, flax_no_dropout):
    jm, variables, images, labels = setup
    state, tx = jax_state(variables)
    step = jloop.make_seg_base_step(jm, tx, fused_ce=False)
    state, metrics = step(state, jnp.asarray(images), jnp.asarray(labels),
                          jax.random.PRNGKey(1))
    tm, opt, sched = port_model(variables)
    out = segment_loop.make_seg_base_step(tm, opt, sched)(
        torch.from_numpy(images), torch.from_numpy(labels))
    close(float(out["loss"]), float(metrics["loss"]))
    compare_states(tm, variables, state)


@pytest.mark.parametrize("sd", ["concat", "aspp"])
def test_afan_step(setup, flax_no_dropout, sd):
    jm, variables, images, labels = setup
    kw = dict(tap_se=2, sd=sd, spectrum=3, mix_mask=(0, 0, 1), mix_sd=True)
    state, tx = jax_state(variables)
    step = jloop.make_afan_seg_step(
        jm, tx, jloop.SegAfanConfig(fused_ce=False, **kw))
    state, metrics = step(state, jnp.asarray(images), jnp.asarray(labels),
                          jax.random.PRNGKey(1))
    tm, opt, sched = port_model(variables)
    out = segment_loop.make_afan_seg_step(
        tm, opt, sched, segment_loop.SegAfanConfig(**kw))(
            torch.from_numpy(images), torch.from_numpy(labels))
    for k in ("loss", "loss_clean", "loss_spectrum", "loss_sd"):
        close(float(out[k]), float(metrics[k]), msg=k)
    compare_states(tm, variables, state)
    assert all(p.grad is None or torch.isfinite(p.grad).all()
               for p in tm.parameters())


@pytest.mark.parametrize("name", ["seg_cross_entropy", "seg_focal_loss"])
def test_criteria_match_afan(name):
    rng = np.random.RandomState(6)
    logits = rng.randn(2, 10, 9, NC).astype(np.float32)
    labels = rng.randint(0, NC, (2, 10, 9))
    labels[1, :4] = 255
    want = getattr(jloop, name)(jnp.asarray(logits), jnp.asarray(labels))
    got = getattr(segment_loop, name)(
        torch.from_numpy(logits).permute(0, 3, 1, 2),
        torch.from_numpy(labels))
    close(float(got), float(want), 1e-6)


def test_lr_sequence_and_updates_match_optax():
    rng = np.random.RandomState(3)
    params = {"backbone": {"w": rng.randn(3, 2).astype(np.float32)},
              "classifier": {"w": rng.randn(4).astype(np.float32)}}
    total = 6
    tx = jloop.segmentation_tx(j_poly(LR, total), 0.9, 1e-4)
    jp, opt_state = jax.tree.map(jnp.asarray, params), None
    opt_state = tx.init(jp)
    tw = {k: torch.nn.Parameter(torch.from_numpy(v["w"].copy()))
          for k, v in params.items()}
    opt, sched = sgd([{"params": [tw["backbone"]], "lr_scale": 0.1},
                      {"params": [tw["classifier"]]}],
                     poly_schedule(LR, total), LR, 0.9, 1e-4)
    schedule = j_poly(LR, total)
    for count in range(total + 2):
        lrs = [g["lr"] for g in opt.param_groups]
        want = float(schedule(count))
        np.testing.assert_allclose(lrs, [0.1 * want, want], rtol=1e-6)
        grads = {k: rng.randn(*v["w"].shape).astype(np.float32)
                 for k, v in params.items()}
        updates, opt_state = tx.update(
            {k: {"w": jnp.asarray(g)} for k, g in grads.items()}, opt_state,
            jp)
        jp = optax.apply_updates(jp, updates)
        for k, p in tw.items():
            p.grad = torch.from_numpy(grads[k])
        opt.step()
        sched.step()
        for k, p in tw.items():
            close(p.detach().numpy(), jp[k]["w"], 1e-6)
    assert opt.param_groups[1]["lr"] == pytest.approx(1e-6)


def test_synth_pair_and_loaders_are_byte_identical():
    for seed in (0, 7, 10003):
        a = jseg_data._synth_pair(seed, 19, (48, 64))
        b = seg_data._synth_pair(seed, 19, (48, 64))
        assert all(np.array_equal(x, y) and x.dtype == y.dtype
                   for x, y in zip(a, b))
    jt, jv, jn = jseg_data.cityscapes_loaders("", 2, 32, seed=1)
    tt, tv, tn = seg_data.cityscapes_loaders(None, 2, 32, seed=1)
    assert jn == tn == 19 and len(jt) == len(tt) and len(jv) == len(tv)
    for (ji, jl), (ti, tl) in zip(list(jt)[:3] + list(jv)[:2],
                                  list(tt)[:3] + list(tv)[:2]):
        assert np.array_equal(ji, ti) and np.array_equal(jl, tl)


def test_real_dataset_is_not_read(tmp_path):
    """A Cityscapes tree without its split directories is not read: it
    raises as ``afan``'s loader does (the trees are read in
    ``tests/test_torch_data_disk.py``)."""
    os.makedirs(tmp_path / "leftImg8bit")
    for loaders in (seg_data.cityscapes_loaders,
                    jseg_data.cityscapes_loaders):
        with pytest.raises(FileNotFoundError, match="train"):
            loaders(str(tmp_path), 2, 32)


@pytest.mark.parametrize("case", ["random", "absent_class", "all_ignored"])
def test_metrics_match_afan(case):
    rng = np.random.RandomState(4)
    n = 5
    lt = rng.randint(0, n, (3, 16, 16))
    lp = rng.randint(0, n, (3, 16, 16))
    if case == "absent_class":
        lt[lt == 2] = 0
        lp[lp == 2] = 1
    if case == "all_ignored":
        lt[:] = 255
    jm, tm = jmiou.StreamSegMetrics(n), seg_miou.StreamSegMetrics(n)
    jm.update(lt, lp)
    tm.update_hist(seg_miou.confusion_matrix(torch.from_numpy(lt),
                                             torch.from_numpy(lp), n))
    assert np.array_equal(tm.confusion_matrix, jm.confusion_matrix)
    assert np.array_equal(
        tm.confusion_matrix,
        np.asarray(jmiou.confusion_matrix_jnp(jnp.asarray(lt),
                                              jnp.asarray(lp), n)))
    want, got = jm.get_results(), tm.get_results()
    for k in ("Overall Acc", "Mean Acc", "FreqW Acc", "Mean IoU"):
        np.testing.assert_equal(got[k], want[k], err_msg=k)
    np.testing.assert_equal(list(got["Class IoU"].values()),
                            list(want["Class IoU"].values()))
    if case == "all_ignored":
        assert np.isnan(got["Overall Acc"]) and got["FreqW Acc"] == 0.0


def test_cli_on_cpu_with_checkpoint_and_resume(tmp_path, monkeypatch):
    """Two iterations, a validation and a checkpoint, then a resume to four
    with the optimizer and schedule restored; on the cheapest model, as
    afan's own CLI tests and ``recipes/_common.sh``'s SMOKE_TINY run it."""
    monkeypatch.chdir(tmp_path)
    argv = ["--device", "cpu", "--dataset", "synthetic", "--crop_size", "32",
            "--batch_size", "2", "--lr", "0.1", "--total_itrs", "10",
            "--val_interval", "2", "--print_interval", "1", "--mix_sd",
            "--model", "deeplabv3plus_mobilenet"]
    score = train_segment.main(argv + ["--limit_itrs", "2"])
    assert np.isfinite(score)
    exp = os.listdir("checkpoints")[0]
    latest = os.path.join("checkpoints", exp,
                          "latest_deeplabv3plus_mobilenet_synthetic.pt")
    saved = load_training_state(latest)
    assert saved["cur_itrs"] == 2 and saved["scheduler_state"][
        "last_epoch"] == 2
    # --dataset synthetic is afan's synthetic VOC: 21 classes
    fresh = build_model("deeplabv3plus_mobilenet", 21)
    assert overlap_restore(fresh, load_checkpoint(latest)) == 1.0
    assert all(torch.equal(v, saved["model_state"][k])
               for k, v in fresh.state_dict().items())
    train_segment.main(argv + ["--limit_itrs", "4", "--ckpt", latest,
                               "--continue_training"])
    resumed = load_training_state(latest)
    assert resumed["cur_itrs"] == 4
    assert resumed["scheduler_state"]["last_epoch"] == 4
    assert len(resumed["optimizer_state"]["state"]) == len(
        saved["optimizer_state"]["state"]) > 0


def test_cli_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_segment.main(["--dataset", "synthetic", "--limit_itrs", "1"])


def recipe_flags(**env):
    """The flags ``recipes/seg_city_final.sh`` passes to afan's
    segmentation CLI, with its shell variables set to ``env`` and its data
    flags at their full-size value."""
    with open(os.path.join(ROOT, "recipes", "seg_city_final.sh")) as f:
        text = f.read().replace("\\\n", " ")
    line = next(ln for ln in text.splitlines()
                if "-m afan.cli.train_segment" in ln)
    for k, v in env.items():
        line = line.replace("${%s}" % k, v)
    line = line.replace("$(seg_smoke_flags)", "--data_root ./data")
    assert "$" not in line, line
    argv = shlex.split(line)
    return argv[argv.index("afan.cli.train_segment") + 1:]


class _RunDir(Exception):
    pass


def run_dir(main, argv, monkeypatch):
    """The directory ``main(argv)`` would create for its run: the first
    ``os.makedirs`` is stopped before anything is written."""
    def stop(path, *a, **kw):
        raise _RunDir(path)
    with monkeypatch.context() as m:
        m.setattr(os, "makedirs", stop)
        with pytest.raises(_RunDir) as hit:
            main(argv)
    return hit.value.args[0]


@pytest.mark.parametrize("env", [dict(N="1", GAMMASE="0.02", MIX="01"),
                                 dict(N="2", GAMMASE="0.04", MIX="10")],
                         ids=["final01", "final02"])
def test_cli_takes_the_recipe_flags_and_names_the_run_as_afan(env,
                                                              monkeypatch):
    """The port's CLI parses every flag of the canonical Cityscapes recipe,
    ``--adv_loss_weight_sd 0.3`` and ``--bf16`` included, and names the
    run's directory as afan's CLI does."""
    flags = recipe_flags(**env)
    assert "--adv_loss_weight_sd" in flags and "--bf16" in flags
    port_flags = list(flags)
    args = train_segment.get_parser().parse_args(port_flags)
    assert args.adv_loss_weight_sd == 0.3 and args.mix_layer == env["MIX"]
    assert args.bf16 and args.dataset == "cityscapes"
    assert train_segment.afan_config(args).mix_mask == (
        0, int(env["MIX"][0]), int(env["MIX"][1]))
    want = run_dir(j_train_segment.main, flags, monkeypatch)
    got = run_dir(train_segment.main, port_flags + ["--device", "cpu"],
                  monkeypatch)
    assert got == want
    assert os.path.basename(got) == train_segment.experiment_name(args)
