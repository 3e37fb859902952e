"""afan_torch's segmentation evaluation against afan's: the streaming
metrics' ``update`` and ``reset``, the PGD attack of ``eval_segment --task
pgd`` (``make_seg_pgd_fn``) against ``afan``'s composition of the same
calls (`cli/eval_segment.py:130-155`) from the weights and batch of
``tests/test_torch_segment.py`` (DeepLabv3+ ResNet-18, 4 classes, four
33x33 images), with ``--fused_ce off`` on both sides and with ``on``
against ``afan``'s Pallas kernel in interpret mode; the parsers; and CPU
runs of ``eval_segment`` and of ``train_segment --test_only`` and
``--enable_vis``.

Randomness is ``afan``'s: the random start of ``--randinit_pgd`` is
``afan``'s draw, patched in for the port's (``attack.uniform_init``).

Tolerances (float32 on the CPU): the metrics exactly (NaN where ``afan``
has NaN); attacked images within ``1e-5 * max(max|x|, 1)`` but at most
1e-4 of the entries, where a near-zero gradient entry's sign turns over
(a whole step apart). One sign step: with two, ``afan``'s and the port's
float order part ways at more entries (``tests/test_torch_segment_variants.py``
measures the mechanism).
"""
import argparse
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from afan.cli import train_segment as j_train_segment
from afan.cli import eval_segment as j_eval_segment
from afan.core import attack as j_attack
from afan.eval import seg_miou as jmiou
from afan.train import segment_loop as jloop
from afan_torch.cli import eval_segment, train_segment
from afan_torch.core import attack
from afan_torch.data import seg_data
from afan_torch.eval import seg_miou
from afan_torch.models.deeplab import build_model
from afan_torch.train import segment_loop
from afan_torch.utils.png import voc_color_map

from test_torch_segment import setup  # noqa: F401 (the fixture)
from test_torch_segment import port_model
from torch_threads import one_torch_thread  # noqa: F401

SHARE = 1e-4


def close_signed(got, want, msg=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, msg
    off = np.abs(got - want) > 1e-5 * max(np.abs(want).max(), 1.0)
    assert off.mean() <= SHARE, (msg, int(off.sum()), got.size)


# ---------- metrics ----------

@pytest.mark.parametrize("case", ["random", "absent_class", "all_ignored"])
def test_metrics_update_and_reset_match_afan(case):
    rng = np.random.RandomState(5)
    n = 6
    lt = rng.randint(0, n, (2, 9, 11))
    lp = rng.randint(0, n, (2, 9, 11))
    lt[0, :2] = 255
    if case == "absent_class":
        lt[lt == 3] = 0
        lp[lp == 3] = 1
    if case == "all_ignored":
        lt[:] = 255
    jm, tm = jmiou.StreamSegMetrics(n), seg_miou.StreamSegMetrics(n)
    for _ in range(2):
        jm.update(lt, lp)
        tm.update(lt, lp)
    np.testing.assert_array_equal(tm.confusion_matrix, jm.confusion_matrix)
    want, got = jm.get_results(), tm.get_results()
    for k in ("Overall Acc", "Mean Acc", "FreqW Acc", "Mean IoU"):
        np.testing.assert_equal(got[k], want[k], err_msg=k)
    np.testing.assert_equal(list(got["Class IoU"].values()),
                            list(want["Class IoU"].values()))
    jm.reset()
    tm.reset()
    np.testing.assert_array_equal(tm.confusion_matrix, jm.confusion_matrix)
    assert tm.confusion_matrix.dtype == np.int64
    assert not tm.confusion_matrix.any()


# ---------- the attack ----------

def afan_attack(jm, variables, images, labels, fused_ce, steps, randinit,
                clip, key):
    """``afan``'s eval attack, its calls as in `cli/eval_segment.py:
    130-155` (``build_attack``, which lives inside ``main``)."""
    use_fused, interp, _ = jloop._resolve_fused(fused_ce, False)

    @jax.jit
    def attack_fn(x, y, rng):
        site_loss = jloop._make_site_loss(use_fused, interp, None,
                                          jloop.seg_cross_entropy, y,
                                          (x.shape[1], x.shape[2]))

        def loss_fn(z):
            return site_loss(jm.apply(variables, z, False,
                                      method=jm.forward_logits))
        return jnp.clip(j_attack.pgd(loss_fn, x, steps=steps,
                                     gamma=2.0 / 255, eps=8.0 / 255,
                                     randinit=randinit, clip=clip, rng=rng),
                        0.0, 1.0)

    return np.asarray(attack_fn(jnp.asarray(images), jnp.asarray(labels),
                                key))


def pgd_args(*flags):
    return eval_segment.get_parser().parse_args(
        ["--task", "pgd", "--pgd_steps", "1"] + list(flags))


@pytest.mark.parametrize("flags", [
    ("--fused_ce", "off"),
    ("--fused_ce", "off", "--randinit_pgd", "--clip_pgd"),
    ("--fused_ce", "on", "--randinit_pgd", "--clip_pgd")],
    ids=["off", "off_randinit_clip", "on_randinit_clip"])
def test_seg_attack_matches_afan(setup, monkeypatch, flags):
    """``off``: the resize + CE on both sides; ``on``: the port's upsample
    + CE (its plain version on the CPU) against ``afan``'s Pallas kernel in
    interpret mode."""
    jm, variables, images, labels = setup
    args = pgd_args(*flags)
    key = jax.random.PRNGKey(3)
    want = afan_attack(jm, variables, images, labels,
                       {"on": True, "off": False}[args.fused_ce], 1,
                       args.randinit_pgd, args.clip_pgd, key)
    noise = np.asarray(j_attack.uniform_init(key, images.shape, 8.0 / 255))
    monkeypatch.setattr(attack, "uniform_init",
                        lambda *a, **k: torch.from_numpy(noise.copy()))
    tm = port_model(variables)[0]
    got = eval_segment.make_seg_pgd_fn(tm, args)(
        torch.from_numpy(images), torch.from_numpy(labels),
        torch.Generator())
    close_signed(got.numpy(), want, "attacked images")
    assert 0.0 <= float(got.min()) and float(got.max()) <= 1.0
    if args.clip_pgd:
        assert float((got - torch.from_numpy(images)).abs().max()) <= (
            8.0 / 255 + 1e-6)


@pytest.mark.parametrize("mode,fused", [("auto", True), ("on", True),
                                         ("off", False)])
def test_fused_ce_picks_the_loss_path(setup, monkeypatch, mode, fused):
    """``auto`` and ``on`` end each forward in the upsample + CE op (the
    kernels on the card), ``off`` in ``resize_bilinear`` + CE; each step
    launches one PGD update."""
    jm, variables, images, labels = setup
    calls = {"fused": 0, "update": 0}
    real_fused = segment_loop.fused_resize_nll_sums
    real_update = attack.pgd_update

    def fused_op(*a, **k):
        calls["fused"] += 1
        return real_fused(*a, **k)

    def update(*a, **k):
        calls["update"] += 1
        return real_update(*a, **k)

    monkeypatch.setattr(segment_loop, "fused_resize_nll_sums", fused_op)
    monkeypatch.setattr(attack, "pgd_update", update)
    tm = port_model(variables)[0]
    eval_segment.make_seg_pgd_fn(
        tm, pgd_args("--fused_ce", mode, "--pgd_steps", "2"))(
            torch.from_numpy(images[:1]), torch.from_numpy(labels[:1]),
            torch.Generator())
    assert calls == {"fused": 2 * fused, "update": 2}


# ---------- the CLIs ----------

def afans_eval_parser():
    """``afan``'s ``eval_segment`` builds its parser inside ``main``: take
    it from there."""
    class Got(Exception):
        pass

    real = argparse.ArgumentParser.parse_args

    def grab(self, *a, **k):
        raise Got(self)

    argparse.ArgumentParser.parse_args = grab
    try:
        j_eval_segment.main([])
    except Got as e:
        return e.args[0]
    finally:
        argparse.ArgumentParser.parse_args = real


def test_parsers_are_afans_with_device():
    ours = vars(eval_segment.get_parser().parse_args([]))
    theirs = vars(afans_eval_parser().parse_args([]))
    assert ours.pop("device") == "cuda"
    assert ours == theirs
    aliases = ["--steps_pgd", "5", "--gamma_pgd", "1", "--eps_pgd", "4"]
    ours = vars(eval_segment.get_parser().parse_args(aliases))
    ours.pop("device")
    assert ours == vars(afans_eval_parser().parse_args(aliases))
    flags = ("test_only", "enable_vis", "vis_num_samples")
    ours = vars(train_segment.get_parser().parse_args([]))
    theirs = vars(j_train_segment.get_parser().parse_args([]))
    assert {k: ours[k] for k in flags} == {k: theirs[k] for k in flags}


def test_cli_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        eval_segment.main(["--limit_images", "1"])


CPU_EVAL = ["--device", "cpu", "--crop_size", "32", "--crop_val",
            "--limit_images", "2"]


def test_cli_on_cpu(tmp_path):
    """``--task miou`` with a port checkpoint and the prediction PNGs
    (decoded, they are ``afan``'s palette of the predictions, as ``afan``
    writes them with PIL); ``--task pgd`` with the kernel path and the
    plain one, VOC and Cityscapes; a reference-keyed ``.pth`` through
    ``--torch_ckpt``."""
    model = build_model("deeplabv3plus_resnet50", 21)
    model.reset_parameters(torch.Generator().manual_seed(4))
    ckpt = str(tmp_path / "seg.pt")
    torch.save({"model_state": model.state_dict()}, ckpt)
    res = str(tmp_path / "results")
    miou = eval_segment.main(CPU_EVAL + ["--ckpt", ckpt, "--save_val_results",
                                         "--results_dir", res])
    assert isinstance(miou, float) and 0.0 <= miou <= 1.0
    assert sorted(os.listdir(res)) == ["000000_pred.png", "000001_pred.png"]
    model.eval()
    _, val, _ = seg_data.voc_seg_loaders(None, 1, 32, crop_val=True)
    for i, (imgs, _) in zip(range(2), val):
        with torch.no_grad():
            pred = model(torch.from_numpy(imgs).permute(0, 3, 1, 2)).argmax(
                1)[0].numpy()
        palette = j_eval_segment.voc_color_map()[:21]
        Image.fromarray(palette[np.clip(pred, 0, 20)]).save(
            tmp_path / "theirs.png")
        with Image.open(os.path.join(res, f"{i:06d}_pred.png")) as a, \
                Image.open(tmp_path / "theirs.png") as b:
            assert a.mode == b.mode == "RGB"
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    np.testing.assert_array_equal(voc_color_map()[:21], palette)
    for flags in (["--fused_ce", "on"], ["--fused_ce", "off",
                                         "--randinit_pgd", "--clip_pgd"]):
        v = eval_segment.main(CPU_EVAL + ["--ckpt", ckpt, "--task", "pgd",
                                          "--pgd_steps", "1"] + flags)
        assert 0.0 <= v <= 1.0
    ref = str(tmp_path / "reference.pth")
    torch.save(build_model("deeplabv3plus_resnet50", 19).state_dict(), ref)
    v = eval_segment.main(CPU_EVAL + ["--dataset", "cityscapes",
                                      "--torch_ckpt", ref, "--task", "pgd",
                                      "--pgd_steps", "1"])
    assert 0.0 <= v <= 1.0


def test_train_segment_test_only_and_vis_panels(tmp_path, monkeypatch):
    """``--enable_vis`` writes ``afan``'s panels (named as ``afan`` names
    them) at the validation; ``--test_only`` on the checkpoint validates
    the same model again, trains nothing, and returns the same results."""
    monkeypatch.chdir(tmp_path)
    argv = ["--device", "cpu", "--dataset", "synthetic", "--crop_size", "32",
            "--batch_size", "2", "--val_interval", "2", "--variant",
            "baseline"]
    score = train_segment.main(argv + ["--limit_itrs", "2", "--enable_vis",
                                       "--vis_num_samples", "3"])
    exp = os.listdir("checkpoints")[0]
    vis = os.path.join("runs", exp, "vis")
    assert sorted(os.listdir(vis)) == [f"itrs000002_0{k}.png"
                                       for k in (1, 2, 3)]
    _, val, _ = seg_data.voc_seg_loaders(None, 2, 32, seed=1)
    imgs, labs = next(iter(val))
    with Image.open(os.path.join(vis, "itrs000002_03.png")) as im:
        panel = np.asarray(im)
    assert panel.shape == (32, 96, 3)
    np.testing.assert_array_equal(
        panel[:, :32], (np.clip(imgs[0], 0, 1) * 255).astype(np.uint8))
    palette = voc_color_map()[:21]
    np.testing.assert_array_equal(panel[:, 32:64],
                                  np.where((labs[0] < 21)[..., None],
                                           palette[np.minimum(labs[0], 20)],
                                           0))
    latest = os.path.join("checkpoints", exp,
                          "latest_deeplabv3plus_resnet50_synthetic.pt")
    before = os.path.getmtime(latest)
    results = train_segment.main(argv + ["--test_only", latest])
    assert results["Mean IoU"] == score
    assert set(results) == {"Overall Acc", "Mean Acc", "FreqW Acc",
                            "Mean IoU", "Class IoU"}
    assert os.path.getmtime(latest) == before
