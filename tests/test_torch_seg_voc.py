"""afan_torch's segmentation on VOC against afan's: the data pipeline, the
CLI's defaults and choices, and the three segmentation recipes as written.

- The VOC loaders (``voc_seg_loaders``: 21 classes, random scale 0.5-2,
  crop with label pad 255, flip) give ``afan``'s batches byte for byte, for
  two seeds, at the recipes' crop 513 and at a small crop, with and
  without ``crop_val``.
- The scale's resizes, which ``afan`` runs through PIL, against PIL with
  atol 0: Pillow's fixed-point bilinear of the uint8 image by output size
  (``voc_det.resize_uint8``) and Pillow's nearest of the label.
- ``crop_val``'s resizes, which ``afan`` runs through OpenCV, against
  ``cv2``: the nearest label resize and the linear image resize exactly
  (the latter's two passes are ``fma(s1 - s0, frac, s0)`` in float32, as
  OpenCV's AVX2 code computes them).
- The parsers of both CLIs agree on the default and the choices of every
  flag they share, the recipes' flags among them; ``--dataset synthetic``
  and no other data flag builds a 21-class model on 513 crops in both (the
  port built 19 classes on 768 crops before).
- Each ``recipes/seg_*.sh`` command line, with ``afan`` replaced by
  ``afan_torch`` and its data flag, parses in the port's CLI, reads the
  recipe's dataset, and ``--bf16`` builds a model that computes in
  bfloat16.
"""
import os
import shlex

import cv2
import numpy as np
import pytest
import torch
from PIL import Image

from afan.cli import train_segment as j_train_segment
from afan.data import ext_transforms as j_ext
from afan.data import seg_data as j_seg
from afan_torch.cli import train_segment
from afan_torch.data import ext_transforms, seg_data
from afan_torch.data.voc_det import resize_uint8
from afan_torch.models.resnet import Conv2d
from opencv_linear import assert_opencv_linear
from torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RECIPES = {"seg_voc07_final1.sh": (dict(MIX="01"), "voc", 21),
           "seg_voc12_final50.sh": (dict(SE="3", GAMMASE="0.01", MIX="11",
                                         N="1"), "voc", 21),
           "seg_city_final.sh": (dict(GAMMASE="0.02", MIX="01", N="1"),
                                 "cityscapes", 19)}


def same_batches(a, b, n):
    for (ai, al), (bi, bl) in zip(list(a)[:n], list(b)[:n]):
        assert ai.dtype == bi.dtype and al.dtype == bl.dtype
        assert np.array_equal(ai, bi) and np.array_equal(al, bl)


@pytest.mark.parametrize("seed,crop,crop_val", [
    (0, 513, False), (7, 513, True), (0, 40, True), (7, 40, False)])
def test_voc_loaders_are_afans_byte_for_byte(seed, crop, crop_val):
    want = j_seg.voc_seg_loaders("/nonexistent", 2, crop, seed=seed,
                                 val_batch_size=3, crop_val=crop_val)
    got = seg_data.voc_seg_loaders("/nonexistent", 2, crop, seed=seed,
                                   val_batch_size=3, crop_val=crop_val)
    assert got[2] == want[2] == seg_data.VOC_SEG_CLASSES == 21
    assert [len(x) for x in got[:2]] == [len(x) for x in want[:2]]
    n = 1 if crop == 513 else 3
    same_batches(want[0], got[0], n)
    same_batches(want[1], got[1], n)


def test_voc_transform_draws_as_afan():
    """Scale, crop y and x, flip: the same draws from the same RandomState,
    so the states agree after each sample."""
    img, lab = seg_data._synth_pair(3, 21, (60, 45))
    ja, ta = np.random.RandomState(4), np.random.RandomState(4)
    for _ in range(3):
        want = j_ext.voc_train_transform(32)(img, lab, ja)
        got = ext_transforms.voc_train_transform(32)(img, lab, ta)
        assert all(np.array_equal(w, g) for w, g in zip(want, got))
        assert ja.rand() == ta.rand()


@pytest.mark.parametrize("size,out", [((60, 45), (30, 22)),
                                      ((60, 45), (119, 90)),
                                      ((17, 31), (17, 62)),
                                      ((513, 500), (256, 1000))])
def test_scale_resizes_are_pils(size, out):
    rng = np.random.RandomState(sum(size) + sum(out))
    img = (rng.rand(*size, 3) * 255).astype(np.uint8)
    want = np.asarray(Image.fromarray(img).resize(out[::-1], Image.BILINEAR))
    assert np.array_equal(resize_uint8(img, out), want)
    lab = rng.randint(0, 256, size).astype(np.int32)
    want = np.asarray(Image.fromarray(lab, mode="I").resize(
        out[::-1], Image.NEAREST), np.int32)
    got = ext_transforms.resize_nearest(lab, out)
    assert got.dtype == np.int32 and np.array_equal(got, want)


@pytest.mark.parametrize("size,out", [((375, 500), (513, 684)),
                                      ((40, 33), (48, 58)),
                                      ((60, 45), (29, 21))])
def test_crop_val_resizes_are_opencvs(size, out):
    rng = np.random.RandomState(size[0])
    img = rng.rand(*size, 3).astype(np.float32)
    want = cv2.resize(img, out[::-1], interpolation=cv2.INTER_LINEAR)
    assert_opencv_linear(seg_data.cv2_resize_linear(img, out), want)
    lab = rng.randint(0, 21, size).astype(np.int32)
    want = cv2.resize(lab, out[::-1], interpolation=cv2.INTER_NEAREST)
    assert np.array_equal(seg_data.cv2_resize_nearest(lab, out), want)


def test_a_voc_tree_on_disk_is_not_read(tmp_path):
    """A VOC tree without its split lists is not read: it raises as
    ``afan``'s loader does (the trees are read in
    ``tests/test_torch_data_disk.py``)."""
    os.makedirs(tmp_path / "VOC2012" / "SegmentationClass")
    for loaders in (seg_data.voc_seg_loaders, j_seg.voc_seg_loaders):
        with pytest.raises(FileNotFoundError, match="train.txt"):
            loaders(str(tmp_path), 2, 32)


def shared_actions():
    mine = {a.dest: a for a in train_segment.get_parser()._actions}
    theirs = {a.dest: a for a in j_train_segment.get_parser()._actions}
    return [(mine[d], theirs[d]) for d in mine if d in theirs]


def test_the_parsers_agree_action_by_action():
    shared = shared_actions()
    for mine, theirs in shared:
        assert mine.option_strings == theirs.option_strings, mine.dest
        assert mine.default == theirs.default, mine.dest
        assert (sorted(mine.choices) if mine.choices else None) == (
            sorted(theirs.choices) if theirs.choices else None), mine.dest
    dests = {m.dest for m, _ in shared}
    for name, (env, _, _) in RECIPES.items():
        for flag in recipe_argv(name, env, "afan"):
            if flag.startswith("--"):
                assert flag[2:] in dests, (name, flag)


class _Built(Exception):
    pass


def built_by(main, module, argv, monkeypatch, real=None):
    """What ``main(argv)`` reads and builds: the loader function and its
    crop, and ``build_model``'s arguments (and, given ``real``, the model
    it builds); the run stops there."""
    seen = {}

    def loaders(name):
        fn = getattr(module, name)

        def wrapped(data_root, batch_size, crop_size, *a, **kw):
            seen["loader"], seen["crop"] = name, crop_size
            return fn(data_root, batch_size, crop_size, *a, **kw)
        return wrapped

    def build(name, num_classes, output_stride, dtype, **kw):
        seen.update(num_classes=num_classes, dtype=dtype)
        if real is not None:
            seen["model"] = real(name, num_classes, output_stride, dtype)
        raise _Built()
    with monkeypatch.context() as m:
        for name in ("voc_seg_loaders", "cityscapes_loaders"):
            m.setattr(module, name, loaders(name))
        m.setattr(module, "build_model", build)
        with pytest.raises(_Built):
            main(argv)
    return seen


def test_dataset_synthetic_builds_afans_model(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    want = built_by(j_train_segment.main, j_train_segment,
                    ["--dataset", "synthetic"], monkeypatch)
    got = built_by(train_segment.main, train_segment,
                   ["--dataset", "synthetic", "--device", "cpu"],
                   monkeypatch)
    assert np.dtype(want["dtype"]) == np.float32
    assert (got["loader"], got["crop"], got["num_classes"]) == (
        want["loader"], want["crop"], want["num_classes"]) == (
        "voc_seg_loaders", 513, 21)
    assert got["dtype"] == torch.float32


def recipe_argv(name, env, package="afan_torch"):
    """``recipes/<name>``'s command line with its shell variables set to
    ``env``, ``$(seg_smoke_flags)`` set to its data flag, and ``afan``
    replaced by ``package``: the flags after the module."""
    with open(os.path.join(ROOT, "recipes", name)) as f:
        text = f.read().replace("\\\n", " ")
    line = next(ln for ln in text.splitlines()
                if "-m afan.cli.train_segment" in ln)
    for k, v in env.items():
        line = line.replace("${%s}" % k, v)
    line = line.replace("$(seg_smoke_flags)", "--data_root ${DATA}")
    line = line.replace("${DATA}", "/nonexistent")
    assert "$" not in line, line
    argv = shlex.split(line.replace("-m afan.", f"-m {package}."))
    return argv[argv.index(f"{package}.cli.train_segment") + 1:]


@pytest.mark.parametrize("name", sorted(RECIPES))
def test_the_recipes_run_as_written_in_bf16(name, tmp_path, monkeypatch):
    env, dataset, classes = RECIPES[name]
    argv = recipe_argv(name, env)
    args = train_segment.get_parser().parse_args(argv)
    assert args.bf16 and args.dataset == dataset
    monkeypatch.chdir(tmp_path)
    seen = built_by(train_segment.main, train_segment,
                    argv + ["--device", "cpu"], monkeypatch,
                    real=train_segment.build_model)
    loader = {"voc": "voc_seg_loaders", "cityscapes": "cityscapes_loaders"}
    assert seen["loader"] == loader[dataset] and seen["crop"] == (
        768 if dataset == "cityscapes" else 513)
    assert seen["num_classes"] == classes and seen["dtype"] == torch.bfloat16
    model = seen["model"].eval()
    convs = [m for m in model.modules() if isinstance(m, Conv2d)]
    assert len(convs) > 50 and all(m.compute_dtype == torch.bfloat16
                                   for m in convs)
    assert all(p.dtype == torch.float32 for p in model.parameters())
    if dataset == "cityscapes":
        with torch.no_grad():
            out = model.forward_logits(torch.rand(1, 3, 33, 33))
        assert out.dtype == torch.bfloat16 and out.shape == (1, classes, 9, 9)
