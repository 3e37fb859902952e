"""afan_torch's data paths that read files, against afan's on the same
trees: every batch byte for byte.

The trees are written here, small but in the datasets' layouts: Cityscapes
(``leftImg8bit``/``gtFine``, label ids 0-33, images larger than the crop),
VOC 2012 segmentation (the committed VOC-sized JPEGs, palette labels with
255 borders; ``train`` and, in a second tree, SBD's ``train_aug``), VOC
2007 detection (wide and tall images, a difficult object in each test
image, cats and dogs among the objects) with a VOC 2012 trainval, and COCO
2017 (a crowd annotation in each split). Among the VOC JPEGs are the
committed arithmetic-coded (sequential and progressive) and lossless
ones, as ``chip_smoke.voc_fixture`` places them.

- The segmentation loaders (train over two epochs, val on the eval canvas
  and with ``crop_val``) and the detection loaders (``voc2007``,
  ``voc20072012``, ``voc2007catdog``, ``coco2017``; two training epochs,
  the eval split, and each sample's eval boxes, labels, difficult flags and
  crowd regions) equal ``afan``'s. ``afan`` decodes with PIL and resizes
  with OpenCV; the port with ``utils/imread.py`` and numpy.
- ``crop_val``'s resizes equal OpenCV's on decoded real-sized images
  (500x375 and 375x500 to the 513 crop, 1024x2048 to the 768 crop). The
  port copies OpenCV's AVX2 path, so the ``crop_val`` batches are
  byte-equal to ``afan``'s where cv2 takes that path
  (``opencv_linear.OPENCV_FMA``), as on x86-64 hosts with AVX2.
- ``DetectionEvaluator``'s VOC07 mAP with the difficult objects neutral
  equals ``afan``'s on the same injected detections.
- With ``PIL`` and ``cv2`` unimportable, the port reads every tree: the
  machine with the card has neither.
- ``train_segment`` (then ``--test_only``) and ``train_detect`` (then
  ``eval_detect --task map``) run on the trees on the CPU, and each
  evaluation of a checkpoint equals the trainer's own.
"""
import os
import shlex
import sys

import cv2
import numpy as np
import pytest
import torch

from afan.data import registry as j_registry
from afan.data import seg_data as j_seg
from afan.eval import det_map as j_det_map
from afan_torch.cli import eval_detect, train_detect, train_segment
from afan_torch.data import registry, seg_data
from afan_torch.eval import det_map
from afan_torch.utils import imread
from afan_torch.utils.png import voc_color_map
from chip_smoke import DATA_FIXTURES, copy_fixture, voc_fixture, voc_xml, \
    write_png
from opencv_linear import assert_opencv_linear
from torch_threads import one_torch_thread  # noqa: F401

DET_NAMES = ("voc2007", "voc20072012", "voc2007catdog", "coco2017")


def city_pair(i, h=128, w=256):
    rng = np.random.RandomState(i)
    img = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
    ids = rng.randint(0, 34, (h // 8, w // 8)).astype(np.uint8)
    return img, np.kron(ids, np.ones((8, 8), np.uint8))


def write_trees(root):
    for split, n in (("train", 3), ("val", 2)):
        for i in range(n):
            city = ("aachen", "bonn")[i % 2]
            stem = f"{city}_{i:06d}_000019"
            img, ids = city_pair(i + 10 * (split == "val"))
            write_png(str(root / "leftImg8bit" / split / city
                          / f"{stem}_leftImg8bit.png"), img)
            write_png(str(root / "gtFine" / split / city
                          / f"{stem}_gtFine_labelIds.png"), ids)
    lab = imread.read_label(os.path.join(DATA_FIXTURES, "label_500x375.png"))
    voc12 = root / "VOCdevkit" / "VOC2012"
    for split, ids in (("train", ["a0", "a1", "a2"]), ("val", ["b0", "b1"])):
        for k, i in enumerate(ids):
            tall = k % 2 == 1
            copy_fixture(voc_fixture(k + 6 * (split == "val")),
                         str(voc12 / "JPEGImages" / f"{i}.jpg"))
            write_png(str(voc12 / "SegmentationClass" / f"{i}.png"),
                      lab.T if tall else lab, palette=voc_color_map())
        d = voc12 / "ImageSets" / "Segmentation"
        d.mkdir(parents=True, exist_ok=True)
        (d / f"{split}.txt").write_text("\n".join(ids) + "\n")
    names = ("cat", "person", "dog", "car")
    for year, splits in (("2007", (("trainval", 4), ("test", 2))),
                         ("2012", (("trainval", 2),))):
        voc = root / "VOCdevkit" / f"VOC{year}"
        k = 0
        for split, n in splits:
            ids = []
            for j in range(n):
                image_id = f"{year}_{k:04d}"
                tall = j % 2 == 1
                w, h = (375, 500) if tall else (500, 375)
                copy_fixture(voc_fixture(k),
                             str(voc / "JPEGImages" / f"{image_id}.jpg"))
                objects = [(names[(k + m) % 4], False,
                            (11 + 50 * m, 21 + 30 * m, 190 + 40 * m,
                             230 + 20 * m)) for m in range(2)]
                objects.append(("cat" if j == 0 else "bird", split == "test",
                                (w - 130, h - 120, w - 9, h - 4)))
                voc_xml(str(voc / "Annotations" / f"{image_id}.xml"),
                        image_id, w, h, objects)
                ids.append(image_id)
                k += 1
            d = voc / "ImageSets" / "Main"
            d.mkdir(parents=True, exist_ok=True)
            (d / f"{split}.txt").write_text("\n".join(ids) + "\n")
    import json
    ann_id = 1
    for split, n in (("train2017", 3), ("val2017", 2)):
        images, anns = [], []
        for i in range(n):
            image_id = 100 * (split == "val2017") + i + 1
            name = f"{image_id:012d}.jpg"
            copy_fixture("coco_640x480.jpg", str(root / "COCO" / split / name))
            images.append({"id": image_id, "file_name": name, "width": 640,
                           "height": 480})
            for m, crowd in enumerate((0, 0, int(i == 0))):
                anns.append({"id": ann_id, "image_id": image_id,
                             "category_id": (1, 3, 18)[m],
                             "bbox": [30.0 + 100 * m, 50.0 + 60 * m, 140.0,
                                      110.0], "iscrowd": crowd})
                ann_id += 1
        (root / "COCO" / "annotations").mkdir(parents=True, exist_ok=True)
        (root / "COCO" / "annotations" / f"instances_{split}.json").write_text(
            json.dumps({"images": images, "annotations": anns}))


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """(root, aug_root): every dataset under ``root``; under ``aug_root``,
    VOC segmentation with SBD's ``train_aug`` list and labels."""
    root = tmp_path_factory.mktemp("data")
    write_trees(root)
    aug = tmp_path_factory.mktemp("aug") / "VOC2012"
    src = root / "VOCdevkit" / "VOC2012"
    for sub in ("JPEGImages", "SegmentationClass"):
        (aug / sub).mkdir(parents=True)
        for f in os.listdir(src / sub):
            (aug / sub / f).write_bytes((src / sub / f).read_bytes())
    (aug / "SegmentationClassAug").mkdir()
    for f in os.listdir(src / "SegmentationClass"):
        lab = imread.read_label(str(src / "SegmentationClass" / f))
        write_png(str(aug / "SegmentationClassAug" / f), lab[::-1].copy())
    (aug / "ImageSets" / "Segmentation").mkdir(parents=True)
    for split in ("val", "train"):
        ids = (src / "ImageSets" / "Segmentation" / f"{split}.txt").read_text()
        name = "train_aug" if split == "train" else split
        (aug / "ImageSets" / "Segmentation" / f"{name}.txt").write_text(ids)
    return root, aug.parent


def batches_equal(got, want):
    got, want = list(got), list(want)
    assert len(got) == len(want) > 0
    for (gi, gl), (wi, wl) in zip(got, want):
        assert gi.dtype == wi.dtype == np.float32
        assert gl.dtype == wl.dtype == np.int32
        assert np.array_equal(gi, wi) and np.array_equal(gl, wl)
    return got


SEG_CASES = [("cityscapes", 64, False), ("cityscapes", 64, True),
             ("voc", 513, False), ("voc", 513, True), ("voc_aug", 96, False)]


@pytest.mark.parametrize("dataset,crop,crop_val", SEG_CASES)
def test_segmentation_loaders_equal_afans(trees, dataset, crop, crop_val):
    root, aug = trees
    if dataset == "cityscapes":
        mine, theirs, data = (seg_data.cityscapes_loaders,
                              j_seg.cityscapes_loaders, str(root))
    else:
        mine, theirs = seg_data.voc_seg_loaders, j_seg.voc_seg_loaders
        data = str(aug if dataset == "voc_aug" else root)
    got = mine(data, 2, crop, seed=3, val_batch_size=1, crop_val=crop_val)
    want = theirs(data, 2, crop, seed=3, val_batch_size=1, crop_val=crop_val)
    assert got[2] == want[2]
    assert got[1].eval_canvas == want[1].eval_canvas
    for _ in range(2):                      # two epochs: the RNG carries on
        train = batches_equal(got[0], want[0])
        val = batches_equal(got[1], want[1])
    assert train[0][0].shape[1:3] == (crop, crop)
    canvas = {"cityscapes": (1024, 2048)}.get(dataset, (512, 512))
    assert val[0][0].shape[1:3] == ((crop, crop) if crop_val else canvas)
    if not crop_val:                        # labels padded with 255
        assert (val[0][1][0, -1] == 255).all()
    if dataset == "cityscapes":             # ids mapped to train ids
        assert set(np.unique(train[0][1])) <= set(range(19)) | {255}
        assert 255 in train[0][1]


@pytest.mark.parametrize("size,out", [((375, 500), (513, 684)),
                                      ((500, 375), (684, 513))])
def test_crop_val_resizes_equal_opencv_on_decoded_images(size, out):
    name = f"voc_{size[1]}x{size[0]}.jpg"
    img = imread.read_rgb(os.path.join(DATA_FIXTURES, name))
    img = img.astype(np.float32) / 255.0
    want = cv2.resize(img, out[::-1], interpolation=cv2.INTER_LINEAR)
    assert_opencv_linear(seg_data.cv2_resize_linear(img, out), want)
    lab = imread.read_label(os.path.join(DATA_FIXTURES, "label_500x375.png"))
    lab = (lab if size == (375, 500) else lab.T).astype(np.int32)
    want = cv2.resize(lab, out[::-1], interpolation=cv2.INTER_NEAREST)
    assert np.array_equal(seg_data.cv2_resize_nearest(lab, out), want)


def test_crop_val_resize_equals_opencv_at_cityscapes_size(tmp_path):
    """A 1024x2048 PNG decoded, resized to 768x1536 as ``--crop_val`` with
    crop 768 resizes it."""
    rng = np.random.RandomState(0)
    path = str(tmp_path / "city.png")
    y, x = np.mgrid[0:1024, 0:2048]
    img = (128 + 100 * np.sin(x / 97.0) * np.cos(y / 71.0)
           + rng.randn(1024, 2048) * 8)
    write_png(path, np.clip(np.stack([img, img[::-1], img[:, ::-1]], -1), 0,
                            255).astype(np.uint8))
    im = imread.read_rgb(path).astype(np.float32) / 255.0
    want = cv2.resize(im, (1536, 768), interpolation=cv2.INTER_LINEAR)
    assert_opencv_linear(seg_data.cv2_resize_linear(im, (768, 1536)), want)


def det_batches_equal(got, want):
    got, want = list(got), list(want)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g.image_ids == w.image_ids
        for f in ("images", "scales", "boxes", "labels", "valid"):
            a, b = getattr(g, f), getattr(w, f)
            assert a.dtype == b.dtype and np.array_equal(a, b), f
    return got


SAMPLE_FIELDS = ("image_id", "image_path", "width", "height", "boxes",
                 "labels", "eval_boxes", "eval_labels", "eval_difficult",
                 "crowd_boxes", "crowd_labels")


def samples_equal(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        for f in SAMPLE_FIELDS:
            a, b = getattr(g, f), getattr(w, f)
            if isinstance(b, np.ndarray):
                assert a.dtype == b.dtype and np.array_equal(a, b), f
            else:
                assert a == b, f


@pytest.mark.parametrize("name", DET_NAMES)
def test_detection_loaders_equal_afans(trees, name):
    root = str(trees[0])
    got = registry.detection_loaders(name, root, 2, 96, 160, seed=3)
    want = j_registry.detection_loaders(name, root, 2, 96, 160, seed=3)
    assert got[2] == want[2]
    for i in (0, 1):
        samples_equal(got[i].samples, want[i].samples)
    shapes = set()
    for _ in range(2):
        shapes |= {b.images.shape[1:3]
                   for b in det_batches_equal(got[0], want[0])}
    det_batches_equal(got[1], want[1])
    if name.startswith("voc"):                  # a difficult cat and bird
        difficult = sum(int(s.eval_difficult.sum()) for s in got[1].samples)
        assert difficult == (1 if name == "voc2007catdog" else 2)
    if name in ("voc2007", "voc20072012"):
        assert shapes == {(96, 160), (160, 96)}     # fat and tall canvases
        assert len(got[0].samples) == (6 if name == "voc20072012" else 4)
    if name == "coco2017":
        assert sum(len(s.crowd_boxes) for s in got[1].samples) == 1


def test_voc07_map_with_difficult_objects_equals_afans(trees):
    root = str(trees[0])
    _, mine, nc = registry.detection_loaders("voc2007", root, 1, 96, 160)
    _, theirs, _ = j_registry.detection_loaders("voc2007", root, 1, 96, 160)
    rng = np.random.RandomState(5)
    outputs, p = [], 8
    for batch in mine:
        s = next(x for x in mine.samples if x.image_id == batch.image_ids[0])
        boxes = np.zeros((1, p, nc, 4), np.float32)
        probs = rng.rand(1, p, nc).astype(np.float32)
        for j, (box, label) in enumerate(zip(s.eval_boxes, s.eval_labels)):
            boxes[0, j, label] = box * batch.scales[0] + rng.randn(4)
        boxes[0, len(s.eval_boxes):] = rng.rand(p - len(s.eval_boxes), nc,
                                                4) * 90
        outputs.append((boxes, probs, rng.rand(1, p, nc) < 0.7))
    gt = det_map.ground_truth(mine.samples)
    assert sum(int(d.sum()) for _, _, d in gt.values()) == 2
    feed = iter(outputs)
    got = det_map.DetectionEvaluator(
        mine, lambda x: tuple(map(torch.from_numpy, next(feed))),
        nc).evaluate()
    feed = iter(outputs)
    want = j_det_map.DetectionEvaluator(
        theirs, lambda state, x: next(feed), nc).evaluate(None)
    assert got == want and 0.0 < got[0] < 1.0


def test_the_port_reads_every_tree_without_pil_or_cv2(trees, monkeypatch):
    for mod in ("PIL", "PIL.Image", "cv2"):
        monkeypatch.setitem(sys.modules, mod, None)
    with pytest.raises(ImportError):
        import PIL.Image  # noqa: F401
    root, aug = trees
    for make, data, crop in ((seg_data.cityscapes_loaders, root, 64),
                             (seg_data.voc_seg_loaders, root, 96),
                             (seg_data.voc_seg_loaders, aug, 96)):
        for crop_val in (False, True):
            train, val, _ = make(str(data), 2, crop, crop_val=crop_val)
            assert len(list(val)) == 2
        assert len(list(train)) == 1        # the same pipeline either way
    for name in DET_NAMES:
        train, test, _ = registry.detection_loaders(name, str(root), 2, 64,
                                                    96)
        assert list(train) and list(test)


def test_segmentation_cli_on_a_voc_tree(trees, tmp_path, monkeypatch):
    """One training step on the tree, a validation of the images resized
    and cropped to the crop (``--crop_val``; the 512x512 canvas is the
    loader tests'), then ``--test_only`` on the checkpoint: the same
    mIoU."""
    monkeypatch.chdir(tmp_path)
    flags = ["--device", "cpu", "--dataset", "voc", "--data_root",
             str(trees[0]), "--model", "deeplabv3plus_mobilenet",
             "--crop_size", "32", "--batch_size", "2", "--crop_val"]
    best = train_segment.main(flags + ["--limit_itrs", "1", "--val_interval",
                                       "1"])
    (exp,) = os.listdir("checkpoints")
    ckpt = os.path.join("checkpoints", exp,
                        "latest_deeplabv3plus_mobilenet_voc.pt")
    results = train_segment.main(flags + ["--test_only", ckpt])
    assert 0.0 <= results["Mean IoU"] <= 1.0
    assert results["Mean IoU"] == best


def test_detection_cli_on_a_voc_tree(trees, tmp_path):
    """One training step of ``train_detect`` on the tree (SMOKE_TINY's
    model) and its final VOC07 mAP over the two test images, then
    ``eval_detect --task map`` on the checkpoint: the same mAP."""
    out = str(tmp_path / "det")
    tiny = shlex.split(
        f"--data_dir {trees[0]} --backbone resnet18 --image_min_side 64 "
        "--image_max_side 96 --anchor_sizes [16,32] --rpn_pre_nms_top_n 256 "
        "--rpn_post_nms_top_n 64")
    mean_ap = train_detect.main(["--device", "cpu", "-o", out, "--batch_size",
                                 "2", "--num_steps_to_finish", "1",
                                 "--num_steps_to_snapshot", "1"] + tiny)
    again = eval_detect.main(["--device", "cpu", "--task", "map",
                              "--checkpoint",
                              os.path.join(out, "model-1.pt")] + tiny)
    assert 0.0 <= mean_ap <= 1.0 and again == mean_ap
