"""Segmentation data for the port: the VOC and Cityscapes pipelines of
``afan/data/seg_data.py``, from disk or from ``afan``'s deterministic
synthetic fallback.

On disk (:func:`voc_seg_loaders`: ``JPEGImages/`` and ``SegmentationClass/``
or, with ``ImageSets/Segmentation/train_aug.txt``, ``SegmentationClassAug/``;
:func:`cityscapes_loaders`: ``leftImg8bit/`` and ``gtFine/*_labelIds.png``,
the ids mapped to the 19 train ids through :data:`CITY_ID_TO_TRAIN_LUT`),
images and labels are decoded by :mod:`afan_torch.utils.imread`, which
gives PIL's bytes (the machine with the card has no PIL). Without them the
samples are class-coloured rectangles on noise (:func:`_synth_pair`, the
same bytes as ``afan``'s for a seed).

Training items go through ``dataset``'s train transform (VOC: random scale
0.5-2 through Pillow's resizes, crop with label pad 255, flip; Cityscapes:
crop, colour jitter, flip). Evaluation items are padded to the dataset's
static canvas (VOC 512x512, Cityscapes 1024x2048; image pad 0, label pad
255) or, with ``crop_val``, resized so that the short side is the crop and
centre-cropped, with OpenCV's linear and nearest resizes written in numpy
(the machine with the card has no ``cv2``).
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Iterator, Optional, Sequence, Tuple

import numpy as np

from ..parallel.mesh import split_rows
from ..utils.imread import read_label, read_png_size, read_rgb
from .ext_transforms import cityscapes_train_transform, voc_train_transform

IGNORE = 255

# Cityscapes id -> train id (19 classes), everything else 255
# (`datasets/cityscapes.py:23-56`)
_CITY_ID_TO_TRAIN = {
    7: 0, 8: 1, 11: 2, 12: 3, 13: 4, 17: 5, 19: 6, 20: 7, 21: 8, 22: 9,
    23: 10, 24: 11, 25: 12, 26: 13, 27: 14, 28: 15, 31: 16, 32: 17, 33: 18,
}
CITY_ID_TO_TRAIN_LUT = np.full(256, IGNORE, np.uint8)
for _k, _v in _CITY_ID_TO_TRAIN.items():
    CITY_ID_TO_TRAIN_LUT[_k] = _v
# Cityscapes' 19 train-id colours (`datasets/cityscapes.py` decode_target)
CITY_TRAIN_COLORS = np.asarray([
    (128, 64, 128), (244, 35, 232), (70, 70, 70), (102, 102, 156),
    (190, 153, 153), (153, 153, 153), (250, 170, 30), (220, 220, 0),
    (107, 142, 35), (152, 251, 152), (70, 130, 180), (220, 20, 60),
    (255, 0, 0), (0, 0, 142), (0, 0, 70), (0, 60, 100), (0, 80, 100),
    (0, 0, 230), (119, 11, 32)], np.uint8)
VOC_SEG_CLASSES = 21
CITYSCAPES_CLASSES = 19
VOC_EVAL_CANVAS = (512, 512)
CITYSCAPES_EVAL_CANVAS = (1024, 2048)


@dataclass
class SegSample:
    """An image and its label map on disk, or a synthetic sample's seed."""
    image_path: Optional[str]
    label_path: Optional[str]
    synthetic_seed: Optional[int] = None
    city_encode: bool = False


def _synth_pair(seed: int, num_classes: int, size
                ) -> Tuple[np.ndarray, np.ndarray]:
    """Class-coloured rectangles on noise; labels follow the rectangles."""
    h, w = size
    rng = np.random.RandomState(seed)
    img = rng.rand(h, w, 3).astype(np.float32) * 0.3
    lab = np.zeros((h, w), np.int32)
    for _ in range(rng.randint(2, 5)):
        c = rng.randint(1, num_classes)
        bw, bh = rng.randint(h // 4, h // 2), rng.randint(w // 4, w // 2)
        y, x = rng.randint(0, h - bh), rng.randint(0, w - bw)
        color = np.asarray([((c * 37) % 255) / 255.0, ((c * 91) % 255) / 255.0,
                            ((c * 151) % 255) / 255.0], np.float32)
        img[y:y + bh, x:x + bw] = 0.8 * color
        lab[y:y + bh, x:x + bw] = c
    return img, lab


def _load_pair(s: SegSample, num_classes: int, size
               ) -> Tuple[np.ndarray, np.ndarray]:
    """(image (H, W, 3) float32 in [0, 1], label (H, W) int32) of a sample,
    as ``afan``'s ``_load_pair`` makes it."""
    if s.image_path is None:
        return _synth_pair(s.synthetic_seed, num_classes, size)
    img = read_rgb(s.image_path).astype(np.float32) / 255.0
    lab = read_label(s.label_path)
    if s.city_encode:
        lab = CITY_ID_TO_TRAIN_LUT[lab]
    return img, lab.astype(np.int32)


def _cv2_taps(n_in: int, n_out: int):
    """OpenCV's ``INTER_LINEAR`` taps along one axis when both axes are
    resized: source ``(i + 0.5) * (n_in / n_out) - 0.5`` in float64, its
    floor and the next index, clamped at the edges, and its fraction
    rounded to float32 (0 where clamped)."""
    src = (np.arange(n_out) + 0.5) * (n_in / n_out) - 0.5
    i0 = np.floor(src).astype(np.int64)
    frac = (src - i0).astype(np.float32)
    frac[(i0 < 0) | (i0 >= n_in - 1)] = 0.0
    i0 = np.clip(i0, 0, n_in - 1)
    return i0, np.minimum(i0 + 1, n_in - 1), frac


def _fma32(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    """``fmaf(a, b, c)`` of float32 arrays, rounded once: the product is
    exact in float64; the sum's float64 rounding is undone where it lands
    on a float32 tie (its error, from two-sum, breaks the tie)."""
    p = a.astype(np.float64) * b.astype(np.float64)
    c = c.astype(np.float64)
    s = p + c
    bv = s - p
    e = (p - (s - bv)) + (c - bv)
    tie = (s.view(np.uint64) & np.uint64((1 << 29) - 1)) == np.uint64(1 << 28)
    fix = tie & (e != 0)
    if fix.any():
        s = np.where(fix, np.nextafter(s, np.where(e > 0, np.inf, -np.inf)), s)
    return s.astype(np.float32)


def cv2_resize_linear(img: np.ndarray, size_hw: Sequence[int]) -> np.ndarray:
    """``cv2.resize(img, (w, h), interpolation=cv2.INTER_LINEAR)`` of a
    float32 ``(H, W, C)`` image whose both sides change, bit for bit with
    OpenCV's AVX2 code: a horizontal then a vertical pass, each
    ``fma(s1 - s0, frac, s0)`` in float32."""
    nh, nw = (int(n) for n in size_hw)
    h, w = img.shape[:2]
    x0, x1, a1 = _cv2_taps(w, nw)
    y0, y1, b1 = _cv2_taps(h, nh)
    s0, s1 = img[:, x0], img[:, x1]
    rows = _fma32(s1 - s0, a1[None, :, None], s0)
    r0, r1 = rows[y0], rows[y1]
    return _fma32(r1 - r0, b1[:, None, None], r0)


def cv2_resize_nearest(lab: np.ndarray, size_hw: Sequence[int]
                       ) -> np.ndarray:
    """``cv2.resize(lab, (w, h), interpolation=cv2.INTER_NEAREST)``: source
    index ``floor(i * n_in / n_out)``, clamped."""
    nh, nw = (int(n) for n in size_hw)
    h, w = lab.shape
    iy = np.minimum(np.floor(np.arange(nh) * (1.0 / (nh / h))), h - 1)
    ix = np.minimum(np.floor(np.arange(nw) * (1.0 / (nw / w))), w - 1)
    return lab[iy.astype(np.int64)[:, None], ix.astype(np.int64)[None, :]]


class SegLoader:
    """Batches of ``(images (B, H, W, 3) float32, labels (B, H, W)
    int32)`` of ``samples``: shuffled and transformed by ``dataset``'s train
    pipeline for training; in order for evaluation, each padded to
    ``eval_canvas`` or, with ``crop_val``, resized so that its short side is
    the crop and centre-cropped (`Segmentation/args.py:70,123-129`).

    ``shard = (rank, size)`` makes each batch the rank's contiguous rows of
    the one-process batch, and only those rows are decoded. The train
    pipeline draws each item's scale, crop, jitter and flip from one stream
    in batch order; for the other ranks' rows the rank makes the same draws
    from the label map's size (its PNG header) alone
    (``transform.skip``)."""

    def __init__(self, samples: Sequence[SegSample], batch_size: int,
                 num_classes: int, crop_size: int = 513, train: bool = True,
                 dataset: str = "voc", seed: int = 0,
                 eval_canvas: Optional[Tuple[int, int]] = None,
                 crop_val: bool = False):
        self.samples = list(samples)
        self.batch_size = batch_size
        self.num_classes = num_classes
        self.crop = crop_size
        self.train = train
        self.dataset = dataset
        self.rng = np.random.RandomState(seed)
        self.eval_canvas = eval_canvas
        self.crop_val = crop_val
        self.transform = (voc_train_transform(crop_size) if dataset == "voc"
                          else cityscapes_train_transform(crop_size))
        self.shard = (0, 1)

    def __len__(self):
        n = len(self.samples)
        return (n // self.batch_size if self.train
                else -(-n // self.batch_size))

    def _eval_item(self, img: np.ndarray, lab: np.ndarray):
        if self.crop_val:
            h, w = lab.shape
            scale = self.crop / min(h, w)
            nh = max(self.crop, int(round(h * scale)))
            nw = max(self.crop, int(round(w * scale)))
            if (nh, nw) != (h, w):
                img = cv2_resize_linear(img, (nh, nw))
                lab = cv2_resize_nearest(lab.astype(np.int32), (nh, nw))
            y0, x0 = (nh - self.crop) // 2, (nw - self.crop) // 2
            return (img[y0:y0 + self.crop, x0:x0 + self.crop],
                    lab[y0:y0 + self.crop, x0:x0 + self.crop])
        if self.eval_canvas:
            ch, cw = self.eval_canvas
            out_i = np.zeros((ch, cw, 3), np.float32)
            out_l = np.full((ch, cw), IGNORE, np.int32)
            h, w = min(lab.shape[0], ch), min(lab.shape[1], cw)
            out_i[:h, :w] = img[:h, :w]
            out_l[:h, :w] = lab[:h, :w]
            return out_i, out_l
        return img, lab

    def _item(self, s: SegSample):
        img, lab = _load_pair(s, self.num_classes, (self.crop, self.crop))
        if self.train:
            return self.transform(img, lab, self.rng)
        return self._eval_item(img, lab)

    def _skip(self, s: SegSample) -> None:
        """The train pipeline's draws for ``s``, which another rank loads."""
        size = ((self.crop, self.crop) if s.image_path is None
                else read_png_size(s.label_path))
        self.transform.skip(size, self.rng)

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        n = len(self.samples)
        order = self.rng.permutation(n) if self.train else np.arange(n)
        rank, size = self.shard
        for b in range(len(self)):
            sel = order[b * self.batch_size:(b + 1) * self.batch_size]
            rows = split_rows(len(sel), rank, size)
            items = []
            for j, i in enumerate(sel):
                if rows.start <= j < rows.stop:
                    items.append(self._item(self.samples[i]))
                elif self.train:
                    self._skip(self.samples[i])
            if not items:
                yield (np.zeros((0, 1, 1, 3), np.float32),
                       np.zeros((0, 1, 1), np.int32))
                continue
            yield (np.stack([it[0] for it in items]),
                   np.stack([it[1] for it in items]))


def _loaders(train: Sequence[SegSample], val: Sequence[SegSample],
             dataset: str, num_classes: int, batch_size: int, crop_size: int,
             seed: int, val_batch_size: int, crop_val: bool,
             canvas: Tuple[int, int]):
    return (SegLoader(train, batch_size, num_classes, crop_size, True,
                      dataset, seed),
            SegLoader(val, val_batch_size, num_classes, crop_size, False,
                      dataset, eval_canvas=None if crop_val else canvas,
                      crop_val=crop_val),
            num_classes)


def _synthetic(seed: int):
    """``afan``'s synthetic fallback: 64 train and 16 val seeds."""
    return ([SegSample(None, None, seed + i) for i in range(64)],
            [SegSample(None, None, seed + 10000 + i) for i in range(16)])


def _find_voc_seg(data_root: str) -> Optional[str]:
    for cand in (os.path.join(data_root, "VOCdevkit", "VOC2012"),
                 os.path.join(data_root, "VOC2012"), data_root):
        if os.path.isdir(os.path.join(cand, "SegmentationClass")):
            return cand
    return None


def voc_seg_loaders(data_root: Optional[str], batch_size: int,
                    crop_size: int = 513, year: str = "2012", seed: int = 0,
                    val_batch_size: int = 1, crop_val: bool = False):
    """(train loader, val loader, 21) of the VOC segmentation tree under
    ``data_root`` (`datasets/voc.py:72-160`): ``train_aug`` with SBD's
    ``SegmentationClassAug`` when ``train_aug.txt`` exists, else ``train``;
    ``val``. With no ``SegmentationClass/`` there, the synthetic samples, as
    in ``afan``; ``year`` plays no part in either."""
    root = _find_voc_seg(data_root) if data_root else None
    if root is None:
        train, val = _synthetic(seed)
        canvas = (crop_size, crop_size)
    else:
        def read_split(name):
            seg_dir = ("SegmentationClassAug" if "aug" in name
                       else "SegmentationClass")
            path = os.path.join(root, "ImageSets", "Segmentation",
                                f"{name}.txt")
            with open(path) as f:
                ids = [line.strip() for line in f if line.strip()]
            return [SegSample(os.path.join(root, "JPEGImages", f"{i}.jpg"),
                              os.path.join(root, seg_dir, f"{i}.png"))
                    for i in ids]
        aug = os.path.exists(os.path.join(root, "ImageSets", "Segmentation",
                                          "train_aug.txt"))
        train = read_split("train_aug" if aug else "train")
        val = read_split("val")
        canvas = VOC_EVAL_CANVAS
    return _loaders(train, val, "voc", VOC_SEG_CLASSES, batch_size,
                    crop_size, seed, val_batch_size, crop_val, canvas)


def cityscapes_loaders(data_root: Optional[str], batch_size: int,
                       crop_size: int = 768, seed: int = 0,
                       val_batch_size: int = 1, crop_val: bool = False):
    """(train loader, val loader, 19) of the Cityscapes tree under
    ``data_root``: every ``leftImg8bit/<split>/<city>/*_leftImg8bit.png``
    with its ``gtFine/<split>/<city>/*_gtFine_labelIds.png``, cities and
    files in sorted order. With no ``leftImg8bit/`` there, the synthetic
    samples, as in ``afan``."""
    img_root = os.path.join(data_root or "", "leftImg8bit")
    if not os.path.isdir(img_root):
        train, val = _synthetic(seed)
        canvas = (crop_size, crop_size)
    else:
        def collect(split):
            out = []
            sdir = os.path.join(img_root, split)
            for city in sorted(os.listdir(sdir)):
                for f in sorted(os.listdir(os.path.join(sdir, city))):
                    if f.endswith("_leftImg8bit.png"):
                        lab = f.replace("_leftImg8bit.png",
                                        "_gtFine_labelIds.png")
                        out.append(SegSample(
                            os.path.join(sdir, city, f),
                            os.path.join(data_root, "gtFine", split, city,
                                         lab), city_encode=True))
            return out
        train, val = collect("train"), collect("val")
        canvas = CITYSCAPES_EVAL_CANVAS
    return _loaders(train, val, "cityscapes", CITYSCAPES_CLASSES, batch_size,
                    crop_size, seed, val_batch_size, crop_val, canvas)
