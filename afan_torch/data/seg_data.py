"""Segmentation data for the port: the VOC and Cityscapes pipelines with
``afan``'s deterministic synthetic fallback — a copy of the numpy parts of
``afan/data/seg_data.py``.

Samples are class-coloured rectangles on noise (:func:`_synth_pair`, the
same bytes as ``afan``'s for a seed): 21 classes through the VOC train
transform (random scale 0.5-2 through Pillow's resizes, crop with label pad
255, flip), 19 through the Cityscapes one (crop, colour jitter, flip).
Evaluation batches are the samples as made (at the crop size, so
``afan``'s eval canvas of the crop adds no padding) or, with ``crop_val``,
resized to the crop's short side and centre-cropped, with OpenCV's linear
and nearest resizes written in numpy (the machine with the card has no
``cv2``). Reading the on-disk datasets is not ported yet: a data root that
holds them raises.
"""
from __future__ import annotations

import os
from typing import Iterator, Optional, Sequence, Tuple

import numpy as np

from .ext_transforms import cityscapes_train_transform, voc_train_transform

IGNORE = 255
# Cityscapes' 19 train-id colours (`datasets/cityscapes.py` decode_target)
CITY_TRAIN_COLORS = np.asarray([
    (128, 64, 128), (244, 35, 232), (70, 70, 70), (102, 102, 156),
    (190, 153, 153), (153, 153, 153), (250, 170, 30), (220, 220, 0),
    (107, 142, 35), (152, 251, 152), (70, 130, 180), (220, 20, 60),
    (255, 0, 0), (0, 0, 142), (0, 0, 70), (0, 60, 100), (0, 80, 100),
    (0, 0, 230), (119, 11, 32)], np.uint8)
VOC_SEG_CLASSES = 21
CITYSCAPES_CLASSES = 19
UNPORTED = ("is not ported yet (ROADMAP.md, queue 1, item 6: datasets from "
            "disk)")


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


def _cv2_taps(n_in: int, n_out: int):
    """OpenCV's ``INTER_LINEAR`` taps along one axis when both axes are
    resized: source ``(i + 0.5) * n_in / n_out - 0.5`` in float64, its
    floor and its fraction (rounded to float32), clamped at the edges."""
    src = (np.arange(n_out) + 0.5) * (1.0 / (n_out / n_in)) - 0.5
    i0 = np.floor(src).astype(np.int64)
    frac = (src - i0).astype(np.float32)
    low, high = i0 < 0, i0 >= n_in - 1
    frac[low | high] = 0.0
    i0 = np.clip(i0, 0, n_in - 1)
    return i0, np.minimum(i0 + 1, n_in - 1), np.float32(1.0) - frac, frac


def cv2_resize_linear(img: np.ndarray, size_hw: Sequence[int]) -> np.ndarray:
    """``cv2.resize(img, (w, h), interpolation=cv2.INTER_LINEAR)`` of a
    float32 ``(H, W, C)`` image whose both sides change: a horizontal then
    a vertical float32 pass (within 2 ulp of OpenCV's vector code)."""
    nh, nw = (int(n) for n in size_hw)
    h, w = img.shape[:2]
    x0, x1, a0, a1 = _cv2_taps(w, nw)
    y0, y1, b0, b1 = _cv2_taps(h, nh)
    rows = img[:, x0] * a0[None, :, None] + img[:, x1] * a1[None, :, None]
    return rows[y0] * b0[:, None, None] + rows[y1] * b1[:, None, None]


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
    int32)`` of the synthetic samples with the given seeds: shuffled and
    transformed by ``dataset``'s train pipeline for training, in order
    otherwise. ``crop_val`` resizes each eval sample so that its short side
    is the crop and centre-crops it (`Segmentation/args.py:70,123-129`)."""

    def __init__(self, seeds: Sequence[int], batch_size: int,
                 num_classes: int, crop_size: int = 513, train: bool = True,
                 dataset: str = "voc", seed: int = 0,
                 crop_val: bool = False):
        self.seeds = list(seeds)
        self.batch_size = batch_size
        self.num_classes = num_classes
        self.crop = crop_size
        self.train = train
        self.dataset = dataset
        self.rng = np.random.RandomState(seed)
        self.crop_val = crop_val
        self.transform = (voc_train_transform(crop_size) if dataset == "voc"
                          else cityscapes_train_transform(crop_size))

    def __len__(self):
        n = len(self.seeds)
        return (n // self.batch_size if self.train
                else -(-n // self.batch_size))

    def _eval_item(self, img: np.ndarray, lab: np.ndarray):
        if not self.crop_val:
            return img, lab
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

    def _item(self, seed: int):
        img, lab = _synth_pair(seed, self.num_classes, (self.crop, self.crop))
        if self.train:
            return self.transform(img, lab, self.rng)
        return self._eval_item(img, lab)

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        n = len(self.seeds)
        order = self.rng.permutation(n) if self.train else np.arange(n)
        for b in range(len(self)):
            sel = order[b * self.batch_size:(b + 1) * self.batch_size]
            items = [self._item(self.seeds[i]) for i in sel]
            yield (np.stack([it[0] for it in items]),
                   np.stack([it[1] for it in items]))


def _loaders(dataset: str, num_classes: int, batch_size: int, crop_size: int,
             seed: int, val_batch_size: int, crop_val: bool):
    """``afan``'s synthetic fallback: 64 train and 16 val seeds."""
    train = [seed + i for i in range(64)]
    val = [seed + 10000 + i for i in range(16)]
    return (SegLoader(train, batch_size, num_classes, crop_size, True,
                      dataset, seed),
            SegLoader(val, val_batch_size, num_classes, crop_size, False,
                      dataset, crop_val=crop_val),
            num_classes)


def _find_voc_seg(data_root: str) -> Optional[str]:
    for cand in (os.path.join(data_root, "VOCdevkit", "VOC2012"),
                 os.path.join(data_root, "VOC2012"), data_root):
        if os.path.isdir(os.path.join(cand, "SegmentationClass")):
            return cand
    return None


def voc_seg_loaders(data_root: Optional[str], batch_size: int,
                    crop_size: int = 513, year: str = "2012", seed: int = 0,
                    val_batch_size: int = 1, crop_val: bool = False):
    """(train loader, val loader, 21). With no VOC under ``data_root``
    (``SegmentationClass/``) the samples are synthetic, as in ``afan``;
    ``year`` names the VOC release to read and plays no part in them."""
    root = _find_voc_seg(data_root) if data_root else None
    if root is not None:
        raise NotImplementedError(
            f"reading VOC {year} from {root!r} {UNPORTED}; the port trains "
            f"on the synthetic samples only")
    return _loaders("voc", VOC_SEG_CLASSES, batch_size, crop_size, seed,
                    val_batch_size, crop_val)


def cityscapes_loaders(data_root: Optional[str], batch_size: int,
                       crop_size: int = 768, seed: int = 0,
                       val_batch_size: int = 1, crop_val: bool = False):
    """(train loader, val loader, 19). With no Cityscapes under
    ``data_root`` (``leftImg8bit/``) the samples are synthetic, as in
    ``afan``."""
    if data_root and os.path.isdir(os.path.join(data_root, "leftImg8bit")):
        raise NotImplementedError(
            f"reading Cityscapes from {data_root!r} {UNPORTED}; the port "
            f"trains on the synthetic samples only")
    return _loaders("cityscapes", CITYSCAPES_CLASSES, batch_size, crop_size,
                    seed, val_batch_size, crop_val)
