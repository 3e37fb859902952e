"""Segmentation data for the port: the Cityscapes pipeline with ``afan``'s
deterministic synthetic fallback — a copy of the numpy parts of
``afan/data/seg_data.py``.

Samples are class-coloured rectangles on noise (:func:`_synth_pair`, the
same bytes as ``afan``'s for a seed), run through the Cityscapes train
transform (crop 768 with label pad 255, colour jitter, flip). Reading the
on-disk datasets is not ported yet: a data root that holds them raises.
"""
from __future__ import annotations

import os
from typing import Iterator, Optional, Sequence, Tuple

import numpy as np

from .ext_transforms import cityscapes_train_transform

CITYSCAPES_CLASSES = 19


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


class SegLoader:
    """Batches of ``(images (B, H, W, 3) float32, labels (B, H, W)
    int32)`` of the synthetic samples with the given seeds: shuffled and
    transformed for training, in order otherwise. The samples are made at
    the crop size, so ``afan``'s eval canvas (the crop) adds no padding."""

    def __init__(self, seeds: Sequence[int], batch_size: int,
                 num_classes: int, crop_size: int = 768, train: bool = True,
                 seed: int = 0):
        self.seeds = list(seeds)
        self.batch_size = batch_size
        self.num_classes = num_classes
        self.crop = crop_size
        self.train = train
        self.rng = np.random.RandomState(seed)
        self.transform = cityscapes_train_transform(crop_size)

    def __len__(self):
        n = len(self.seeds)
        return (n // self.batch_size if self.train
                else -(-n // self.batch_size))

    def _item(self, seed: int):
        img, lab = _synth_pair(seed, self.num_classes, (self.crop, self.crop))
        return self.transform(img, lab, self.rng) if self.train else (img, lab)

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        n = len(self.seeds)
        order = self.rng.permutation(n) if self.train else np.arange(n)
        for b in range(len(self)):
            sel = order[b * self.batch_size:(b + 1) * self.batch_size]
            items = [self._item(self.seeds[i]) for i in sel]
            yield (np.stack([it[0] for it in items]),
                   np.stack([it[1] for it in items]))


def cityscapes_loaders(data_root: Optional[str], batch_size: int,
                       crop_size: int = 768, seed: int = 0):
    """(train loader, val loader with batch 1, 19). With no Cityscapes
    under ``data_root`` (``leftImg8bit/``) the samples are synthetic: 64
    train and 16 val seeds, as in ``afan``."""
    if data_root and os.path.isdir(os.path.join(data_root, "leftImg8bit")):
        raise NotImplementedError(
            f"reading Cityscapes from {data_root!r} is not ported yet; "
            f"the port trains on the synthetic samples only")
    train = [seed + i for i in range(64)]
    val = [seed + 10000 + i for i in range(16)]
    return (SegLoader(train, batch_size, CITYSCAPES_CLASSES, crop_size,
                      True, seed),
            SegLoader(val, 1, CITYSCAPES_CLASSES, crop_size, False),
            CITYSCAPES_CLASSES)
