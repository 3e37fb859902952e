"""The paired image+label transforms of the Cityscapes train pipeline — a
copy of the numpy classes of ``afan/data/ext_transforms.py`` that the port
runs (image HWC float32 in [0, 1], label HW int32; each ``__call__`` draws
from an explicit ``np.random.RandomState``, so a pipeline is deterministic
per seed and draws exactly what ``afan``'s does).

VOC's ``ExtRandomScale`` resizes through PIL and is not ported yet.
"""
from __future__ import annotations

import numbers
from typing import Sequence, Tuple

import numpy as np

IGNORE = 255

Pair = Tuple[np.ndarray, np.ndarray]


def _size_pair(size) -> Tuple[int, int]:
    if isinstance(size, numbers.Number):
        return int(size), int(size)
    return int(size[0]), int(size[1])


class ExtCompose:
    """Chains paired transforms."""

    def __init__(self, transforms: Sequence):
        self.transforms = list(transforms)

    def __call__(self, img, lbl, rng: np.random.RandomState) -> Pair:
        for t in self.transforms:
            img, lbl = t(img, lbl, rng)
        return img, lbl


class ExtRandomHorizontalFlip:
    def __init__(self, p: float = 0.5):
        self.p = p

    def __call__(self, img, lbl, rng) -> Pair:
        if rng.rand() < self.p:
            return img[:, ::-1].copy(), lbl[:, ::-1].copy()
        return img, lbl


class ExtRandomCrop:
    """Random crop with ``pad_if_needed`` (bottom/right, by exactly the
    missing amount); image 0-pad, label 255-pad."""

    def __init__(self, size, pad_if_needed: bool = False):
        self.size = _size_pair(size)
        self.pad_if_needed = pad_if_needed

    def __call__(self, img, lbl, rng) -> Pair:
        th, tw = self.size
        h, w = lbl.shape
        if self.pad_if_needed and (h < th or w < tw):
            ph, pw = max(th - h, 0), max(tw - w, 0)
            img = np.pad(img, ((0, ph), (0, pw), (0, 0)))
            lbl = np.pad(lbl, ((0, ph), (0, pw)), constant_values=IGNORE)
            h, w = lbl.shape
        y = rng.randint(0, h - th + 1)
        x = rng.randint(0, w - tw + 1)
        return img[y:y + th, x:x + tw], lbl[y:y + th, x:x + tw]


class ExtColorJitter:
    """Random brightness/contrast/saturation factors, each uniform in
    ``[max(1 - v, 0), 1 + v]``, applied in a random order to the float image
    (hue, which the pipeline does not use, is not ported)."""

    _GRAY = np.asarray([0.299, 0.587, 0.114], np.float32)

    def __init__(self, brightness: float = 0, contrast: float = 0,
                 saturation: float = 0):
        self.brightness = self._rng_range(brightness, "brightness")
        self.contrast = self._rng_range(contrast, "contrast")
        self.saturation = self._rng_range(saturation, "saturation")

    @staticmethod
    def _rng_range(value: float, name: str):
        if value < 0:
            raise ValueError(f"{name} must be non-negative")
        return None if value == 0 else (max(1.0 - value, 0.0), 1.0 + value)

    def __call__(self, img, lbl, rng) -> Pair:
        ops = []
        if self.brightness is not None:
            f = rng.uniform(*self.brightness)
            ops.append(lambda im: im * f)
        if self.contrast is not None:
            fc = rng.uniform(*self.contrast)

            def contrast(im):
                # torchvision adjusts around the mean of the grayscale image
                mean = (im @ self._GRAY).mean()
                return (im - mean) * fc + mean
            ops.append(contrast)
        if self.saturation is not None:
            fs = rng.uniform(*self.saturation)

            def saturation(im):
                gray = (im @ self._GRAY)[..., None]
                return (im - gray) * fs + gray
            ops.append(saturation)
        rng.shuffle(ops)
        for op in ops:
            img = op(img)
        return np.clip(img, 0.0, 1.0), lbl


def cityscapes_train_transform(crop_size: int) -> ExtCompose:
    """The reference Cityscapes train pipeline (`args.py:139-146`):
    RandomCrop(pad_if_needed) + ColorJitter(.5, .5, .5) + HFlip."""
    return ExtCompose([
        ExtRandomCrop(crop_size, pad_if_needed=True),
        ExtColorJitter(0.5, 0.5, 0.5),
        ExtRandomHorizontalFlip(),
    ])
