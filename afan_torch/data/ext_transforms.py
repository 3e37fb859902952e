"""The paired image+label transforms of the VOC and Cityscapes train
pipelines — a copy of the numpy classes of ``afan/data/ext_transforms.py``
that the port runs (image HWC float32 in [0, 1], label HW int32; each
``__call__`` draws from an explicit ``np.random.RandomState``, so a pipeline
is deterministic per seed and draws exactly what ``afan``'s does). Each
draw depends on the item's size alone, never on its pixels: ``skip``
makes a transform's draws from the (H, W) of an item it does not apply
to and returns the size it would have given, so that a data-parallel rank
keeps the one-process stream without decoding the other ranks' rows.

``afan``'s VOC scale resizes through PIL (``_resize_pair``); the machine
with the card has no PIL, so :func:`_resize_pair` here computes what PIL
computes, bit for bit: the image through uint8 with Pillow's fixed-point
bilinear (:func:`afan_torch.data.voc_det.resize_uint8`), the label with
Pillow's nearest (:func:`resize_nearest`).
"""
from __future__ import annotations

import numbers
from typing import Sequence, Tuple

import numpy as np

from .voc_det import resize_uint8

IGNORE = 255

Pair = Tuple[np.ndarray, np.ndarray]


def _nearest_index(n_in: int, n_out: int) -> np.ndarray:
    """Pillow's nearest source index of each output index
    (``ImagingScaleAffine``, ``libImaging/Geometry.c``): the position
    starts at half the step and adds the step once per index, in float64,
    and is truncated; the sums are taken one by one, as Pillow's loop takes
    them."""
    step = float(n_in) / n_out
    deltas = np.full(n_out, step)
    deltas[0] = step * 0.5
    return np.add.accumulate(deltas).astype(np.int64)


def resize_nearest(lab: np.ndarray, size_hw: Sequence[int]) -> np.ndarray:
    """PIL's ``Image.resize((w, h), Image.NEAREST)`` of a mode-``"I"``
    label image to ``size_hw = (h, w)`` (``afan``'s ``_to_pil_lab`` path),
    as int32."""
    nh, nw = (int(n) for n in size_hw)
    h, w = lab.shape
    if (nh, nw) == (h, w):
        return lab.astype(np.int32)
    iy, ix = _nearest_index(h, nh), _nearest_index(w, nw)
    return lab.astype(np.int32)[iy[:, None], ix[None, :]]


def _resize_pair(img: np.ndarray, lab: np.ndarray, size_hw: Tuple[int, int]
                 ) -> Pair:
    """Bilinear image / nearest label resize to ``(h, w)``, as ``afan``'s
    PIL path computes it: the image truncated to uint8 after a clip to
    [0, 1], resized, and divided by 255."""
    img8 = (np.clip(img, 0.0, 1.0) * 255).astype(np.uint8)
    return (resize_uint8(img8, size_hw).astype(np.float32) / 255.0,
            resize_nearest(lab, size_hw))


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

    def skip(self, size_hw: Tuple[int, int], rng) -> Tuple[int, int]:
        for t in self.transforms:
            size_hw = t.skip(size_hw, rng)
        return size_hw


class ExtRandomHorizontalFlip:
    def __init__(self, p: float = 0.5):
        self.p = p

    def __call__(self, img, lbl, rng) -> Pair:
        if rng.rand() < self.p:
            return img[:, ::-1].copy(), lbl[:, ::-1].copy()
        return img, lbl

    def skip(self, size_hw, rng):
        rng.rand()
        return size_hw


class ExtRandomScale:
    """Uniform scale in ``scale_range`` applied to both H and W, each side
    truncated (``afan``'s ``ExtRandomScale``)."""

    def __init__(self, scale_range: Tuple[float, float] = (0.5, 2.0)):
        self.scale_range = scale_range

    def __call__(self, img, lbl, rng) -> Pair:
        return _resize_pair(img, lbl, self.skip(lbl.shape, rng))

    def skip(self, size_hw, rng):
        s = rng.uniform(self.scale_range[0], self.scale_range[1])
        h, w = size_hw
        return int(h * s), int(w * s)


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

    def skip(self, size_hw, rng):
        th, tw = self.size
        h, w = size_hw
        if self.pad_if_needed:
            h, w = max(h, th), max(w, tw)
        rng.randint(0, h - th + 1)
        rng.randint(0, w - tw + 1)
        return th, tw


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

    def skip(self, size_hw, rng):
        factors = [r for r in (self.brightness, self.contrast,
                               self.saturation) if r is not None]
        for r in factors:
            rng.uniform(*r)
        rng.shuffle(factors)        # the same draws as ``ops``' shuffle
        return size_hw


def cityscapes_train_transform(crop_size: int) -> ExtCompose:
    """The reference Cityscapes train pipeline (`args.py:139-146`):
    RandomCrop(pad_if_needed) + ColorJitter(.5, .5, .5) + HFlip."""
    return ExtCompose([
        ExtRandomCrop(crop_size, pad_if_needed=True),
        ExtColorJitter(0.5, 0.5, 0.5),
        ExtRandomHorizontalFlip(),
    ])


def voc_train_transform(crop_size: int,
                        scale_range=(0.5, 2.0)) -> ExtCompose:
    """The reference VOC train pipeline (`args.py:118-124`): RandomScale +
    RandomCrop(pad_if_needed) + HFlip; its draws are the scale, the crop's
    y and x, and the flip, in that order."""
    return ExtCompose([
        ExtRandomScale(scale_range),
        ExtRandomCrop(crop_size, pad_if_needed=True),
        ExtRandomHorizontalFlip(),
    ])
