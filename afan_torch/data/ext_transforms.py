"""The paired image+label transforms of ``afan/data/ext_transforms.py``
(image HWC float32 in [0, 1], label HW int32; each ``__call__`` draws from
an explicit ``np.random.RandomState``, so a pipeline is deterministic per
seed and draws exactly what ``afan``'s does): every class there, numpy
only. Each draw depends on the item's size alone, never on its pixels:
``skip`` makes a transform's draws from the (H, W) of an item it does not
apply to and returns the size it would have given, so that a data-parallel
rank keeps the one-process stream without decoding the other ranks' rows.

``afan`` resizes and rotates through PIL; the machine with the card has no
PIL, so these compute what PIL computes, bit for bit. :func:`_resize_pair`
(``ExtRandomScale``, ``ExtScale``, ``ExtResize``): the image through uint8
with Pillow's fixed-point bilinear
(:func:`afan_torch.data.voc_det.resize_uint8`), the label with Pillow's
nearest (:func:`resize_nearest`). :func:`rotate_pil` (``ExtRandomRotation``)
is ``Image.rotate``: its exact-angle shortcuts (a copy, a transpose), its
affine matrix in Python floats, the image through uint8 with
``BILINEAR`` (Pillow's generic transform: each output pixel's source
position in float64, ``a + (b - a) * d`` along x then y, truncated to
uint8) and the ``"I"`` label with ``NEAREST`` (Pillow's 16.16 fixed-point
walk, or its float64 walk where a corner falls outside the fixed-point
range), the uncovered pixels given the fill colour.
"""
from __future__ import annotations

import math
import numbers
from typing import Callable, Sequence, Tuple

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


def _pil_rotation(w: int, h: int, angle: float, expand: bool):
    """``Image.rotate``'s inverse affine matrix (output to source) and the
    output's (w, h), in its Python arithmetic (no centre, no
    translation)."""
    angle = -math.radians(angle % 360.0)
    m = [round(math.cos(angle), 15), round(math.sin(angle), 15), 0.0,
         round(-math.sin(angle), 15), round(math.cos(angle), 15), 0.0]

    def transform(x, y):
        a, b, c, d, e, f = m
        return a * x + b * y + c, d * x + e * y + f

    cx, cy = w / 2, h / 2
    m[2], m[5] = transform(-cx, -cy)
    m[2] += cx
    m[5] += cy
    if expand:
        xs, ys = zip(*(transform(x, y)
                       for x, y in ((0, 0), (w, 0), (w, h), (0, h))))
        nw = math.ceil(max(xs)) - math.floor(min(xs))
        nh = math.ceil(max(ys)) - math.floor(min(ys))
        m[2], m[5] = transform(-(nw - w) / 2.0, -(nh - h) / 2.0)
        w, h = nw, nh
    return m, w, h


def _shortcut(angle: float, size_hw, expand: bool):
    """The exact angles ``Image.rotate`` answers without a transform: 0 (a
    copy), 180, and 90 or 270 when expanding or square (a transpose);
    ``np.rot90``'s turns, or None."""
    angle = angle % 360.0
    if angle == 0:
        return 0
    if angle == 180:
        return 2
    if angle in (90, 270) and (expand or size_hw[0] == size_hw[1]):
        return 1 if angle == 90 else 3
    return None


def rotated_size(size_hw, angle: float, expand: bool) -> Tuple[int, int]:
    """The (H, W) of :func:`rotate_pil`'s output."""
    turns = _shortcut(angle, size_hw, expand)
    if turns is not None:
        return tuple(size_hw[::-1]) if turns % 2 else tuple(size_hw)
    _, w, h = _pil_rotation(size_hw[1], size_hw[0], angle, expand)
    return h, w


def _coord(v: np.ndarray) -> np.ndarray:
    """Pillow's ``COORD``: -1 below 0, else truncated."""
    return np.where(v < 0.0, -1, v.astype(np.int64))


def _nearest(src: np.ndarray, m, ow: int, oh: int, out: np.ndarray) -> None:
    """Pillow's ``NEAREST`` affine transform into ``out`` (``affine_fixed``
    where the four corners map inside +-32768, else the float walk; the
    pure scale, when both shears round to 0, through ``ImagingScaleAffine``'s
    table)."""
    h, w = src.shape[:2]
    if m[1] == 0 and m[3] == 0:
        xs = np.add.accumulate(np.r_[m[2] + m[0] * 0.5,
                                     np.full(ow - 1, m[0])])
        ys = np.add.accumulate(np.r_[m[5] + m[4] * 0.5,
                                     np.full(oh - 1, m[4])])
        xin, yin = _coord(xs)[None, :], _coord(ys)[:, None]
    elif all(abs(x * m[0] + y * m[1] + m[2]) < 32768.0
             and abs(x * m[3] + y * m[4] + m[5]) < 32768.0
             for x, y in ((0, 0), (ow, oh), (0, oh), (ow, 0))):
        def fix(v):
            v = v * 65536.0 + 0.5
            return math.floor(v) if v < 0.0 else int(v)
        a0, a1, a3, a4 = fix(m[0]), fix(m[1]), fix(m[3]), fix(m[4])
        a2 = fix(m[2] + m[1] * 0.5 + m[0] * 0.5)
        a5 = fix(m[5] + m[4] * 0.5 + m[3] * 0.5)
        yy = np.arange(oh, dtype=np.int64)[:, None]
        xx = np.arange(ow, dtype=np.int64)[None, :]
        xin = (a2 + yy * a1 + xx * a0) >> 16
        yin = (a5 + yy * a4 + xx * a3) >> 16
    else:
        def walk(start, across, down):
            rows = np.add.accumulate(np.r_[start, np.full(oh - 1, down)])
            steps = np.empty((oh, ow))
            steps[:, 0], steps[:, 1:] = rows, across
            return _coord(np.add.accumulate(steps, axis=1))
        xin = walk(m[2] + m[1] * 0.5 + m[0] * 0.5, m[0], m[1])
        yin = walk(m[5] + m[4] * 0.5 + m[3] * 0.5, m[3], m[4])
    xin, yin = np.broadcast_arrays(xin, yin)
    ok = (xin >= 0) & (xin < w) & (yin >= 0) & (yin < h)
    out[ok] = src[yin[ok], xin[ok]]


def _bilinear(src: np.ndarray, m, ow: int, oh: int, out: np.ndarray
              ) -> None:
    """Pillow's ``BILINEAR`` generic transform of a uint8 image into
    ``out``: a pixel whose source position falls outside the image keeps
    the fill."""
    h, w = src.shape[:2]
    yc = np.arange(oh, dtype=np.float64)[:, None] + 0.5
    xc = np.arange(ow, dtype=np.float64)[None, :] + 0.5
    xin = m[0] * xc + m[1] * yc + m[2]
    yin = m[3] * xc + m[4] * yc + m[5]
    ok = (xin >= 0.0) & (xin < w) & (yin >= 0.0) & (yin < h)
    xin, yin = xin[ok] - 0.5, yin[ok] - 0.5
    x, y = np.floor(xin).astype(np.int64), np.floor(yin).astype(np.int64)
    dx, dy = (xin - x)[:, None], (yin - y)[:, None]
    x0, x1 = np.clip(x, 0, w - 1), np.clip(x + 1, 0, w - 1)
    s = src.astype(np.float64).reshape(h, w, -1)

    def lerp_x(row):
        a, b = s[row, x0], s[row, x1]
        return a + (b - a) * dx

    v1 = lerp_x(np.clip(y, 0, h - 1))
    below = ((y + 1 >= 0) & (y + 1 < h))[:, None]
    v2 = np.where(below, lerp_x(np.clip(y + 1, 0, h - 1)), v1)
    v = v1 + (v2 - v1) * dy
    out[ok] = v.astype(np.uint8).reshape((-1,) + src.shape[2:])


def rotate_pil(src: np.ndarray, angle: float, bilinear: bool,
               expand: bool, fill) -> np.ndarray:
    """``Image.fromarray(src).rotate(angle, BILINEAR if bilinear else
    NEAREST, expand=expand, fillcolor=fill)`` as an array: a uint8 image
    (``bilinear``) or an int32 ``"I"`` label."""
    turns = _shortcut(angle, src.shape[:2], expand)
    if turns is not None:
        return np.rot90(src, turns).copy()
    m, ow, oh = _pil_rotation(src.shape[1], src.shape[0], angle, expand)
    out = np.full((oh, ow) + src.shape[2:], fill, src.dtype)
    (_bilinear if bilinear else _nearest)(src, m, ow, oh, out)
    return out


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


class ExtRandomVerticalFlip:
    def __init__(self, p: float = 0.5):
        self.p = p

    def __call__(self, img, lbl, rng) -> Pair:
        if rng.rand() < self.p:
            return img[::-1].copy(), lbl[::-1].copy()
        return img, lbl

    def skip(self, size_hw, rng):
        rng.rand()
        return size_hw


class ExtCenterCrop:
    def __init__(self, size):
        self.size = _size_pair(size)

    def __call__(self, img, lbl, rng) -> Pair:
        th, tw = self.size
        h, w = lbl.shape
        y = max((h - th) // 2, 0)
        x = max((w - tw) // 2, 0)
        return img[y:y + th, x:x + tw], lbl[y:y + th, x:x + tw]

    def skip(self, size_hw, rng):
        return min(self.size[0], size_hw[0]), min(self.size[1], size_hw[1])


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


class ExtScale:
    """Fixed scale factor, each side truncated."""

    def __init__(self, scale: float):
        self.scale = scale

    def __call__(self, img, lbl, rng) -> Pair:
        return _resize_pair(img, lbl, self.skip(lbl.shape, rng))

    def skip(self, size_hw, rng):
        h, w = size_hw
        return int(h * self.scale), int(w * self.scale)


class ExtRandomRotation:
    """Rotate by a uniform angle in ``degrees`` (:func:`rotate_pil`): the
    image bilinear with fill 0 through uint8, the label nearest with
    ``label_fill`` (``afan``'s default 0, its reference's quirk)."""

    def __init__(self, degrees, expand: bool = False, label_fill: int = 0):
        if isinstance(degrees, numbers.Number):
            if degrees < 0:
                raise ValueError("single-number degrees must be positive")
            self.degrees = (-degrees, degrees)
        else:
            self.degrees = tuple(degrees)
        self.expand = expand
        self.label_fill = label_fill

    def __call__(self, img, lbl, rng) -> Pair:
        angle = rng.uniform(self.degrees[0], self.degrees[1])
        img8 = (np.clip(img, 0.0, 1.0) * 255).astype(np.uint8)
        im = rotate_pil(img8, angle, True, self.expand, 0)
        lm = rotate_pil(lbl.astype(np.int32), angle, False, self.expand,
                        self.label_fill)
        return im.astype(np.float32) / 255.0, lm

    def skip(self, size_hw, rng):
        angle = rng.uniform(self.degrees[0], self.degrees[1])
        return rotated_size(size_hw, angle, self.expand)


class ExtPad:
    """Pad H and W up to multiples of ``divisor``, centred; image 0, label
    ``label_fill``."""

    def __init__(self, divisor: int = 32, label_fill: int = IGNORE):
        self.divisor = divisor
        self.label_fill = label_fill

    def __call__(self, img, lbl, rng) -> Pair:
        h, w = lbl.shape
        ph, pw = (-h) % self.divisor, (-w) % self.divisor
        if not ph and not pw:
            return img, lbl
        pads = ((ph // 2, ph - ph // 2), (pw // 2, pw - pw // 2))
        return (np.pad(img, pads + ((0, 0),)),
                np.pad(lbl, pads, constant_values=self.label_fill))

    def skip(self, size_hw, rng):
        return tuple(n + (-n) % self.divisor for n in size_hw)


class ExtToTensor:
    """uint8 or float HWC image → float32 (uint8 divided by 255 with
    ``normalize``); label → int32."""

    def __init__(self, normalize: bool = True):
        self.normalize = normalize

    def __call__(self, img, lbl, rng) -> Pair:
        img = np.asarray(img)
        if img.dtype == np.uint8:
            img = img.astype(np.float32) / (255.0 if self.normalize else 1.0)
        else:
            img = img.astype(np.float32)
        return img, np.asarray(lbl, np.int32)

    def skip(self, size_hw, rng):
        return size_hw


class ExtNormalize:
    """(img - mean) / std per channel; label untouched."""

    def __init__(self, mean: Sequence[float], std: Sequence[float]):
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)

    def __call__(self, img, lbl, rng) -> Pair:
        return (img - self.mean) / self.std, lbl

    def skip(self, size_hw, rng):
        return size_hw


class ExtRandomCrop:
    """Random crop with optional fixed ``padding`` (all sides) and
    ``pad_if_needed`` (bottom/right, by exactly the missing amount); image
    0-pad, label ``label_fill``-pad."""

    def __init__(self, size, padding: int = 0, pad_if_needed: bool = False,
                 label_fill: int = IGNORE):
        self.size = _size_pair(size)
        self.padding = padding
        self.pad_if_needed = pad_if_needed
        self.label_fill = label_fill

    def __call__(self, img, lbl, rng) -> Pair:
        th, tw = self.size
        if self.padding > 0:
            p = self.padding
            img = np.pad(img, ((p, p), (p, p), (0, 0)))
            lbl = np.pad(lbl, ((p, p), (p, p)),
                         constant_values=self.label_fill)
        h, w = lbl.shape
        if self.pad_if_needed and (h < th or w < tw):
            ph, pw = max(th - h, 0), max(tw - w, 0)
            img = np.pad(img, ((0, ph), (0, pw), (0, 0)))
            lbl = np.pad(lbl, ((0, ph), (0, pw)),
                         constant_values=self.label_fill)
            h, w = lbl.shape
        y = rng.randint(0, h - th + 1)
        x = rng.randint(0, w - tw + 1)
        return img[y:y + th, x:x + tw], lbl[y:y + th, x:x + tw]

    def skip(self, size_hw, rng):
        th, tw = self.size
        h, w = (n + 2 * max(self.padding, 0) for n in size_hw)
        if self.pad_if_needed:
            h, w = max(h, th), max(w, tw)
        rng.randint(0, h - th + 1)
        rng.randint(0, w - tw + 1)
        return th, tw


class ExtResize:
    """Resize to (h, w), or match the short side to an int size
    (torchvision's rule)."""

    def __init__(self, size):
        self.size = size

    def __call__(self, img, lbl, rng) -> Pair:
        return _resize_pair(img, lbl, self.skip(lbl.shape, rng))

    def skip(self, size_hw, rng):
        h, w = size_hw
        if isinstance(self.size, numbers.Number):
            s = int(self.size)
            if h <= w:
                return s, max(int(round(w * s / h)), 1)
            return max(int(round(h * s / w)), 1), s
        return _size_pair(self.size)


class ExtColorJitter:
    """Random brightness/contrast/saturation factors (uniform in
    ``[max(1 - v, 0), 1 + v]``, or a given range) and hue shift (uniform in
    ``[-v, v]`` within [-0.5, 0.5]), applied in a random order to the float
    image."""

    _GRAY = np.asarray([0.299, 0.587, 0.114], np.float32)

    def __init__(self, brightness=0, contrast=0, saturation=0, hue=0):
        self.brightness = self._rng_range(brightness, "brightness")
        self.contrast = self._rng_range(contrast, "contrast")
        self.saturation = self._rng_range(saturation, "saturation")
        self.hue = self._rng_range(hue, "hue", center=0.0,
                                   bound=(-0.5, 0.5), clip_zero=False)

    @staticmethod
    def _rng_range(value, name, center=1.0, bound=(0, float("inf")),
                   clip_zero=True):
        if isinstance(value, numbers.Number):
            if value < 0:
                raise ValueError(f"{name} must be non-negative")
            lo, hi = center - value, center + value
            if clip_zero:
                lo = max(lo, 0.0)
        else:
            lo, hi = value
            if not bound[0] <= lo <= hi <= bound[1]:
                raise ValueError(f"{name} range outside {bound}")
        if lo == hi == center:
            return None
        return (lo, hi)

    @staticmethod
    def _hue(img, f):
        """Rotate the hue in HSV space by ``f`` (a fraction of the circle),
        in ``afan``'s vector arithmetic."""
        mx = img.max(axis=-1)
        mn = img.min(axis=-1)
        diff = mx - mn + 1e-12
        r, g, b = img[..., 0], img[..., 1], img[..., 2]
        h = np.where(mx == r, (g - b) / diff % 6.0,
                     np.where(mx == g, (b - r) / diff + 2.0,
                              (r - g) / diff + 4.0)) / 6.0
        h = (h + f) % 1.0
        s = np.where(mx > 0, diff / (mx + 1e-12), 0.0)
        i = np.floor(h * 6.0)
        fr = h * 6.0 - i
        p = mx * (1 - s)
        q = mx * (1 - fr * s)
        t = mx * (1 - (1 - fr) * s)
        i = i.astype(np.int32) % 6
        out = np.empty_like(img)
        for k, (rr, gg, bb) in enumerate([(mx, t, p), (q, mx, p), (p, mx, t),
                                          (p, q, mx), (t, p, mx),
                                          (mx, p, q)]):
            m = i == k
            out[..., 0] = np.where(m, rr, out[..., 0])
            out[..., 1] = np.where(m, gg, out[..., 1])
            out[..., 2] = np.where(m, bb, out[..., 2])
        return out

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
        if self.hue is not None:
            fh = rng.uniform(*self.hue)
            ops.append(lambda im: self._hue(im, fh))
        rng.shuffle(ops)
        for op in ops:
            img = op(img)
        return np.clip(img, 0.0, 1.0), lbl

    def skip(self, size_hw, rng):
        factors = [r for r in (self.brightness, self.contrast,
                               self.saturation, self.hue) if r is not None]
        for r in factors:
            rng.uniform(*r)
        rng.shuffle(factors)        # the same draws as ``ops``' shuffle
        return size_hw


class ExtLambda:
    """Apply a function to the image only."""

    def __init__(self, fn: Callable[[np.ndarray], np.ndarray]):
        self.fn = fn

    def __call__(self, img, lbl, rng) -> Pair:
        return self.fn(img), lbl

    def skip(self, size_hw, rng):
        """The size of an item the function keeps the shape of (``afan``'s
        pipelines put no resizing function here)."""
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
