"""PASCAL VOC detection data — the PyTorch counterpart of
``afan/data/voc_det.py``: the class names, the resize rule and the resize
that the detection server uses, and the training loader on ``afan``'s
synthetic VOC stand-in (reading VOC from disk is not ported yet).

The loader (:class:`DetectionLoader`) is ``afan``'s, with the same
``RandomState`` calls in the same order, so one seed gives the same batches
byte for byte: tall and fat images in separate batches (the reference
sampler's grouping), each padded to its bucket's static canvas, random
horizontal flips at train time, ground truth padded to ``MAX_GT_BOXES``.

``resize_uint8`` (which ``resize_image`` and the segmentation pipeline's
scale call) does what PIL's ``Image.resize(..., Image.BILINEAR)`` does
to an 8-bit RGB image (the machine with the card has no PIL), in the same
fixed-point arithmetic, so the two agree bit for bit: per axis, the
triangle filter's weights over a support widened by the downscale factor,
normalized per output index in float64 and rounded to ``2**22`` fixed
point; then a horizontal and a vertical pass, each accumulated in integers
from one half, shifted back and clipped to uint8 (Pillow's
``ImagingResample``, ``libImaging/Resample.c``).
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Iterator, List, Optional, Sequence

import numpy as np
import torch

VOC_CLASSES = (
    "aeroplane", "bicycle", "bird", "boat", "bottle", "bus", "car", "cat",
    "chair", "cow", "diningtable", "dog", "horse", "motorbike", "person",
    "pottedplant", "sheep", "sofa", "train", "tvmonitor")   # labels 1..20

PRECISION_BITS = 32 - 8 - 2     # Pillow's fixed point for 8-bit images

MAX_GT_BOXES = 64  # static gt capacity (VOC images have <= ~42 objects)
UNPORTED = "not ported yet (ROADMAP.md, queue 1, item 6: datasets from disk)"


@dataclass
class DetSample:
    image_id: str
    image_path: Optional[str]     # None for synthetic
    width: int
    height: int
    boxes: np.ndarray             # (G, 4) float32, 0-based pixel coords
    labels: np.ndarray            # (G,) int64 (1-based classes)
    # COCO iscrowd gt: not a training target, an ignore region at eval
    crowd_boxes: Optional[np.ndarray] = None
    crowd_labels: Optional[np.ndarray] = None
    synthetic_seed: Optional[int] = None


def compute_scale(width: int, height: int, image_min_side: float,
                  image_max_side: float) -> float:
    """The resize rule of `dataset/base.py:75-86`: shorter side to
    ``image_min_side``, then cap the longer side at ``image_max_side``."""
    scale = image_min_side / min(width, height)
    longer = max(width, height) * scale
    if longer > image_max_side:
        scale *= image_max_side / longer
    return scale


def _bilinear_coeffs(n_in: int, n_out: int):
    """Pillow's ``precompute_coeffs`` for the bilinear (triangle) filter and
    its ``normalize_coeffs_8bpc``: each output index's first source index
    ``(n_out,)`` and fixed-point weights ``(n_out, k)``, zero past its
    support. ``k`` is the widest support that occurs, not Pillow's
    ``2 * ceil(support) + 1``: the weights past it are all zero."""
    scale = n_in / n_out
    filterscale = max(scale, 1.0)
    support = 1.0 * filterscale
    center = (np.arange(n_out) + 0.5) * scale
    # C's (int) truncates toward zero; a negative start clamps to 0 anyway
    xmin = np.maximum((center - support + 0.5).astype(np.int64), 0)
    xmax = np.minimum((center + support + 0.5).astype(np.int64), n_in)
    k = max(int((xmax - xmin).max()), 1)
    x = xmin[:, None] + np.arange(k)[None, :]
    w = np.maximum(1.0 - np.abs((x - center[:, None] + 0.5)
                                * (1.0 / filterscale)), 0.0)
    w = np.where(x < xmax[:, None], w, 0.0)
    ww = w.sum(axis=1, keepdims=True)
    w = np.where(ww != 0.0, w / np.where(ww != 0.0, ww, 1.0), w)
    fixed = np.trunc(0.5 + w * (1 << PRECISION_BITS)).astype(np.int32)
    return xmin, fixed


def _resample_rows(x: torch.Tensor, n_out: int) -> torch.Tensor:
    """One of Pillow's two passes, along dim 0 of the contiguous int32 image
    ``x`` (values 0-255): a weighted sum of each output index's taps from
    one half, shifted back by ``PRECISION_BITS`` and clipped to 0-255 (the
    pass's uint8 result, kept in int32). The sum is taken tap by tap in
    int32, as Pillow takes it: the weights are non-negative and sum to about
    ``2**22``, so it stays below ``255 * 2**22 + 2**21 < 2**31``. Gathering
    whole rows keeps each tap a contiguous copy."""
    n_in = x.shape[0]
    xmin, fixed = _bilinear_coeffs(n_in, n_out)
    idx = torch.from_numpy(
        np.minimum(xmin[:, None] + np.arange(fixed.shape[1]), n_in - 1))
    weights = torch.from_numpy(fixed).reshape(
        fixed.shape + (1,) * (x.dim() - 1))
    acc = None
    for t in range(fixed.shape[1]):
        term = x.index_select(0, idx[:, t]).mul_(weights[:, t])
        acc = (term.add_(1 << (PRECISION_BITS - 1)) if acc is None
               else acc.add_(term))
    return acc.bitwise_right_shift_(PRECISION_BITS).clamp_(0, 255)


def resize_uint8(img: np.ndarray, size_hw: Sequence[int]) -> np.ndarray:
    """PIL's ``Image.resize((out_w, out_h), Image.BILINEAR)`` of an 8-bit
    ``(H, W, C)`` image to ``size_hw = (out_h, out_w)``, bit for bit:
    horizontal pass first (on the transposed image), and a pass whose axis
    keeps its size is skipped, as in PIL."""
    h, w = img.shape[:2]
    out_h, out_w = (int(n) for n in size_hw)
    x = torch.from_numpy(np.ascontiguousarray(img)).to(torch.int32)
    if out_w != w:
        x = _resample_rows(x.transpose(0, 1).contiguous(), out_w)
        x = x.transpose(0, 1).contiguous()
    if out_h != h:
        x = _resample_rows(x, out_h)
    return x.to(torch.uint8).numpy()


def resize_image(img: np.ndarray, scale: float) -> np.ndarray:
    """Bilinear resize of a float [0, 1] HWC image by ``scale`` (each side
    rounded), through uint8 as the reference's PIL path does
    (`base.py:84-88`)."""
    h, w = img.shape[:2]
    out = resize_uint8((img * 255).astype(np.uint8),
                       (round(h * scale), round(w * scale)))
    return out.astype(np.float32) / 255.0


def find_voc_root(data_dir: str, year: str = "2007") -> Optional[str]:
    for cand in (os.path.join(data_dir, f"VOC{year}"),
                 os.path.join(data_dir, "VOCdevkit", f"VOC{year}"),
                 data_dir):
        if os.path.isdir(os.path.join(cand, "Annotations")):
            return cand
    return None


def synthetic_det_samples(n: int = 64, num_classes: int = 20, seed: int = 0
                          ) -> List[DetSample]:
    """``afan``'s deterministic synthetic detection set: 1-4 class-colored
    rectangles per 500x375 or 375x500 noise image."""
    rng = np.random.RandomState(seed)
    samples = []
    for i in range(n):
        w, h = (500, 375) if rng.rand() < 0.5 else (375, 500)
        g = rng.randint(1, 5)
        boxes, labels = [], []
        for _ in range(g):
            bw = rng.randint(60, min(w, 220))
            bh = rng.randint(60, min(h, 220))
            x1 = rng.randint(0, w - bw)
            y1 = rng.randint(0, h - bh)
            boxes.append([x1, y1, x1 + bw, y1 + bh])
            labels.append(rng.randint(1, num_classes + 1))
        samples.append(DetSample(
            image_id=f"synth{i:06d}", image_path=None, width=w, height=h,
            boxes=np.asarray(boxes, np.float32),
            labels=np.asarray(labels, np.int64), synthetic_seed=seed + i))
    return samples


def render_synthetic(sample: DetSample) -> np.ndarray:
    """A synthetic sample's image: a class-colored rectangle per box."""
    rng = np.random.RandomState(sample.synthetic_seed)
    img = rng.rand(sample.height, sample.width, 3).astype(np.float32) * 0.3
    for box, label in zip(sample.boxes, sample.labels):
        color = np.asarray([((label * 37) % 255) / 255.0,
                            ((label * 91) % 255) / 255.0,
                            ((label * 151) % 255) / 255.0], np.float32)
        x1, y1, x2, y2 = box.astype(int)
        img[y1:y2, x1:x2] = 0.7 * color + 0.3 * img[y1:y2, x1:x2]
    return img


def load_image(sample: DetSample) -> np.ndarray:
    """float32 [0, 1] HWC image of a synthetic sample; an image on disk (a
    VOC or COCO JPEG) raises."""
    if sample.image_path is not None:
        raise NotImplementedError(f"decoding {sample.image_path} is "
                                  f"{UNPORTED}")
    return render_synthetic(sample)


@dataclass
class DetBatch:
    image_ids: List[str]
    images: np.ndarray       # (B, H, W, 3) float32, bucket-padded
    scales: np.ndarray       # (B,)
    boxes: np.ndarray        # (B, MAX_GT, 4) scaled coords, zero-padded
    labels: np.ndarray       # (B, MAX_GT) int32
    valid: np.ndarray        # (B, MAX_GT) bool


class DetectionLoader:
    """Bucketed epoch iterator (tall vs fat) with a static canvas per
    bucket: fat (min_side, max_side), tall transposed, rounded up to
    ``pad_multiple``."""

    def __init__(self, samples: Sequence[DetSample], batch_size: int,
                 image_min_side: float = 600.0, image_max_side: float = 1000.0,
                 train: bool = True, seed: int = 0, pad_multiple: int = 16):
        self.samples = list(samples)
        self.batch_size = batch_size
        self.min_side = image_min_side
        self.max_side = image_max_side
        self.train = train
        self.rng = np.random.RandomState(seed)
        m = pad_multiple

        def rup(x):
            return int(-(-int(round(x)) // m) * m)

        self.fat_canvas = (rup(image_min_side), rup(image_max_side))
        self.tall_canvas = (rup(image_max_side), rup(image_min_side))

    def __len__(self):
        tall = sum(1 for s in self.samples if s.width / s.height < 1)
        fat = len(self.samples) - tall
        if self.train:
            return tall // self.batch_size + fat // self.batch_size
        return -(-tall // self.batch_size) + -(-fat // self.batch_size)

    def _make_batch(self, idxs: List[int]) -> DetBatch:
        first = self.samples[idxs[0]]
        tall = first.width / first.height < 1
        ch, cw = self.tall_canvas if tall else self.fat_canvas
        bsz = len(idxs)
        images = np.zeros((bsz, ch, cw, 3), np.float32)
        boxes = np.zeros((bsz, MAX_GT_BOXES, 4), np.float32)
        labels = np.zeros((bsz, MAX_GT_BOXES), np.int32)
        valid = np.zeros((bsz, MAX_GT_BOXES), bool)
        scales = np.zeros((bsz,), np.float32)
        ids = []
        for j, i in enumerate(idxs):
            s = self.samples[i]
            img = load_image(s)
            bxs = s.boxes.copy()
            if self.train and self.rng.rand() < 0.5:  # hflip + box flip
                img = img[:, ::-1]
                if len(bxs):
                    x1 = bxs[:, 0].copy()
                    bxs[:, 0] = s.width - bxs[:, 2]
                    bxs[:, 2] = s.width - x1
            scale = compute_scale(s.width, s.height, self.min_side,
                                  self.max_side)
            img = resize_image(img, scale)
            h, w = min(img.shape[0], ch), min(img.shape[1], cw)
            images[j, :h, :w] = img[:h, :w]
            g = min(len(bxs), MAX_GT_BOXES)
            if g:
                boxes[j, :g] = bxs[:g] * scale
                labels[j, :g] = s.labels[:g]
                valid[j, :g] = True
            scales[j] = scale
            ids.append(s.image_id)
        return DetBatch(ids, images, scales, boxes, labels, valid)

    def __iter__(self) -> Iterator[DetBatch]:
        ratios = np.asarray([s.width / s.height for s in self.samples])
        tall = np.nonzero(ratios < 1)[0]
        fat = np.nonzero(ratios >= 1)[0]
        bs = self.batch_size
        if self.train:
            # shuffle within tall/fat, drop remainders, interleave batches
            self.rng.shuffle(tall)
            self.rng.shuffle(fat)
            batches = [tall[i:i + bs] for i in
                       range(0, len(tall) - len(tall) % bs, bs)]
            batches += [fat[i:i + bs] for i in
                        range(0, len(fat) - len(fat) % bs, bs)]
            for k in self.rng.permutation(len(batches)):
                yield self._make_batch(list(batches[k]))
        else:
            # one orientation per batch: the canvas is the first sample's
            for group in (tall, fat):
                for i in range(0, len(group), bs):
                    yield self._make_batch(list(group[i:i + bs]))


def voc_detection_loaders(data_dir: Optional[str], batch_size: int,
                          image_min_side: float = 600.0,
                          image_max_side: float = 1000.0, seed: int = 0):
    """(train_loader, eval_loader, num_classes) on the synthetic VOC stand-in
    (64 train, 16 test images). A VOC tree under ``data_dir`` raises: reading
    it is not ported yet."""
    if data_dir and find_voc_root(data_dir, "2007") is not None:
        raise NotImplementedError(f"reading VOC from {data_dir!r} is "
                                  f"{UNPORTED}")
    train = synthetic_det_samples(64, seed=seed)
    test = synthetic_det_samples(16, seed=seed + 1000)
    return (DetectionLoader(train, batch_size, image_min_side,
                            image_max_side, True, seed),
            DetectionLoader(test, 1, image_min_side, image_max_side, False),
            21)
