"""CIFAR-10/100 data pipeline — a copy of ``afan/data/cifar.py`` (pure numpy,
kept here so that the port imports nothing of ``afan``), with the
device-side augmentation written in PyTorch (:func:`augment_batch_device`).

Behavioral port of `Classification/dataset.py:9-55`: 45k/5k train/val split
of the 50k train set plus the 10k test set; train augmentation =
RandomCrop(32, pad=4) + RandomHorizontalFlip (+RandomRotation(15) for
CIFAR-100); images stay in [0,1] — normalization happens inside the model
(`resnet_s.py:104`).

Differences from the reference's torchvision pipeline:

* self-contained readers for both on-disk CIFAR formats (python pickles and
  the binary .bin layout) — no torchvision dependency;
* vectorized numpy augmentation of whole batches (crop offsets/flips drawn
  per sample) instead of per-image PIL transforms — the host must keep one
  CPU core ahead of the accelerator;
* NHWC float32 output, batched and drop_last-ed exactly like the reference
  loaders;
* a deterministic synthetic fallback (:func:`synthetic_arrays`) so tests and
  benchmarks run on machines without the dataset (the reference assumes a
  download).
"""
from __future__ import annotations

import os
import pickle
from typing import Iterator, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F


def _load_pickle_batches(d: str, files) -> Tuple[np.ndarray, np.ndarray]:
    xs, ys = [], []
    for f in files:
        with open(os.path.join(d, f), "rb") as fh:
            entry = pickle.load(fh, encoding="latin1")
        xs.append(np.asarray(entry["data"], np.uint8))
        ys.append(np.asarray(entry.get("labels", entry.get("fine_labels")),
                             np.int64))
    x = np.concatenate(xs).reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
    return x, np.concatenate(ys)


def _load_bin(path: str, label_bytes: int = 1) -> Tuple[np.ndarray, np.ndarray]:
    raw = np.fromfile(path, np.uint8).reshape(-1, label_bytes + 3072)
    y = raw[:, label_bytes - 1].astype(np.int64)
    x = raw[:, label_bytes:].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
    return x, y


def load_cifar(data_dir: str, num_classes: int = 10
               ) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]]:
    """Locate and load CIFAR from ``data_dir`` in any standard layout.

    Returns ``(train_x, train_y, test_x, test_y)`` with uint8 NHWC images,
    or ``None`` if no dataset is found.
    """
    if not data_dir or not os.path.isdir(data_dir):
        return None
    name = "cifar-10-batches-py" if num_classes == 10 else "cifar-100-python"
    for root in (data_dir, os.path.join(data_dir, name)):
        if num_classes == 10 and os.path.exists(os.path.join(root, "data_batch_1")):
            tr = _load_pickle_batches(root, [f"data_batch_{i}" for i in range(1, 6)])
            te = _load_pickle_batches(root, ["test_batch"])
            return tr[0], tr[1], te[0], te[1]
        if num_classes == 100 and os.path.exists(os.path.join(root, "train")):
            tr = _load_pickle_batches(root, ["train"])
            te = _load_pickle_batches(root, ["test"])
            return tr[0], tr[1], te[0], te[1]
    binroot = os.path.join(data_dir, "cifar-10-batches-bin")
    if num_classes == 10 and os.path.exists(os.path.join(binroot, "data_batch_1.bin")):
        xs, ys = zip(*[_load_bin(os.path.join(binroot, f"data_batch_{i}.bin"))
                       for i in range(1, 6)])
        te = _load_bin(os.path.join(binroot, "test_batch.bin"))
        return np.concatenate(xs), np.concatenate(ys), te[0], te[1]
    return None


def synthetic_arrays(num_train: int = 50000, num_test: int = 10000,
                     num_classes: int = 10, seed: int = 0):
    """Deterministic class-structured fake CIFAR for tests/benchmarks.

    Each class gets a fixed random 32x32x3 template; samples are template +
    noise, so a model CAN learn it (loss decreases), unlike pure noise.
    """
    rng = np.random.RandomState(seed)
    templates = rng.randint(0, 256, (num_classes, 32, 32, 3))

    def make(n, seed2):
        r = np.random.RandomState(seed2)
        y = r.randint(0, num_classes, n).astype(np.int64)
        noise = r.randint(-40, 41, (n, 32, 32, 3))
        x = np.clip(templates[y] + noise, 0, 255).astype(np.uint8)
        return x, y

    tr = make(num_train, seed + 1)
    te = make(num_test, seed + 2)
    return tr[0], tr[1], te[0], te[1]


def augment_batch(x: np.ndarray, rng: np.random.RandomState,
                  rotate15: bool = False) -> np.ndarray:
    """RandomCrop(32, padding=4) + RandomHorizontalFlip on a uint8 NHWC batch.

    Vectorized: one padded copy, per-sample gather of crop windows, and a
    flip mask — equivalent in distribution to the torchvision transforms in
    `Classification/dataset.py:11-15,37-40`. ``rotate15`` adds the CIFAR-100
    RandomRotation(15) via nearest-neighbor coordinate rotation.
    """
    n = x.shape[0]
    padded = np.pad(x, ((0, 0), (4, 4), (4, 4), (0, 0)))
    ox = rng.randint(0, 9, n)
    oy = rng.randint(0, 9, n)
    idx = np.arange(32)
    rows = (ox[:, None] + idx)[:, :, None]            # (n, 32, 1)
    cols = (oy[:, None] + idx)[:, None, :]            # (n, 1, 32)
    out = padded[np.arange(n)[:, None, None], rows, cols]
    flip = rng.rand(n) < 0.5
    out[flip] = out[flip, :, ::-1]
    if rotate15:
        angles = rng.uniform(-15, 15, n) * np.pi / 180.0
        cy = cx = 15.5
        yy, xx = np.meshgrid(idx, idx, indexing="ij")
        for i in np.nonzero(np.abs(angles) > 1e-3)[0]:
            c, s = np.cos(angles[i]), np.sin(angles[i])
            sy = np.clip(np.round(cy + (yy - cy) * c - (xx - cx) * s), 0, 31).astype(int)
            sx = np.clip(np.round(cx + (yy - cy) * s + (xx - cx) * c), 0, 31).astype(int)
            out[i] = out[i][sy, sx]
    return out


class CifarLoader:
    """Minimal epoch iterator matching the reference DataLoader behavior
    (shuffle + drop_last for train; sequential for test).

    ``raw=True`` yields un-augmented uint8 batches for DEVICE-SIDE
    augmentation (:func:`augment_batch_device`) — on a host with few CPU
    cores the numpy augmentation caps end-to-end throughput far below the
    card's step rate."""

    def __init__(self, x: np.ndarray, y: np.ndarray, batch_size: int,
                 train: bool, seed: int = 0, rotate15: bool = False,
                 raw: bool = False):
        self.x, self.y = x, y
        self.batch_size = batch_size
        self.train = train
        self.rotate15 = rotate15
        self.raw = raw
        self.rng = np.random.RandomState(seed)

    def __len__(self):
        n = len(self.x)
        return n // self.batch_size if self.train else -(-n // self.batch_size)

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        n = len(self.x)
        order = self.rng.permutation(n) if self.train else np.arange(n)
        nb = len(self)
        for b in range(nb):
            sel = order[b * self.batch_size:(b + 1) * self.batch_size]
            xb = self.x[sel]
            if self.raw:
                yield xb, self.y[sel]
                continue
            if self.train:
                xb = augment_batch(xb, self.rng, self.rotate15)
            yield xb.astype(np.float32) / 255.0, self.y[sel]


def cifar10_dataloaders(train_batch_size: int = 64, test_batch_size: int = 100,
                        data_dir: str = "datasets/cifar10", seed: int = 0,
                        synthetic_fallback: bool = True):
    """45k/5k/10k loaders, API parity with `dataset.py:35-55`."""
    loaded = load_cifar(data_dir, 10)
    if loaded is None:
        if not synthetic_fallback:
            raise FileNotFoundError(f"no CIFAR-10 found under {data_dir!r}")
        loaded = synthetic_arrays(seed=seed)
    tx, ty, ex, ey = loaded
    train = CifarLoader(tx[:45000], ty[:45000], train_batch_size, True, seed)
    val = CifarLoader(tx[45000:], ty[45000:], test_batch_size, False)
    test = CifarLoader(ex, ey, test_batch_size, False)
    return train, val, test


def cifar100_dataloaders(train_batch_size: int = 64, test_batch_size: int = 100,
                         data_dir: str = "datasets/cifar100", seed: int = 0,
                         synthetic_fallback: bool = True):
    """CIFAR-100 variant with the extra RandomRotation(15)
    (`dataset.py:9-32`)."""
    loaded = load_cifar(data_dir, 100)
    if loaded is None:
        if not synthetic_fallback:
            raise FileNotFoundError(f"no CIFAR-100 found under {data_dir!r}")
        loaded = synthetic_arrays(num_classes=100, seed=seed)
    tx, ty, ex, ey = loaded
    train = CifarLoader(tx[:45000], ty[:45000], train_batch_size, True, seed,
                        rotate15=True)
    val = CifarLoader(tx[45000:], ty[45000:], test_batch_size, False)
    test = CifarLoader(ex, ey, test_batch_size, False)
    return train, val, test


def augment_batch_device(x_uint8: torch.Tensor,
                         generator: Optional[torch.Generator] = None
                         ) -> torch.Tensor:
    """RandomCrop(32, pad 4) + RandomHorizontalFlip of a uint8 NHWC batch on
    its own device — the twin of :func:`augment_batch` and of ``afan``'s
    ``augment_batch_device`` (`afan/data/cifar.py:203-221`): the same
    distribution (crop offsets uniform in 0..8 per axis, flip with
    probability 1/2, per sample), drawn from ``generator`` (on the batch's
    device), so not the same draws. Returns float32 in [0, 1]."""
    x = x_uint8.to(torch.float32) / 255.0
    n = x.shape[0]
    dev = x.device
    padded = F.pad(x, (0, 0, 4, 4, 4, 4))
    offsets = torch.randint(0, 9, (n, 2), generator=generator, device=dev)
    idx = torch.arange(32, device=dev)
    rows = (offsets[:, 0, None] + idx)[:, :, None]      # (n, 32, 1)
    cols = (offsets[:, 1, None] + idx)[:, None, :]      # (n, 1, 32)
    out = padded[torch.arange(n, device=dev)[:, None, None], rows, cols]
    flip = torch.rand(n, generator=generator, device=dev) < 0.5
    return torch.where(flip[:, None, None, None], out.flip(2), out)
