"""Observability — the PyTorch port's counterpart of
``afan/utils/observe.py``:

* :class:`ScalarWriter` — always appends JSON lines (``scalars.jsonl``:
  tag, value, step, wall time) and mirrors them to TensorBoard where
  ``torch.utils.tensorboard`` imports, as ``afan``'s does;
* :func:`save_image_panel` — input | target | prediction PNG panels,
  written through :mod:`afan_torch.utils.png` (the machine with the card
  has no PIL);
* :func:`profile_trace` — a :mod:`torch.profiler` trace (host, and the
  card's kernels where there is a card) of a block of steps, written as a
  Chrome trace under a log directory, where ``afan`` writes ``jax.profiler``'s;
* :class:`StepTimer` — samples per second and ETA at ``afan``'s display
  cadence and in its words.
"""
from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Iterator, Optional

import numpy as np
import torch

from .png import write_png


class ScalarWriter:
    """``afan``'s scalar log: ``<logdir>/scalars.jsonl``, one record
    ``{"tag", "value", "step", "ts"}`` per :meth:`add_scalar`, flushed at
    once; with ``use_tensorboard`` also a TensorBoard event file where
    ``torch.utils.tensorboard`` imports (silently none where it does
    not)."""

    def __init__(self, logdir: str, use_tensorboard: bool = True):
        os.makedirs(logdir, exist_ok=True)
        self._f = open(os.path.join(logdir, "scalars.jsonl"), "a")
        self._tb = None
        if use_tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter
                self._tb = SummaryWriter(logdir)
            except Exception:
                self._tb = None

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        self._f.write(json.dumps({"tag": tag, "value": float(value),
                                  "step": int(step),
                                  "ts": time.time()}) + "\n")
        self._f.flush()
        if self._tb is not None:
            self._tb.add_scalar(tag, value, step)

    def close(self) -> None:
        self._f.close()
        if self._tb is not None:
            self._tb.close()


def save_image_panel(path: str, image, target_rgb, pred_rgb) -> None:
    """An input | target | prediction PNG, the reference's visdom image
    panels (`Segmentation/utils/visualizer.py`, `main_aug_final.py:265-275`)
    as a file. ``image``: (H, W, 3) float in [0, 1]; ``target_rgb`` and
    ``pred_rgb``: (H, W, 3) uint8 colour-decoded label maps. The image's
    bytes are ``afan``'s: clipped to [0, 1], times 255, truncated."""
    img = (np.clip(np.asarray(image), 0.0, 1.0) * 255).astype(np.uint8)
    panel = np.concatenate(
        [img, np.asarray(target_rgb), np.asarray(pred_rgb)], axis=1)
    write_png(path, panel)


@contextlib.contextmanager
def profile_trace(logdir: str) -> Iterator[torch.profiler.profile]:
    """Profile the block with :mod:`torch.profiler` (CPU activity, and
    CUDA's where a card is present) and write its Chrome trace to
    ``<logdir>/trace_<pid>_<ms>.json`` when the block ends; yields the
    profiler, whose ``key_averages()`` the caller may read. View the file
    in ``chrome://tracing`` or Perfetto."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(os.path.join(
            logdir, f"trace_{os.getpid()}_{int(time.time() * 1e3)}.json"))


class StepTimer:
    """samples/sec + ETA at a display cadence
    (`Detection/train_aug_final.py:171-179`): :meth:`tick` returns the
    message every ``display_every`` steps, else None."""

    def __init__(self, batch_size: int, total_steps: int,
                 display_every: int = 20):
        self.batch_size = batch_size
        self.total = total_steps
        self.every = display_every
        self._t = time.time()

    def tick(self, step: int) -> Optional[str]:
        if step % self.every:
            return None
        dt = time.time() - self._t
        self._t = time.time()
        sps = self.every / max(dt, 1e-9)
        eta_h = (self.total - step) / max(sps, 1e-9) / 3600
        return (f"{self.batch_size * sps:.2f} samples/sec; "
                f"ETA {eta_h:.1f} hrs")
