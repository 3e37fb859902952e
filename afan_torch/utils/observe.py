"""Image panels — the PyTorch port's counterpart of ``save_image_panel`` in
``afan/utils/observe.py:53-68``, written through :mod:`afan_torch.utils.png`
(the machine with the card has no PIL). ``afan``'s scalar writer, profiler
trace and step timer are not ported yet (ROADMAP.md, queue 1, item 9).
"""
from __future__ import annotations

import numpy as np

from .png import write_png


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
