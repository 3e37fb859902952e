"""SAT spectrum feature maps — the PyTorch counterpart of
``afan/eval/feature_vis.py`` (the reference's
`Detection/train_sat_vis.py:129-138` and ``feature_map_save``,
`Detection/attack_algo.py:268-292`): the SE tap feature of a batch, the
feature-PGD ascent, the interpolation spectrum from the clean to the
adversarial feature, and a PNG of each spectrum point's channel-mean heat
map beside the input image, written through :mod:`afan_torch.utils.png`.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from ..core.attack import pgd
from ..core.spectrum import sample_points
from ..models.frcnn.model import FasterRCNN
from ..utils.png import imsave
from .robustness import same_draws


def make_spectrum_features_fn(model: FasterRCNN, tap: int, gamma: float,
                              steps: int, eps: float, n_points: int):
    """``fn(images, gt_boxes, gt_classes, gt_valid, generator) ->
    (n_points, B, h, w, C)``: the spectrum of SE features after layer
    ``tap`` (point 0 clean, point ``n_points - 1`` adversarial), in
    ``afan``'s NHWC layout. The ascent is ``steps`` sign steps of ``gamma``
    against the tail forward's training losses with no projection (``eps``
    is not used, as in ``afan``); every forward draws the same samples
    from ``generator``."""
    del eps

    def fn(images: torch.Tensor, gt_boxes: torch.Tensor,
           gt_classes: torch.Tensor, gt_valid: torch.Tensor,
           generator: torch.Generator) -> torch.Tensor:
        with torch.no_grad():
            feat = model.backbone_head(images, tap)
        draws = same_draws(generator)
        adv = pgd(lambda f: model.losses(images, gt_boxes, gt_classes,
                                         gt_valid, draws(), tap, f).total(),
                  feat, steps=steps, gamma=gamma)
        return sample_points(feat, adv, n_points).permute(0, 1, 3, 4, 2)

    return fn


def save_spectrum_pngs(spectrum, images, image_ids, outdir: str) -> int:
    """Write ``<id>_input.png`` and ``<id>_spec<k>.png`` heat maps, the
    files ``afan`` writes with ``plt.imsave``; returns the file count.
    ``spectrum``: (N, B, h, w, C); ``images``: (B, H, W, 3) in [0, 1]."""
    os.makedirs(outdir, exist_ok=True)
    spectrum = _numpy(spectrum)
    images = _numpy(images)
    n = 0
    for b, image_id in enumerate(image_ids):
        imsave(os.path.join(outdir, f"{image_id}_input.png"),
               np.clip(images[b], 0, 1))
        n += 1
        for k in range(spectrum.shape[0]):
            heat = spectrum[k, b].mean(axis=-1)
            lo, hi = heat.min(), heat.max()
            heat = (heat - lo) / max(hi - lo, 1e-12)
            imsave(os.path.join(outdir, f"{image_id}_spec{k}.png"), heat)
            n += 1
    return n


def _numpy(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)
