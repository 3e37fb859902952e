"""PASCAL VOC detection data — the parts of ``afan/data/voc_det.py`` the
detection server uses: the class names, the resize rule and the resize.

``resize_image`` replaces PIL's bilinear resize (the machine with the card
has no PIL) by ``F.interpolate(mode="bilinear", antialias=True)``, which
follows PIL's filter, on the same uint8-quantised image, re-quantised to
uint8.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

VOC_CLASSES = (
    "aeroplane", "bicycle", "bird", "boat", "bottle", "bus", "car", "cat",
    "chair", "cow", "diningtable", "dog", "horse", "motorbike", "person",
    "pottedplant", "sheep", "sofa", "train", "tvmonitor")   # labels 1..20


def compute_scale(width: int, height: int, image_min_side: float,
                  image_max_side: float) -> float:
    """The resize rule of `dataset/base.py:75-86`: shorter side to
    ``image_min_side``, then cap the longer side at ``image_max_side``."""
    scale = image_min_side / min(width, height)
    longer = max(width, height) * scale
    if longer > image_max_side:
        scale *= image_max_side / longer
    return scale


def resize_image(img: np.ndarray, scale: float) -> np.ndarray:
    """Bilinear resize of a float [0, 1] HWC image by ``scale``, through
    uint8 as the reference's PIL path does (`base.py:84-88`)."""
    h, w = img.shape[:2]
    out_h, out_w = round(h * scale), round(w * scale)
    u8 = torch.from_numpy((img * 255).astype(np.uint8))
    x = u8.permute(2, 0, 1)[None].to(torch.float32)
    y = F.interpolate(x, size=(out_h, out_w), mode="bilinear",
                      align_corners=False, antialias=True)
    y = torch.clamp(torch.round(y), 0, 255).to(torch.uint8)
    return y[0].permute(1, 2, 0).numpy().astype(np.float32) / 255.0
