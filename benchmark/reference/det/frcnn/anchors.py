"""Anchor generation — a numpy copy of ``afan/models/frcnn/anchors.py``
(port of ``RegionProposalNetwork.generate_anchors``,
`Detection/rpn/region_proposal_network.py:198-228`).

Image and feature sizes are static per canvas, so the model computes the
anchors once per size on the host and keeps them on its device.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np



ANCHOR_RATIOS: Tuple[Tuple[int, int], ...] = ((1, 2), (1, 1), (2, 1))
ANCHOR_SIZES: Tuple[int, ...] = (128, 256, 512)


def generate_anchors(image_width: int, image_height: int,
                     num_x_anchors: int, num_y_anchors: int,
                     ratios: Sequence[Tuple[int, int]] = ANCHOR_RATIOS,
                     sizes: Sequence[int] = ANCHOR_SIZES) -> np.ndarray:
    """(num_y * num_x * len(ratios) * len(sizes), 4) corner anchors.

    Exact reference construction: centers are the interior points of a
    linspace with 2 extra endpoints dropped; meshgrid in 'ij' order with
    ys major (consistent with conv raster order); ratio r = r0/r1 gives
    width = size * sqrt(1/r), height = size * sqrt(r).
    """
    center_ys = np.linspace(0, image_height, num_y_anchors + 2)[1:-1]
    center_xs = np.linspace(0, image_width, num_x_anchors + 2)[1:-1]
    r = np.asarray(ratios, np.float64)
    r = r[:, 0] / r[:, 1]
    s = np.asarray(sizes, np.float64)
    ys, xs, rr, ss = np.meshgrid(center_ys, center_xs, r, s, indexing="ij")
    ys, xs, rr, ss = (a.reshape(-1) for a in (ys, xs, rr, ss))
    widths = ss * np.sqrt(1.0 / rr)
    heights = ss * np.sqrt(rr)
    corners = np.stack([xs - widths / 2, ys - heights / 2,
                        xs + widths / 2, ys + heights / 2], axis=1)
    return corners.astype(np.float32)
