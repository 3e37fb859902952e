"""The one generator of the benchmark's inputs, read from a traffic file's
parameters and a seed. Everything is drawn on the device from a
``torch.Generator`` seeded with ``--seed``, in a few large calls.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

IGNORE = 255


def generator(seed: int, device, salt: int = 0) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed((int(seed) * 1000003 + salt) % (2 ** 63))
    return gen


def seg_batches(seed: int, traffic: Dict, batch: int, crop: int,
                classes: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """A pool of ``traffic["pool_batches"]`` training batches: images
    ``(P, B, crop, crop, 3)`` float32 in [0, 1] and labels ``(P, B, crop,
    crop)`` int32. Each label map is a grid of ``traffic["label_grid"]``
    cells a side, each a random class, with a share
    ``traffic["ignore_share"]`` of the cells 255 (ignored); the image takes
    each class's colour (drawn per seed) under smooth and pixel noise, so
    labels and images agree as in a real scene."""
    gen = generator(seed, device, 1)
    n, g = traffic["pool_batches"], traffic["label_grid"]
    cells = torch.randint(0, classes, (n * batch, 1, g, g), generator=gen,
                          device=device)
    ignored = torch.rand((n * batch, 1, g, g), generator=gen,
                         device=device) < traffic["ignore_share"]
    cells = torch.where(ignored, torch.full_like(cells, IGNORE), cells)
    labels = F.interpolate(cells.float(), size=(crop, crop),
                           mode="nearest").to(torch.int32)[:, 0]
    palette = torch.rand((classes + 1, 3), generator=gen, device=device)
    colour = palette[labels.long().clamp_max(classes)]
    smooth = F.interpolate(
        torch.rand((n * batch, 3, g * 2, g * 2), generator=gen,
                   device=device), size=(crop, crop), mode="bilinear",
        align_corners=False).permute(0, 2, 3, 1)
    fine = torch.rand((n * batch, crop, crop, 3), generator=gen,
                      device=device)
    images = (0.6 * colour + 0.25 * smooth + 0.15 * fine).clamp(0.0, 1.0)
    return (images.reshape(n, batch, crop, crop, 3).contiguous(),
            labels.reshape(n, batch, crop, crop).contiguous())


def det_batches(seed: int, traffic: Dict, batch: int, canvas_hw,
                device) -> Tuple[torch.Tensor, ...]:
    """A pool of ``traffic["pool_batches"]`` detection batches on the
    static canvas: images ``(P, B, H, W, 3)`` float32 in [0, 1], each a
    ``traffic["image_hw"]`` picture at the canvas's top left (zeros
    around it), with one to four class-coloured boxes of
    ``traffic["box_px"]`` a side over noise; boxes ``(P, B, G, 4)``,
    classes ``(P, B, G)`` int32 in 1..20 and valid flags ``(P, B, G)``,
    ``G = traffic["max_boxes"]`` slots (VOC's static capacity)."""
    gen = generator(seed, device, 3)
    n, g = traffic["pool_batches"] * batch, traffic["max_boxes"]
    (ih, iw), (ch, cw) = traffic["image_hw"], canvas_hw
    lo, hi = traffic["box_px"]
    img = torch.rand((n, ih, iw, 3), generator=gen, device=device) * 0.3
    yy = torch.arange(ih, device=device).reshape(1, ih, 1)
    xx = torch.arange(iw, device=device).reshape(1, 1, iw)
    count = torch.randint(1, 5, (n,), generator=gen, device=device)
    boxes = torch.zeros((n, g, 4), device=device)
    classes = torch.zeros((n, g), dtype=torch.int32, device=device)
    for k in range(4):
        bw = torch.randint(lo, hi, (n,), generator=gen, device=device)
        bh = torch.randint(lo, hi, (n,), generator=gen, device=device)
        x1 = (torch.rand((n,), generator=gen, device=device)
              * (iw - bw)).long()
        y1 = (torch.rand((n,), generator=gen, device=device)
              * (ih - bh)).long()
        c = torch.randint(1, 21, (n,), generator=gen, device=device)
        colour = torch.rand((n, 1, 1, 3), generator=gen, device=device)
        on = k < count
        inside = ((xx >= x1.reshape(-1, 1, 1))
                  & (xx < (x1 + bw).reshape(-1, 1, 1))
                  & (yy >= y1.reshape(-1, 1, 1))
                  & (yy < (y1 + bh).reshape(-1, 1, 1))
                  & on.reshape(-1, 1, 1))[..., None]
        img = torch.where(inside, 0.7 * colour + 0.3 * img, img)
        boxes[:, k] = torch.stack([x1, y1, x1 + bw, y1 + bh], 1).float() \
            * on[:, None]
        classes[:, k] = (c * on).to(torch.int32)
    valid = torch.arange(g, device=device)[None, :] < count[:, None]
    images = torch.zeros((n, ch, cw, 3), device=device)
    images[:, :ih, :iw] = img
    p = traffic["pool_batches"]
    return (images.reshape(p, batch, ch, cw, 3), boxes.reshape(p, batch, g, 4),
            classes.reshape(p, batch, g), valid.reshape(p, batch, g))
