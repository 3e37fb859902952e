"""Cells of the manifest cut to a size the CPU holds, for the tests."""
from __future__ import annotations

import copy

from benchmark.lib import harness

TINY_CROP, TINY_BATCH = 64, 4


def tiny_seg_cell(name: str = "seg-city-afan-bf16", precision: str = None,
                  variant: str = None) -> harness.Cell:
    """The segmentation cell ``name`` at crop 64, batch 4, a pool of 4
    batches on a 4-cell label grid (``precision`` overrides the
    configuration's, ``variant`` the traffic's)."""
    cell = harness.load_cell(name)
    cfg = copy.deepcopy(cell.config)
    flags = cfg["recipe_flags"]
    flags[flags.index("--crop_size") + 1] = str(TINY_CROP)
    flags[flags.index("--batch_size") + 1] = str(TINY_BATCH)
    cfg.update(crop_size=TINY_CROP, batch_size=TINY_BATCH)
    if precision:
        cfg["precision"] = precision
    cell.config = cfg
    cell.traffic = dict(cell.traffic, pool_batches=4, label_grid=4)
    if variant:
        cell.traffic["variant"] = variant
    return cell


def tiny_det_train_cell(name: str = "det-voc-afan-bf16",
                        precision: str = "float32") -> harness.Cell:
    """The detection training cell on a 160x256 canvas (144x240
    pictures, so the 128-pixel anchors fit), batch 2, 300 proposals before
    NMS and 50 after, 8 box slots, one checked step, in float32
    (``precision`` overrides)."""
    cell = harness.load_cell(name)
    cfg = copy.deepcopy(cell.config)
    cfg.update(image_min_side=160.0, image_max_side=256.0, batch_size=2,
               train_pre_nms_top_n=300, train_post_nms_top_n=50)
    flags = cfg["train"]["recipe_flags"]
    flags[flags.index("--batch_size") + 1] = "2"
    flags += ["--rpn_pre_nms_top_n", "300", "--rpn_post_nms_top_n", "50",
              "--image_min_side", "160", "--image_max_side", "256"]
    if precision != "bfloat16":
        flags.remove("--bf16")
    cfg["train"] = dict(cfg["train"], precision=precision)
    cell.config = cfg
    cell.traffic = dict(cell.traffic, pool_batches=4, image_hw=[144, 240],
                        box_px=[48, 128], max_boxes=8, check_steps=1)
    return cell
