"""Detection dataset factory — the PyTorch counterpart of
``afan/data/registry.py`` (``DatasetBase.from_name``,
`Detection/dataset/base.py:20-46`). The VOC names and ``synthetic`` run on
the synthetic VOC stand-in; COCO and the cat/dog subset are not ported yet.
"""
from __future__ import annotations

from typing import Optional

from .voc_det import UNPORTED, voc_detection_loaders

DETECTION_DATASETS = ("voc2007", "voc20072012", "voc2007catdog",
                      "coco2017", "coco2017person", "coco2017car",
                      "coco2017animal", "synthetic")


def detection_loaders(name: str, data_dir: Optional[str], batch_size: int,
                      image_min_side: float, image_max_side: float,
                      seed: int = 0):
    """(train_loader, eval_loader, num_classes). The reference's hyphenated
    names ('voc2007-cat-dog', 'coco2017-person', ...) are accepted."""
    name = name.replace("-", "")
    if name not in DETECTION_DATASETS:
        raise ValueError(f"unknown dataset {name!r}; "
                         f"have {DETECTION_DATASETS}")
    if name.startswith("coco") or name == "voc2007catdog":
        raise NotImplementedError(f"dataset {name!r} is {UNPORTED}")
    return voc_detection_loaders(None if name == "synthetic" else data_dir,
                                 batch_size, image_min_side, image_max_side,
                                 seed)
