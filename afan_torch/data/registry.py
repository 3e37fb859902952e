"""Detection dataset factory — the PyTorch counterpart of
``afan/data/registry.py`` (``DatasetBase.from_name``,
`Detection/dataset/base.py:20-46`): voc2007, voc20072012, voc2007catdog,
coco2017 and its person/car/animal subsets, and ``synthetic``.

Each runs on ``afan``'s synthetic stand-in where its files are absent (VOC:
21 classes; the cat/dog subset: 2 drawn classes, 3 with background; COCO:
:mod:`.coco`). A VOC tree on disk raises: reading it is not ported yet.
"""
from __future__ import annotations

from typing import Optional

from .coco import coco_detection_loaders
from .voc_det import (UNPORTED, DetectionLoader, find_voc_root,
                      synthetic_det_samples, voc_detection_loaders)

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
    if name.startswith("coco"):
        return coco_detection_loaders(data_dir, batch_size, image_min_side,
                                      image_max_side, seed, subset=name)
    if name == "voc2007catdog":
        # `Detection/dataset/voc2007_cat_dog.py`: {bg: 0, cat: 1, dog: 2}
        if data_dir and find_voc_root(data_dir, "2007") is not None:
            raise NotImplementedError(f"reading VOC from {data_dir!r} is "
                                      f"{UNPORTED}")
        train = synthetic_det_samples(64, num_classes=2, seed=seed)
        test = synthetic_det_samples(16, num_classes=2, seed=seed + 1000)
        return (DetectionLoader(train, batch_size, image_min_side,
                                image_max_side, True, seed),
                DetectionLoader(test, 1, image_min_side, image_max_side,
                                False),
                3)
    return voc_detection_loaders(None if name == "synthetic" else data_dir,
                                 batch_size, image_min_side, image_max_side,
                                 seed)
