"""Detection dataset factory — the PyTorch counterpart of
``afan/data/registry.py`` (``DatasetBase.from_name``,
`Detection/dataset/base.py:20-46`): voc2007, voc20072012, voc2007catdog,
coco2017 and its person/car/animal subsets, and ``synthetic``.

Each reads its tree on disk where it is there and runs on ``afan``'s
synthetic stand-in where it is absent (VOC: 21 classes; the cat/dog subset:
2 drawn classes, 3 with background; COCO: :mod:`.coco`).
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np

from .coco import coco_detection_loaders
from .voc_det import (VOC_LABELS, DetectionLoader, DetSample, find_voc_root,
                      load_voc_samples, synthetic_det_samples,
                      voc_detection_loaders)

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
        root = find_voc_root(data_dir, "2007") if data_dir else None
        if root is None:
            train = synthetic_det_samples(64, num_classes=2, seed=seed)
            test = synthetic_det_samples(16, num_classes=2, seed=seed + 1000)
        else:
            train = cat_dog(load_voc_samples(root, "trainval"))
            test = cat_dog(load_voc_samples(root, "test"))
        return (DetectionLoader(train, batch_size, image_min_side,
                                image_max_side, True, seed),
                DetectionLoader(test, 1, image_min_side, image_max_side,
                                False),
                3)
    if name == "synthetic":
        return voc_detection_loaders(None, batch_size, image_min_side,
                                     image_max_side, seed)
    return voc_detection_loaders(data_dir, batch_size, image_min_side,
                                 image_max_side, seed, dataset=name)


CAT_DOG = {VOC_LABELS["cat"]: 1, VOC_LABELS["dog"]: 2}


def cat_dog(samples: List[DetSample]) -> List[DetSample]:
    """The samples with a cat or a dog among their training objects, every
    other object dropped from the training and the eval boxes, and the two
    relabelled 1 and 2 (``afan/data/registry.py:42-60``)."""
    out = []
    for s in samples:
        m = np.isin(s.labels, list(CAT_DOG))
        if not m.any():
            continue
        s.boxes = s.boxes[m]
        s.labels = np.asarray([CAT_DOG[int(v)] for v in s.labels[m]])
        if s.eval_labels is not None:
            em = np.isin(s.eval_labels, list(CAT_DOG))
            s.eval_boxes = s.eval_boxes[em]
            s.eval_labels = np.asarray([CAT_DOG[int(v)]
                                        for v in s.eval_labels[em]])
            s.eval_difficult = s.eval_difficult[em]
        out.append(s)
    return out
