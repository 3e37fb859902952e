"""COCO 2017 detection data — the PyTorch counterpart of
``afan/data/coco.py`` (`Detection/dataset/coco2017.py` and its person, car
and animal subsets).

As in ``afan``: the 92-entry background-indexed label map (a raw COCO
``category_id`` is its label), subsets renumbered 1..K in subset order,
crowd annotations kept off the training targets but on the sample as
``crowd_boxes`` / ``crowd_labels`` (COCOeval's ignore regions), images
without a non-crowd annotation dropped, COCO's ``xywh`` boxes turned into
corners. The annotation json is parsed with :mod:`json` (no pycocotools).

The parse is cached beside the annotation file as plain arrays under a name
of the port's own, ``<ann>.afan_torch_cache_*.pkl``: ``afan``'s cache
(``<ann>.afan_cache_*.pkl``) pickles ``afan``'s ``DetSample``, and reading it
would import ``afan`` and JAX.

Without ``<data_dir>/COCO/annotations/instances_train2017.json`` the
loaders fall back to ``afan``'s synthetic samples (64 train, 16 test, at
most 20 drawn classes) with the dataset's class count, byte for byte as
``afan``'s. Decoding a COCO image from disk is not ported yet
(:func:`afan_torch.data.voc_det.load_image` raises).
"""
from __future__ import annotations

import hashlib
import json
import os
import pickle
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .voc_det import DetectionLoader, DetSample, synthetic_det_samples

NUM_COCO_CLASSES = 92  # background + 91 category slots (`coco2017.py:39-59`)

PERSON_IDS = (1,)
CAR_IDS = (3,)
ANIMAL_IDS = (16, 17, 18, 19, 20, 21, 22, 23, 24, 25)  # bird..giraffe
SUBSETS = {"coco2017": None, "coco2017person": PERSON_IDS,
           "coco2017car": CAR_IDS, "coco2017animal": ANIMAL_IDS}

_FIELDS = ("image_id", "image_path", "width", "height", "boxes", "labels",
           "crowd_boxes", "crowd_labels")


def cache_path(ann_path: str, image_dir: str,
               keep_ids: Optional[Sequence[int]]) -> str:
    """The port's parse cache of ``ann_path``: the subset and the image
    directory (baked into the samples' paths) are part of its name."""
    tag = "all" if keep_ids is None else "-".join(map(str, keep_ids))
    dir_tag = hashlib.sha1(image_dir.encode()).hexdigest()[:8]
    return f"{ann_path}.afan_torch_cache_{tag}_{dir_tag}.pkl"


def _read_cache(path: str, ann_path: str
                ) -> Optional[Tuple[List[DetSample], int]]:
    try:
        if os.path.getmtime(path) < os.path.getmtime(ann_path):
            return None
        with open(path, "rb") as f:
            cached = pickle.load(f)
        return ([DetSample(**rec) for rec in cached["samples"]],
                cached["num_classes"])
    except Exception:       # absent, stale or unreadable: parse afresh
        return None


def load_coco_samples(ann_path: str, image_dir: str,
                      keep_ids: Optional[Sequence[int]] = None,
                      use_cache: bool = True) -> Tuple[List[DetSample], int]:
    """Parse a COCO instances json into samples; returns (samples,
    num_classes incl. background)."""
    path = cache_path(ann_path, image_dir, keep_ids) if use_cache else None
    if path is not None:
        cached = _read_cache(path, ann_path)
        if cached is not None:
            return cached
    with open(ann_path) as f:
        coco = json.load(f)
    if keep_ids is not None:
        remap = {cid: i + 1 for i, cid in enumerate(keep_ids)}
        num_classes = len(keep_ids) + 1
    else:
        remap = None
        num_classes = NUM_COCO_CLASSES

    anns_by_image: Dict[int, list] = {}
    crowds_by_image: Dict[int, list] = {}
    for a in coco["annotations"]:
        cid = a["category_id"]
        if remap is not None and cid not in remap:
            continue
        table = crowds_by_image if a.get("iscrowd", 0) else anns_by_image
        table.setdefault(a["image_id"], []).append(a)

    def to_arrays(anns):
        boxes, labels = [], []
        for a in anns:
            x, y, w, h = a["bbox"]
            boxes.append([x, y, x + w, y + h])
            labels.append(remap[a["category_id"]] if remap
                          else a["category_id"])
        return (np.asarray(boxes, np.float32).reshape(-1, 4),
                np.asarray(labels, np.int64))

    samples = []
    for im in coco["images"]:
        anns = anns_by_image.get(im["id"], [])
        if not anns:
            continue
        boxes, labels = to_arrays(anns)
        crowd_boxes, crowd_labels = to_arrays(
            crowds_by_image.get(im["id"], []))
        samples.append(DetSample(
            image_id=str(im["id"]),
            image_path=os.path.join(image_dir, im["file_name"]),
            width=im["width"], height=im["height"], boxes=boxes,
            labels=labels, crowd_boxes=crowd_boxes,
            crowd_labels=crowd_labels))
    if path is not None:
        records = [{f: getattr(s, f) for f in _FIELDS} for s in samples]
        try:
            with open(path, "wb") as f:
                pickle.dump({"samples": records, "num_classes": num_classes},
                            f)
        except OSError:
            pass            # a read-only data directory: no cache
    return samples, num_classes


def coco_detection_loaders(data_dir: Optional[str], batch_size: int,
                           image_min_side: float = 800.0,
                           image_max_side: float = 1333.0, seed: int = 0,
                           subset: str = "coco2017"):
    """(train_loader, eval_loader, num_classes); the layout is
    ``<data_dir>/COCO/{annotations,train2017,val2017}``
    (`coco2017.py:66-75`)."""
    keep = SUBSETS[subset]
    root = os.path.join(data_dir or "", "COCO")
    train_ann = os.path.join(root, "annotations", "instances_train2017.json")
    val_ann = os.path.join(root, "annotations", "instances_val2017.json")
    if not os.path.exists(train_ann):
        nc = (len(keep) + 1) if keep else NUM_COCO_CLASSES
        train = synthetic_det_samples(64, num_classes=min(nc - 1, 20),
                                      seed=seed)
        test = synthetic_det_samples(16, num_classes=min(nc - 1, 20),
                                     seed=seed + 1000)
        num_classes = nc
    else:
        train, num_classes = load_coco_samples(
            train_ann, os.path.join(root, "train2017"), keep)
        test, _ = load_coco_samples(
            val_ann, os.path.join(root, "val2017"), keep)
    return (DetectionLoader(train, batch_size, image_min_side,
                            image_max_side, True, seed),
            DetectionLoader(test, 1, image_min_side, image_max_side, False),
            num_classes)
