"""Carry ``afan``'s Faster R-CNN weights into the port.

:func:`frcnn_variables_to_state_dict` takes the flax ``{"params",
"batch_stats"}`` tree of ``afan.models.frcnn.FasterRCNN`` as nested dicts of
numpy arrays and returns the port's ``state_dict`` under the reference key
names. It is the inverse of ``afan/interop/torch_zoo.py:convert_torch_frcnn``:
conv kernels HWIO → OIHW, dense kernels (in, out) → (out, in), frozen-BN
leaves ``.../bn/{scale,bias}`` and ``{mean,var}`` → ``weight``, ``bias``,
``running_mean``, ``running_var``. It emits the ``detection.hidden.*`` alias
of ``features.layer4.*`` and ``num_batches_tracked``, so the result loads
with ``load_state_dict(strict=True)``.
"""
from __future__ import annotations

import re
from typing import Any, Dict, Iterator, Mapping, Tuple

import numpy as np
import torch

_BN_LEAF = {"scale": "weight", "bias": "bias", "mean": "running_mean",
            "var": "running_var"}
_HEADS = {
    ("rpn", "trunk"): "rpn._features.0",
    ("rpn", "objectness"): "rpn._anchor_objectness",
    ("rpn", "transformer"): "rpn._anchor_transformer",
    ("roi_pred", "proposal_class"): "detection._proposal_class",
    ("roi_pred", "proposal_transformer"): "detection._proposal_transformer",
}


def _leaves(tree: Mapping[str, Any], prefix: Tuple[str, ...] = ()
            ) -> Iterator[Tuple[Tuple[str, ...], np.ndarray]]:
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, prefix + (str(k),))
        else:
            yield prefix + (str(k),), np.asarray(v)


def _torso_module(path: Tuple[str, ...]) -> str:
    """flax torso module path (FrozenBatchNorm's inner ``bn`` dropped) →
    torchvision module name."""
    names = []
    for m in path:
        if m == "bn":
            continue
        block = re.fullmatch(r"block(\d+)", m)
        if block:
            names.append(block.group(1))
        elif m == "ds_conv":
            names.append("downsample.0")
        elif m == "ds_bn":
            names.append("downsample.1")
        else:
            names.append(m)
    return ".".join(names)


def _convert(value: np.ndarray, leaf: str) -> np.ndarray:
    if leaf != "kernel":
        return value
    if value.ndim == 4:                      # HWIO → OIHW
        return np.transpose(value, (3, 2, 0, 1))
    return np.transpose(value, (1, 0))       # (in, out) → (out, in)


def frcnn_variables_to_state_dict(variables: Mapping[str, Any]
                                  ) -> Dict[str, torch.Tensor]:
    out: Dict[str, np.ndarray] = {}
    for coll in ("params", "batch_stats"):
        for path, v in _leaves(variables.get(coll, {})):
            leaf = path[-1]
            if path[0] == "backbone":
                mod = "features." + _torso_module(path[1:-1])
                name = "weight" if leaf == "kernel" else _BN_LEAF[leaf]
            elif path[:2] in _HEADS:
                mod = _HEADS[path[:2]]
                name = "weight" if leaf == "kernel" else leaf
            else:
                raise KeyError(f"no port destination for {'/'.join(path)}")
            out[f"{mod}.{name}"] = _convert(v, leaf)
            if coll == "batch_stats" and leaf == "mean":
                out[f"{mod}.num_batches_tracked"] = np.zeros((), np.int64)
    for k in [k for k in out if k.startswith("features.layer4.")]:
        out["detection.hidden." + k[len("features.layer4."):]] = out[k]
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in out.items()}
