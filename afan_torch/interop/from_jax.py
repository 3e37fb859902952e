"""Carry ``afan``'s Faster R-CNN, DeepLab (ResNet or MobileNetV2, plain or
separable heads) and ResNet-s weights into the port.

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
    return {k: torch.from_numpy(np.array(v))
            for k, v in out.items()}


_CONV_BN = {"conv": 0, "bn": 1}
# ``afan``'s AtrousSeparableConv halves → the reference's ``body`` indices
_SEPARABLE = {"depthwise": ".body.0", "pointwise": ".body.1"}


def _deeplab_head_module(path: Tuple[str, ...], plus: bool) -> str:
    """flax DeepLab classifier module path (under ``classifier``) →
    reference module name (`Segmentation/network/_deeplab.py`)."""
    aspp = "classifier.aspp" if plus else "classifier.classifier.0"
    # the 3x3 conv, its bn and the logits conv of the final classifier
    final = ((0, 1, 3) if plus else (1, 2, 4))
    final = [f"classifier.classifier.{i}" for i in final]
    if path[0] == "project":
        return f"classifier.project.{_CONV_BN[path[1]]}"
    if path[0] == "aspp":
        if path[1] == "pool":
            return f"{aspp}.convs.4.{_CONV_BN[path[2]] + 1}"
        if path[1] == "project":
            return f"{aspp}.project.{_CONV_BN[path[2]]}"
        return f"{aspp}.convs.{int(path[1][1:])}.{_CONV_BN[path[2]]}"
    if path[0] == "classifier":
        if path[1] == "logits":
            return final[2]
        return final[_CONV_BN[path[2]]]
    raise KeyError(f"no port destination for classifier/{'/'.join(path)}")


def deeplab_variables_to_state_dict(variables: Mapping[str, Any],
                                    plus: bool = True
                                    ) -> Dict[str, torch.Tensor]:
    """``afan``'s DeepLab ``{"params", "batch_stats"}`` (nested dicts of
    numpy arrays) → the port's :class:`afan_torch.models.deeplab.DeepLab`
    ``state_dict``: the inverse of
    ``afan/interop/torch_zoo.py:convert_torch_deeplab``, for the ResNet and
    MobileNetV2 backbones (the latter under ``afan``'s own module names) and
    the separable heads (``conv/depthwise``, ``conv/pointwise`` →
    ``body.0``, ``body.1``). Conv kernels HWIO → OIHW (a depthwise
    ``(3, 3, 1, C)`` → ``(C, 1, 3, 3)``); BatchNorm ``scale``, ``bias``,
    ``mean``, ``var`` → ``weight``, ``bias``, ``running_mean``,
    ``running_var``, with
    ``num_batches_tracked``, so the result loads with
    ``load_state_dict(strict=True)``."""
    out: Dict[str, np.ndarray] = {}
    for coll in ("params", "batch_stats"):
        for path, v in _leaves(variables.get(coll, {})):
            leaf = path[-1]
            if path[0] == "backbone":
                mod = "backbone." + _torso_module(path[1:-1])
            elif path[0] == "classifier":
                body = _SEPARABLE.get(path[-2])
                if body is None:
                    mod = _deeplab_head_module(path[1:-1], plus)
                else:
                    mod = _deeplab_head_module(path[1:-2], plus) + body
            else:
                raise KeyError(f"no port destination for {'/'.join(path)}")
            name = ("weight" if leaf in ("kernel", "scale")
                    else _BN_LEAF[leaf])
            out[f"{mod}.{name}"] = _convert(v, leaf)
            if coll == "batch_stats" and leaf == "mean":
                out[f"{mod}.num_batches_tracked"] = np.zeros((), np.int64)
    return {k: torch.from_numpy(np.array(v))
            for k, v in out.items()}


def resnet_s_variables_to_state_dict(variables: Mapping[str, Any]
                                     ) -> Dict[str, torch.Tensor]:
    """``afan``'s ResNet-s ``{"params", "batch_stats"}`` (nested dicts of
    numpy arrays) → the port's :class:`afan_torch.models.resnet_s.ResNetS`
    ``state_dict`` under the reference's ``sequential_model.<i>`` keys
    (``afan/interop/torch_ckpt.py:resnet_s_params_to_torch_sd``), with
    ``num_batches_tracked``, so the result loads with
    ``load_state_dict(strict=True)``. Any tree with the params' structure
    (an optimizer's momentum, say) converts the same way."""
    params = variables.get("params", {})
    fc = 4 + sum(1 for k in params if str(k).startswith("blocks_")) + 2
    out: Dict[str, np.ndarray] = {}
    for coll in ("params", "batch_stats"):
        for path, v in _leaves(variables.get(coll, {})):
            leaf, top = path[-1], path[0]
            if path == ("w",):
                out["w"] = v
                continue
            if top == "conv0":
                mod = "sequential_model.1"
            elif top == "bn0":
                mod = "sequential_model.2"
            elif top == "fc":
                mod = f"sequential_model.{fc}"
            elif top.startswith("blocks_") and len(path) == 3:
                mod = f"sequential_model.{4 + int(top[7:])}.{path[1]}"
            else:
                raise KeyError(f"no port destination for {'/'.join(path)}")
            name = ("weight" if leaf in ("kernel", "scale")
                    else _BN_LEAF[leaf])
            out[f"{mod}.{name}"] = _convert(v, leaf)
            if coll == "batch_stats" and leaf == "mean":
                out[f"{mod}.num_batches_tracked"] = np.zeros((), np.int64)
    return {k: torch.from_numpy(np.array(v))
            for k, v in out.items()}
