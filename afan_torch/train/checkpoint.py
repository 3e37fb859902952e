"""Checkpoint restore with overlap semantics — the PyTorch counterpart of
``afan/train/checkpoint.py:overlap_restore``.

The reference restores full-model checkpoints by partial key overlap and
reports the matched fraction (`Detection/model.py:200-217`). Checkpoints here
are the reference's own layout: a ``torch.save``'d state dict, bare or under
``state_dict`` / ``model_state`` / ``model_state_dict``, keys optionally
prefixed ``module.``.
"""
from __future__ import annotations

from typing import Dict, Mapping

import torch
import torch.nn as nn

_NESTED_KEYS = ("state_dict", "model_state", "model_state_dict")


def load_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """Read a reference-layout checkpoint into a flat CPU state dict."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    for key in _NESTED_KEYS:
        if isinstance(obj, dict) and isinstance(obj.get(key), dict):
            obj = obj[key]
            break
    return {k.replace("module.", "", 1): v for k, v in obj.items()
            if isinstance(v, torch.Tensor)}


def overlap_restore(module: nn.Module,
                    saved: Mapping[str, torch.Tensor]) -> float:
    """Load every entry of ``saved`` whose key exists in ``module``'s state
    dict with the same shape; everything else keeps its initialisation.
    Returns the matched fraction of the module's entries."""
    own = module.state_dict()
    matched = {k: v for k, v in saved.items()
               if k in own and tuple(own[k].shape) == tuple(v.shape)}
    module.load_state_dict(matched, strict=False)
    return len(matched) / max(len(own), 1)
