"""Checkpoints with overlap restore — the PyTorch counterpart of
``afan/train/checkpoint.py``.

The reference restores full-model checkpoints by partial key overlap and
reports the matched fraction (`Detection/model.py:200-217`). Checkpoints here
are the reference's own layout: a ``torch.save``'d state dict, bare or under
``state_dict`` / ``model_state`` / ``model_state_dict``, keys optionally
prefixed ``module.``. A training checkpoint is the reference's dict for its
stack: for segmentation (:func:`save_checkpoint`) ``model_state``,
``optimizer_state``, ``scheduler_state``, ``cur_itrs`` and ``best_score``;
for classification (:func:`save_classify_checkpoint`,
`Classification/main_perturb.py:116-136`) ``epoch``, ``state_dict``,
``optimizer``, ``scheduler``, ``step`` and ``best_prec1``; for detection
(:func:`save_detect_checkpoint`, `Detection/model.py:189-199`)
``state_dict``, ``step``, ``optimizer_state_dict`` and
``scheduler_state_dict``.
"""
from __future__ import annotations

import os
from typing import Any, Dict, Mapping, Tuple

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


def restore_pretrained_backbone(backbone: nn.Module, path: str
                                ) -> Tuple[float, float]:
    """Overlap-load a torchvision-keyed state dict (``module.`` stripped)
    into ``backbone``, as ``afan``'s ``--pretrained_backbone`` does with
    ``load_torchvision_backbone`` and ``overlap_restore``: an entry loads
    where the key and the shape match. Returns the matched fractions of the
    backbone's parameters and of its running statistics (means and
    variances), ``afan``'s two logged fractions."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    saved = {k.replace("module.", ""): v for k, v in obj.items()}
    own = backbone.state_dict()
    params = {k for k, _ in backbone.named_parameters()}
    stats = {k for k in own if k.endswith(("running_mean", "running_var"))}
    matched = {k: v for k, v in saved.items()
               if k in own and tuple(own[k].shape) == tuple(v.shape)}
    backbone.load_state_dict(matched, strict=False)
    return (len(params & set(matched)) / max(len(params), 1),
            len(stats & set(matched)) / max(len(stats), 1))


def save_checkpoint(path: str, model: nn.Module,
                    optimizer: torch.optim.Optimizer, scheduler,
                    cur_itrs: int, best_score: float) -> str:
    """Write a segmentation training checkpoint (:func:`_write`)."""
    return _write(path, {"cur_itrs": cur_itrs,
                         "model_state": model.state_dict(),
                         "optimizer_state": optimizer.state_dict(),
                         "scheduler_state": scheduler.state_dict(),
                         "best_score": best_score})


def save_classify_checkpoint(path: str, model: nn.Module,
                             optimizer: torch.optim.Optimizer, scheduler,
                             epoch: int, step: int, best_prec1: float) -> str:
    """Write a classification training checkpoint (:func:`_write`); its
    ``state_dict`` keeps the reference's keys."""
    return _write(path, {"epoch": epoch, "state_dict": model.state_dict(),
                         "optimizer": optimizer.state_dict(),
                         "scheduler": scheduler.state_dict(), "step": step,
                         "best_prec1": best_prec1})


def save_detect_checkpoint(path: str, model: nn.Module,
                           optimizer: torch.optim.Optimizer, scheduler,
                           step: int) -> str:
    """Write a detection training checkpoint (:func:`_write`)."""
    return _write(path, {"state_dict": model.state_dict(), "step": step,
                         "optimizer_state_dict": optimizer.state_dict(),
                         "scheduler_state_dict": scheduler.state_dict()})


def restore_optimizer(optimizer: torch.optim.Optimizer,
                      saved: Mapping[str, Any]) -> bool:
    """Load a saved optimizer state (momentum, lr) into ``optimizer``; on a
    structure mismatch keep the fresh state and return False, as ``afan``'s
    ``restore_opt_state`` does."""
    try:
        optimizer.load_state_dict(saved)
    except ValueError:
        return False
    return True


def _write(path: str, payload: Dict[str, Any]) -> str:
    """``torch.save`` to a temporary file renamed into place, so that a
    crash mid-write leaves the previous checkpoint intact."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = f"{path}.tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)
    return path


def load_training_state(path: str) -> Dict[str, Any]:
    """The whole dict of a training checkpoint (tensors on the CPU); its
    model weights also load through :func:`load_checkpoint`."""
    return torch.load(path, map_location="cpu", weights_only=True)
