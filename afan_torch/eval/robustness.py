"""Robust evaluation — the PyTorch counterpart of ``afan/eval/robustness.py``
(`make_robust_eval_step`, `:32-54`): classification accuracy under input PGD
(the reference's ``pgd_validate``).

Each sign step of the ascent is :func:`afan_torch.core.attack.pgd`'s, so on
the card it runs the hand-written PGD-update kernel at the input's shape.
Detection PGD, the SAT-layer evaluation, the input surface and the
weight-direction probe of ``afan``'s module are not ported yet (ROADMAP.md
queue 1).
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from ..core.attack import pgd
from ..models.resnet_s import ResNetS
from ..train.loop import cross_entropy


def make_robust_eval_step(model: ResNetS, num_classes: int, steps: int = 3,
                          gamma: float = 2.0 / 255, eps: float = 8.0 / 255,
                          randinit: bool = True,
                          bailout_tol: Optional[float] = None,
                          generator: Optional[torch.Generator] = None):
    """``eval(images, labels) -> {"correct", "count"}``: ``steps`` sign
    steps of ``gamma`` against the eval-mode model's cross-entropy from a
    uniform start in ``(-eps, eps)`` around the ``(B, 32, 32, 3)`` images
    (``randinit``; drawn from ``generator``), with no projection and no
    clamp, as ``afan``'s; then top-1 on the adversarial images."""

    def eval_fn(images: torch.Tensor, labels: torch.Tensor
                ) -> Dict[str, torch.Tensor]:
        model.eval()

        def logits_of(x: torch.Tensor) -> torch.Tensor:
            logits = model(x.permute(0, 3, 1, 2).contiguous())
            if logits.shape[-1] != num_classes:
                raise ValueError(f"the model has {logits.shape[-1]} classes, "
                                 f"not {num_classes}")
            return logits

        adv = pgd(lambda x: cross_entropy(logits_of(x), labels), images,
                  steps=steps, gamma=gamma, eps=eps, randinit=randinit,
                  generator=generator, bailout_tol=bailout_tol)
        with torch.no_grad():
            correct = (logits_of(adv).argmax(dim=-1) == labels).sum()
        return {"correct": correct,
                "count": torch.tensor(labels.shape[0], dtype=torch.int32)}

    return eval_fn
