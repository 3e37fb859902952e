"""SGD and the segmentation LR schedule — the PyTorch counterpart of
``afan/train/optim.py`` (``poly_schedule``, ``sgd``).

``torch.optim.SGD`` (dampening 0, not Nesterov) applies its update in
optax's order: weight decay added to the gradient, then the momentum trace
(``t = g + momentum * t``, starting from zero), then ``-lr * t``. The
schedule is a :class:`torch.optim.lr_scheduler.LambdaLR` stepped after each
optimizer step, so its count is 0 at the first update, as optax's is.
"""
from __future__ import annotations

from typing import Callable, List, Tuple

import torch

Schedule = Callable[[int], float]


def poly_schedule(base_lr: float, max_steps: int, power: float = 0.9,
                  min_lr: float = 1e-6) -> Schedule:
    """PolyLR (`Segmentation/utils/scheduler.py:8-11`) with its ``min_lr``
    floor: ``max(base_lr * (1 - count / max_steps)^power, min_lr)``."""

    def schedule(count: int) -> float:
        frac = min(max(1.0 - count / max_steps, 0.0), 1.0)
        return max(base_lr * frac ** power, min_lr)

    return schedule


def sgd(param_groups: List[dict], schedule: Schedule, base_lr: float,
        momentum: float = 0.9, weight_decay: float = 0.0
        ) -> Tuple[torch.optim.SGD, torch.optim.lr_scheduler.LambdaLR]:
    """SGD over ``param_groups``, each at ``schedule(count) * lr_scale`` (a
    group's ``lr_scale``, default 1), with the same momentum and weight
    decay on every parameter."""
    groups = [dict(g, lr=base_lr * g.get("lr_scale", 1.0))
              for g in param_groups]
    opt = torch.optim.SGD(groups, lr=base_lr, momentum=momentum,
                          weight_decay=weight_decay)
    sched = torch.optim.lr_scheduler.LambdaLR(
        opt, lambda count: schedule(count) / base_lr)
    return opt, sched
