"""SGD and its LR schedules — the PyTorch counterpart of
``afan/train/optim.py`` (``multistep_warmup_schedule``,
``warmup_multistep_schedule``, ``poly_schedule``, ``sgd``,
``learnable_tx``).

``torch.optim.SGD`` (dampening 0, not Nesterov) applies its update in
optax's order: weight decay added to the gradient, then the momentum trace
(``t = g + momentum * t``, starting from zero), then ``-lr * t``. The
schedule is a :class:`torch.optim.lr_scheduler.LambdaLR` stepped after each
optimizer step, so its count is 0 at the first update, as optax's is.
"""
from __future__ import annotations

from typing import Callable, List, Sequence, Tuple

import torch

Schedule = Callable[[int], float]


def multistep_warmup_schedule(base_lr: float,
                              milestones_steps: Sequence[int],
                              gamma: float = 0.1,
                              warmup_steps: int = 0) -> Schedule:
    """Epoch-0 linear warmup + multi-step decay, in optimizer steps
    (`Classification/main_perturb.py:76-78,288-293`): ``min(count * base_lr
    / (warmup_steps - 1), base_lr)`` for the first ``warmup_steps`` counts,
    then ``base_lr * gamma^(milestones passed)``."""
    milestones = sorted(milestones_steps)

    def schedule(count: int) -> float:
        lr = base_lr
        for m in milestones:
            if count >= m:
                lr *= gamma
        if warmup_steps > 1 and count < warmup_steps:
            lr = min(count * base_lr / (warmup_steps - 1), base_lr)
        return lr

    return schedule


def warmup_multistep_schedule(base_lr: float,
                              milestones_steps: Sequence[int],
                              gamma: float = 0.1,
                              warmup_factor: float = 1.0 / 3.0,
                              warmup_iters: int = 500) -> Schedule:
    """Detection's WarmUpMultiStepLR (`Detection/extension/lr_scheduler.py:
    13-21`): ``base_lr * gamma^(milestones passed) * (warmup_factor + (1 -
    warmup_factor) * min(count / warmup_iters, 1))``."""
    milestones = sorted(milestones_steps)

    def schedule(count: int) -> float:
        lr = base_lr
        for m in milestones:
            if count >= m:
                lr *= gamma
        alpha = min(count / max(warmup_iters, 1), 1.0)
        return lr * (warmup_factor + (1.0 - warmup_factor) * alpha)

    return schedule


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


def learnable_sgd(model: torch.nn.Module, schedule: Schedule, base_lr: float,
                  w_lr: float = 0.01, momentum: float = 0.9,
                  weight_decay: float = 5e-4
                  ) -> Tuple[torch.optim.SGD,
                             torch.optim.lr_scheduler.LambdaLR]:
    """The learnable-η trainer's two groups (``afan``'s ``learnable_tx``,
    `Classification/main_learnable.py:85-90`): every parameter but ``w``
    under SGD(schedule, momentum, weight_decay); ``w`` under SGD at the
    constant ``w_lr``, the same momentum and no weight decay."""
    rest = [p for n, p in model.named_parameters() if n != "w"]
    opt = torch.optim.SGD(
        [{"params": rest, "weight_decay": weight_decay},
         {"params": [model.w], "lr": w_lr, "weight_decay": 0.0}],
        lr=base_lr, momentum=momentum)
    sched = torch.optim.lr_scheduler.LambdaLR(
        opt, [lambda count: schedule(count) / base_lr, lambda count: 1.0])
    return opt, sched
