"""SGD and its LR schedules — the PyTorch counterpart of
``afan/train/optim.py`` (``multistep_warmup_schedule``,
``warmup_multistep_schedule``, ``poly_schedule``, ``sgd``,
``learnable_tx``).

``torch.optim.SGD`` (dampening 0, not Nesterov) applies its update in
optax's order: weight decay added to the gradient, then the momentum trace
(``t = g + momentum * t``, starting from zero), then ``-lr * t``. The
schedule is a :class:`torch.optim.lr_scheduler.LambdaLR` stepped after each
optimizer step, so its count is 0 at the first update, as optax's is.

:class:`CapturableSGD` is the same update with its step count and lr in
device tensors (:func:`multistep_warmup_schedule_tensor`), so that a CUDA
graph can capture the step: ``torch.optim.SGD`` with a tensor lr calls
``.item()``, and a replayed ``LambdaLR`` would keep the lr of the capture.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Sequence, Tuple

import torch

Schedule = Callable[[int], float]
TensorSchedule = Callable[[torch.Tensor], torch.Tensor]


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


def multistep_warmup_schedule_tensor(base_lr: float,
                                     milestones_steps: Sequence[int],
                                     gamma: float = 0.1,
                                     warmup_steps: int = 0) -> TensorSchedule:
    """:func:`multistep_warmup_schedule` of an int64 count tensor, in tensor
    ops on the count's device (no host sync): the same float64 operations
    in the same order, so it equals the host schedule at every count."""
    milestones = sorted(milestones_steps)

    def schedule(count: torch.Tensor) -> torch.Tensor:
        lr = torch.full_like(count, base_lr, dtype=torch.float64)
        for m in milestones:
            lr = torch.where(count >= m, lr * gamma, lr)
        if warmup_steps > 1:
            warm = torch.clamp_max(
                count.to(torch.float64) * base_lr / (warmup_steps - 1),
                base_lr)
            lr = torch.where(count < warmup_steps, warm, lr)
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


def step_schedule(base_lr: float, step_size: int,
                  gamma: float = 0.1) -> Schedule:
    """StepLR (`Segmentation/main_aug_final.py:87`): ``base_lr *
    gamma^(count // step_size)``."""

    def schedule(count: int) -> float:
        return base_lr * gamma ** (count // step_size)

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


class CapturableSGD(torch.optim.SGD):
    """``torch.optim.SGD`` (dampening 0, not Nesterov) whose step reads its
    lr from ``lr_fn(count)``, ``count`` an int64 tensor on the parameters'
    device that each step advances by one, and runs in ``torch._foreach_*``
    ops alone: no host sync, so a CUDA graph can capture it and every replay
    takes the lr of its own count. The order is optax's and ``SGD``'s:
    weight decay added to the gradient, ``t = g + momentum * t``, ``p -= lr
    * t`` (the last as a product then a difference, where ``SGD`` fuses the
    two: the parameters agree within a rounding of ``lr * t``).

    The momentum buffers are zeros from construction on (``0.9 * 0 + g ==
    g``: the first step equals ``SGD``'s clone of ``g``), so their
    addresses are fixed before any capture. ``state_dict`` is ``SGD``'s,
    its groups' ``lr`` the current one, so checkpoints load into either
    optimizer. Every parameter needs a gradient at each step.
    """

    def __init__(self, params, lr_fn: TensorSchedule, base_lr: float,
                 momentum: float = 0.9, weight_decay: float = 0.0):
        super().__init__(params, lr=base_lr, momentum=momentum,
                         weight_decay=weight_decay)
        self.lr_fn = lr_fn
        first = self.param_groups[0]["params"][0]
        self.count = torch.zeros((), dtype=torch.int64, device=first.device)
        for group in self.param_groups:
            group.setdefault("initial_lr", base_lr)
        self._zero_buffers()

    def _zero_buffers(self) -> None:
        for group in self.param_groups:
            for p in group["params"]:
                if self.state[p].get("momentum_buffer") is None:
                    self.state[p]["momentum_buffer"] = torch.zeros_like(
                        p, memory_format=torch.preserve_format)

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("CapturableSGD takes no closure")
        neg_lr = -self.lr_fn(self.count).to(torch.float32)
        for group in self.param_groups:
            params = group["params"]
            grads = [p.grad for p in params]
            if any(g is None for g in grads):
                raise ValueError("CapturableSGD: a parameter has no "
                                 "gradient")
            bufs = [self.state[p]["momentum_buffer"] for p in params]
            if group["weight_decay"] != 0:
                grads = torch._foreach_add(grads, params,
                                           alpha=group["weight_decay"])
            torch._foreach_mul_(bufs, group["momentum"])
            torch._foreach_add_(bufs, grads)
            torch._foreach_add_(params, torch._foreach_mul(bufs, neg_lr))
        self.count += 1

    def state_dict(self) -> Dict[str, Any]:
        lr = float(self.lr_fn(self.count))      # a host sync, at save time
        for group in self.param_groups:
            group["lr"] = lr
        return super().state_dict()

    def load_state_dict(self, state_dict: Dict[str, Any]) -> None:
        super().load_state_dict(state_dict)
        self._zero_buffers()


class StepCount:
    """The scheduler beside a :class:`CapturableSGD`: the optimizer's step
    advances the count on the device, so :meth:`step` does nothing; the
    count is saved and loaded in ``LambdaLR``'s ``state_dict`` layout
    (``last_epoch`` = steps taken), so that a checkpoint resumes under
    either scheduler."""

    def __init__(self, optimizer: CapturableSGD):
        self.optimizer = optimizer

    def step(self) -> None:
        pass

    def state_dict(self) -> Dict[str, Any]:
        n = int(self.optimizer.count)
        lr = float(self.optimizer.lr_fn(self.optimizer.count))
        groups = self.optimizer.param_groups
        return {"base_lrs": [g["initial_lr"] for g in groups],
                "last_epoch": n, "_step_count": n + 1,
                "_last_lr": [lr] * len(groups),
                "lr_lambdas": [None] * len(groups)}

    def load_state_dict(self, state_dict: Dict[str, Any]) -> None:
        self.optimizer.count.fill_(int(state_dict["last_epoch"]))


def capturable_sgd(params, schedule: TensorSchedule, base_lr: float,
                   momentum: float = 0.9, weight_decay: float = 0.0
                   ) -> Tuple[CapturableSGD, StepCount]:
    """:func:`sgd`'s pair for one group at ``schedule(count)``, with the lr
    and count on the device."""
    opt = CapturableSGD(params, schedule, base_lr, momentum, weight_decay)
    return opt, StepCount(opt)
