"""Classification train steps — the PyTorch counterpart of
``afan/train/loop.py``: the clean baseline (`Classification/main_base.py`),
ALFA (`main_perturb.py`: feature PGD at one tap), learnable η
(`main_learnable.py`: PGD at 9 taps with a trained per-tap scale) and the
eval step.

Every PGD step of the ascents ends in
:func:`afan_torch.ops.pgd_step.pgd_update` (through
:func:`afan_torch.core.attack.pgd`), which on the card runs the
hand-written PGD-step kernel and on the CPU its plain version. There is no
fallback: a kernel that fails raises.

BatchNorm rule (``afan/train/loop.py:16-23``): every forward of a step
normalizes with batch statistics, and the running statistics are updated
once per step, from the clean full forward; the head, ascent and
adversarial-tail forwards run under :func:`frozen_bn_stats`.

Optimizer: parameters that get no gradient in a step (the η ``w`` outside
the learnable step) get a zero one before ``optimizer.step()``, so weight
decay and momentum move them as optax's ``add_decayed_weights`` does in
``afan``; ``torch.optim.SGD`` would skip them.

Images enter as ``(B, 32, 32, 3)`` in [0, 1] and labels as ``(B,)`` int64,
on the model's device. Steps return detached metric tensors (no host sync)
under ``afan``'s names.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

import torch
import torch.nn.functional as F

from ..core.attack import perturbation_norms, pgd
from ..data.cifar import augment_batch_device
from ..models.resnet import frozen_bn_stats
from ..models.resnet_s import LEARNABLE_TAPS, ResNetS

Metrics = Dict[str, torch.Tensor]


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor
                  ) -> torch.Tensor:
    """Mean softmax cross-entropy (``nn.CrossEntropyLoss``)."""
    return F.cross_entropy(logits, labels)


def accuracy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Top-1 accuracy in percent."""
    return 100.0 * (logits.argmax(dim=-1) == labels).float().mean()


@dataclasses.dataclass(frozen=True)
class AlfaConfig:
    """`main_perturb.py` defaults: tap 13, 5 PGD steps, gamma 1.5/255, eps
    2/255, no randinit or clip (gamma and eps ALREADY divided by 255)."""
    tap: int = 13
    steps: int = 5
    gamma: float = 1.5 / 255
    eps: float = 2.0 / 255
    randinit: bool = False
    clip: bool = False
    step_mode: str = "sign"       # 'sign' | 'grad'
    random_steps: bool = False    # per-step step size in (0, 2 * gamma)


@dataclasses.dataclass(frozen=True)
class LearnableConfig:
    """`main_learnable.py` defaults: 3 PGD steps, gamma 1/255, eps 2/255, 9
    taps, l1_coef 1."""
    taps: Sequence[int] = LEARNABLE_TAPS
    steps: int = 3
    gamma: float = 1.0 / 255
    eps: float = 2.0 / 255
    randinit: bool = False
    clip: bool = False
    l1_coef: float = 1.0


def sum_project(w: torch.Tensor) -> torch.Tensor:
    """Shift η so it sums to 1 (`main_learnable.py:369-378`)."""
    return w - (w.sum() - 1.0) / w.shape[0]


def _nchw(images: torch.Tensor) -> torch.Tensor:
    return images.permute(0, 3, 1, 2).contiguous()


def _update(optimizer: torch.optim.Optimizer, scheduler,
            loss: torch.Tensor) -> None:
    """Backward, a zero gradient for every parameter that got none, one SGD
    step and one schedule step."""
    loss.backward()
    for group in optimizer.param_groups:
        for p in group["params"]:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
    optimizer.step()
    scheduler.step()


def make_base_step(model: ResNetS, optimizer: torch.optim.Optimizer,
                   scheduler):
    """Clean-baseline step (`main_base.py:140-200`):
    ``step(images, labels) -> {"loss", "accuracy"}``."""

    def step_fn(images: torch.Tensor, labels: torch.Tensor) -> Metrics:
        model.train()
        optimizer.zero_grad(set_to_none=True)
        logits = model(_nchw(images))
        loss = cross_entropy(logits, labels)
        _update(optimizer, scheduler, loss)
        return {"loss": loss.detach(),
                "accuracy": accuracy(logits.detach(), labels)}

    return step_fn


def make_alfa_step(model: ResNetS, optimizer: torch.optim.Optimizer,
                   scheduler, cfg: AlfaConfig):
    """ALFA step (`main_perturb.py:153-201`):

    1. clean head forward to the tap, detached;
    2. ``cfg.steps``-step feature PGD through the tail;
    3. loss = (CE(tail(adv)) + CE(full(clean))) / 2;
    4. one SGD update; perturbation L2 / L∞ telemetry.

    ``step(images, labels, generator=None)`` returns ``loss``,
    ``accuracy``, ``pert_l2`` and ``pert_linf``; ``generator`` drives
    ``randinit`` and ``random_steps``.
    """

    def step_fn(images: torch.Tensor, labels: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> Metrics:
        model.train()
        x = _nchw(images)
        with frozen_bn_stats(model):
            with torch.no_grad():
                feat = model.head(x, cfg.tap)
            adv = pgd(lambda f: cross_entropy(model.tail(f, cfg.tap),
                                              labels),
                      feat, steps=cfg.steps, gamma=cfg.gamma, eps=cfg.eps,
                      randinit=cfg.randinit, clip=cfg.clip,
                      generator=generator, step_mode=cfg.step_mode,
                      random_steps=cfg.random_steps)
        norm_l2, norm_linf = perturbation_norms(feat, adv)

        optimizer.zero_grad(set_to_none=True)
        with frozen_bn_stats(model):
            logits_adv = model.tail(adv, cfg.tap)
        logits = model(x)        # the forward that updates the running stats
        loss = (cross_entropy(logits_adv, labels)
                + cross_entropy(logits, labels)) / 2
        _update(optimizer, scheduler, loss)
        return {"loss": loss.detach(),
                "accuracy": accuracy(logits.detach(), labels),
                "pert_l2": norm_l2.mean(), "pert_linf": norm_linf.mean()}

    return step_fn


def make_device_data_alfa_step(model: ResNetS,
                               optimizer: torch.optim.Optimizer, scheduler,
                               cfg: AlfaConfig, batch_size: int):
    """ALFA training from a train split kept on the device (45k images =
    138 MB of uint8): each step gathers its batch from a per-epoch
    permutation, augments it on the device and runs the ALFA step, with no
    host data in the loop. Returns ``step(data_x_uint8, data_y, perm, i,
    generator=None)``; build ``perm`` per epoch with ``torch.randperm`` on
    the device."""
    alfa = make_alfa_step(model, optimizer, scheduler, cfg)

    def step_fn(data_x: torch.Tensor, data_y: torch.Tensor,
                perm: torch.Tensor, i: int,
                generator: Optional[torch.Generator] = None) -> Metrics:
        idx = perm[i * batch_size:(i + 1) * batch_size]
        x = augment_batch_device(data_x[idx], generator)
        return alfa(x, data_y[idx], generator)

    return step_fn


def make_learnable_step(model: ResNetS, optimizer: torch.optim.Optimizer,
                        scheduler, cfg: LearnableConfig):
    """Learnable-η step (`main_learnable.py:202-253`). ``optimizer`` is the
    two-group SGD of :func:`afan_torch.train.optim.learnable_sgd`.

    One prefix forward collects every tapped feature
    (:meth:`StagedModule.multi_head`); PGD runs at each tap without η; the
    loss is (CE(clean) + mean over taps of CE(tail(clean + η_i (adv -
    clean)))) / 2 + l1_coef * |η|_1; after the update η is shifted to sum to
    one. ``step(images, labels, generator=None)`` returns ``loss``,
    ``accuracy``, ``pert_l2`` and ``pert_linf`` (one entry per tap) and
    ``w``.
    """
    taps = tuple(cfg.taps)

    def step_fn(images: torch.Tensor, labels: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> Metrics:
        model.train()
        x = _nchw(images)
        with frozen_bn_stats(model):
            with torch.no_grad():
                clean = model.multi_head(x, taps)
            advs = [pgd(lambda f, tap=tap: cross_entropy(model.tail(f, tap),
                                                         labels),
                        feat, steps=cfg.steps, gamma=cfg.gamma, eps=cfg.eps,
                        randinit=cfg.randinit, clip=cfg.clip,
                        generator=generator)
                    for tap, feat in zip(taps, clean)]
        norms = [perturbation_norms(c, a) for c, a in zip(clean, advs)]

        optimizer.zero_grad(set_to_none=True)
        w = model.w
        loss_adv = 0.0
        with frozen_bn_stats(model):
            for i, tap in enumerate(taps):
                scaled = clean[i] + w[i] * (advs[i] - clean[i])
                loss_adv = loss_adv + cross_entropy(model.tail(scaled, tap),
                                                    labels)
        logits = model(x)        # the forward that updates the running stats
        loss = ((cross_entropy(logits, labels) + loss_adv / len(taps)) / 2
                + cfg.l1_coef * w.abs().sum())
        _update(optimizer, scheduler, loss)
        with torch.no_grad():
            w.copy_(sum_project(w))
        return {"loss": loss.detach(),
                "accuracy": accuracy(logits.detach(), labels),
                "pert_l2": torch.stack([n[0].mean() for n in norms]),
                "pert_linf": torch.stack([n[1].mean() for n in norms]),
                "w": w.detach().clone()}

    return step_fn


def make_eval_step(model: ResNetS):
    """Eval-mode forward and top-1 (`main_perturb.py:227-263`):
    ``eval(images, labels) -> {"loss", "accuracy", "correct", "count"}``."""

    @torch.no_grad()
    def eval_fn(images: torch.Tensor, labels: torch.Tensor) -> Metrics:
        model.eval()
        logits = model(_nchw(images))
        return {"loss": cross_entropy(logits, labels),
                "accuracy": accuracy(logits, labels),
                "correct": (logits.argmax(dim=-1) == labels).sum(),
                "count": torch.tensor(labels.shape[0])}

    return eval_fn
