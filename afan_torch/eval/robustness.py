"""Robustness and analysis evaluations — the PyTorch counterpart of
``afan/eval/robustness.py``:

* classification accuracy under input PGD (:func:`make_robust_eval_step`,
  the reference's ``pgd_validate``);
* detection input PGD (:func:`make_detection_pgd_fn`, ``eval_PGD`` of
  `Detection/attack_algo.py:207-233` for ``Evaluator.ori_rob_evaluate``);
* detection from an interpolated adversarial feature
  (:func:`make_sat_layer_detect_fn`, `Detection/evaluator.py:135-183`);
* the input-space loss surface (:func:`make_input_surface_fn`,
  `Detection/py/evaluator_alp_zzy.py:131-186`);
* weight-space loss probing (:func:`perturb_weight_directions` and
  :func:`loss_landscape_probe`, `Detection/attack_algo.py:296-319` and
  `eval_loss_vis.py`).

Each sign step of an ascent is :func:`afan_torch.core.attack.pgd`'s, so on
the card it runs the hand-written PGD-update kernel at the attacked tensor's
shape; the detection losses run the NMS kernel on their proposals.

The detection functions take a :class:`FasterRCNN` and run on its device.
Their anchor and proposal sampling draws come from the caller's
``generator``: ``afan`` hands one key to every forward of an attack or a
probe, so each forward here starts the generator from the same state, and
draws the same priorities.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.afn import mix_feature
from ..core.attack import pgd, uniform_init
from ..models.frcnn.model import FasterRCNN
from ..models.resnet_s import ResNetS
from ..train.loop import cross_entropy

Detections = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


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


def same_draws(generator: torch.Generator) -> Callable[[], torch.Generator]:
    """A function that returns ``generator`` set back to its state of now:
    every forward that calls it draws the same samples, as every forward of
    ``afan``'s attack draws from one key."""
    state = generator.get_state()

    def rewound() -> torch.Generator:
        generator.set_state(state)
        return generator

    return rewound


def make_detection_pgd_fn(model: FasterRCNN, steps: int = 3,
                          gamma: float = 2.0 / 255, eps: float = 8.0 / 255,
                          randinit: bool = False,
                          bailout_tol: Optional[float] = None):
    """``attack(images, gt_boxes, gt_classes, gt_valid, generator) ->
    adversarial images``: ``eval_PGD`` parity — sign steps of ``gamma`` on
    the NHWC images against the sum of the four training losses, with no
    projection and no final [0, 1] clamp. ``randinit`` starts from a
    uniform draw in ``(-eps, eps)``, taken from ``generator`` before the
    sampling draws."""

    def attack(images: torch.Tensor, gt_boxes: torch.Tensor,
               gt_classes: torch.Tensor, gt_valid: torch.Tensor,
               generator: torch.Generator) -> torch.Tensor:
        start = images
        if randinit:
            start = images + uniform_init(images.shape, eps, generator,
                                          images.dtype, images.device)
        draws = same_draws(generator)
        return pgd(lambda x: model.losses(x, gt_boxes, gt_classes, gt_valid,
                                          draws()).total(),
                   start, steps=steps, gamma=gamma, bailout_tol=bailout_tol)

    return attack


def make_sat_layer_detect_fn(model: FasterRCNN, tap: int, alpha: float,
                             attack_steps: int = 1,
                             gamma: float = 0.9 / 255,
                             eps: float = 2.0 / 255, mix: bool = False):
    """``detect(images, gt_boxes, gt_classes, gt_valid, generator) ->
    (boxes (B, P, C, 4), probs (B, P, C), keep (B, P, C))``: the detached
    feature after layer ``tap``, ``attack_steps`` sign steps of ``gamma``
    on it against the training losses of the tail forward (no projection:
    ``eps`` is not used, as in ``afan``), the feature moved ``alpha`` of
    the way to the adversarial one (``--sat_layer k`` of an N-point
    spectrum is alpha k/(N-1)), with ``mix`` AFN of the interpolated feature
    with the clean feature's statistics — ``mix_feature(interp, feat)``, the
    reference's argument order (`evaluator.py:168-170`), reversed against
    training's — then the tail to layer 3 and the eval detection head
    (:meth:`FasterRCNN.detect_from_features`)."""
    del eps

    def detect(images: torch.Tensor, gt_boxes: torch.Tensor,
               gt_classes: torch.Tensor, gt_valid: torch.Tensor,
               generator: torch.Generator) -> Detections:
        with torch.no_grad():
            feat = model.backbone_head(images, tap)
        draws = same_draws(generator)
        adv = pgd(lambda f: model.losses(images, gt_boxes, gt_classes,
                                         gt_valid, draws(), tap, f).total(),
                  feat, steps=attack_steps, gamma=gamma)
        interp = feat + alpha * (adv - feat)
        if mix:
            interp = mix_feature(interp, feat)
        with torch.no_grad():
            features = model.backbone_tail(interp, tap)
            return model.detect_from_features(features,
                                              tuple(images.shape[1:3]))

    return detect


def rademacher(shape, generator: torch.Generator, device=None
               ) -> torch.Tensor:
    """-1 or 1 per entry: ``where(rand > 0.5, -1, 1)``
    (`py/alp_utils_zzy.py:9-15`)."""
    u = torch.rand(shape, generator=generator, device=device)
    return torch.where(u > 0.5, -1.0, 1.0)


def surface_grid(extent: float, points: int, device=None) -> torch.Tensor:
    """The probe's coordinates: ``arange(-extent, extent,
    2 * extent / points)`` in float32, the upper end left out."""
    step = 2.0 * extent / points
    return -extent + step * torch.arange(points, dtype=torch.float32,
                                         device=device)


def make_input_surface_fn(model: FasterRCNN, extent: float = 0.1,
                          points: int = 40):
    """``surface(images, gt_boxes, gt_classes, gt_valid, generator) -> Z
    (points, points)``: the ALP input-space loss surface
    (`Detection/py/evaluator_alp_zzy.py:131-186`, `py/alp_utils_zzy.py:9-32`)
    — the training losses' sum at the images ``x * r1 + y * r2``, each
    min-max rescaled to [0, 1], where ``r1`` is the sign of the loss's
    gradient at the images and ``r2`` a Rademacher direction (drawn from
    ``generator`` first); ``Z[i, j]`` is the point ``x = grid[j]``,
    ``y = grid[i]`` (:func:`surface_grid`). Every point's forward uses the
    same sampling draws, as ``afan`` passes one key to every point.

    The points run one forward each, in order, as the reference's loop
    does. Where the float32 grid holds 0 exactly (at 4 or 8 points; at 6
    or 40 it misses 0 by 7.45e-9), the centre cell rescales an all-zero
    image, 0 / 0, so its loss is NaN, as in ``afan``; the NaN image sends
    NaN boxes through the proposal NMS."""

    def surface(images: torch.Tensor, gt_boxes: torch.Tensor,
                gt_classes: torch.Tensor, gt_valid: torch.Tensor,
                generator: torch.Generator) -> torch.Tensor:
        r2 = rademacher(images.shape, generator, images.device)
        draws = same_draws(generator)

        def total_loss(x: torch.Tensor) -> torch.Tensor:
            return model.losses(x, gt_boxes, gt_classes, gt_valid,
                                draws()).total()

        x = images.detach().requires_grad_(True)
        with torch.enable_grad():
            (g,) = torch.autograd.grad(total_loss(x), x)
        r1 = torch.sign(g)
        xs = surface_grid(extent, points, images.device)
        z = torch.empty((points, points), dtype=torch.float32,
                        device=images.device)
        with torch.no_grad():
            for i in range(points):
                for j in range(points):
                    new = xs[j] * r1 + xs[i] * r2
                    scaled = (new - new.min()) / (new.max() - new.min())
                    z[i, j] = total_loss(scaled)
        return z

    return surface


def perturb_weight_directions(model: torch.nn.Module,
                              rng: np.random.RandomState
                              ) -> Dict[str, torch.Tensor]:
    """``perturb_weight`` (`Detection/attack_algo.py:296-319`): one
    ``rng.rand`` direction per parameter, all of them divided by their joint
    L2 norm, on the parameters' devices. The parameters are the tensors of
    ``afan``'s ``params`` collection — convolution kernels, dense layers,
    the frozen BatchNorms' scale and bias — each shared tensor once (the
    Faster R-CNN's ``detection.hidden`` is ``features.layer4``); the
    running statistics are buffers, ``afan``'s ``batch_stats``. The draws
    follow the port's parameter order; ``afan`` draws in its own tree order
    and numpy's stream is not shaped by the layouts, so the two never give
    the same directions for one seed (ROADMAP.md: randomness never matches
    across the frameworks)."""
    named = list(model.named_parameters())
    dirs = [rng.rand(*p.shape).astype(np.float32) for _, p in named]
    norm = np.sqrt(sum(float((d ** 2).sum()) for d in dirs))
    # d / norm is float64, as in afan, whose float32 params round it back
    return {name: torch.from_numpy((d / norm).astype(np.float32)).to(
        p.device) for (name, p), d in zip(named, dirs)}


def loss_landscape_probe(loss_fn: Callable[[], torch.Tensor],
                         model: torch.nn.Module,
                         directions: Dict[str, torch.Tensor],
                         scales: Sequence[float]) -> List[float]:
    """`eval_loss_vis.py`: the loss at the weights ``w + s * d`` for each
    scale ``s``, shifting the model's parameters in place; ``loss_fn()``
    evaluates the model as it stands. The weights are restored afterwards
    from a copy, bit for bit."""
    params = dict(model.named_parameters())
    saved = {name: params[name].detach().clone() for name in directions}
    out = []
    try:
        with torch.no_grad():
            for s in scales:
                for name, d in directions.items():
                    params[name].copy_(saved[name] + s * d)
                out.append(float(loss_fn()))
    finally:
        with torch.no_grad():
            for name, w in saved.items():
                params[name].copy_(w)
    return out
