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

:class:`AlfaEpochScan` (:func:`make_epoch_scan_alfa`) is ``afan``'s
``--epoch_scan``: on the card, the device-data ALFA step captured once as a
CUDA graph and replayed for every step, with no Python between steps.

Images enter as ``(B, 32, 32, 3)`` in [0, 1] and labels as ``(B,)`` int64,
on the model's device. Steps return detached metric tensors (no host sync)
under ``afan``'s names.

Data parallelism (:mod:`afan_torch.parallel.mesh`): inside a group of N
ranks each rank runs the step on its rows of the global batch; every loss
it differentiates (the ascents' too) is its share of the global batch's
mean, ``local mean / N`` (the learnable step's η penalty, which belongs to
no row, ``/ N`` as well), the BatchNorm statistics are the global batch's,
the gradients are summed over the ranks before the update, and the
reported metrics are the global batch's. With one rank nothing changes.

Under a bfloat16 model (``--bf16``) the steps keep ``afan``'s dtypes: the
logits, the CE (optax's formula in bfloat16, :func:`cross_entropy`) and the
losses of the base and ALFA steps are bfloat16, the tapped features and
their ascents too (the PGD-update kernel's bfloat16 path); the learnable
step's scaled point ``clean + w_i (adv - clean)`` promotes to float32 with
the float32 η, and its tail casts at each convolution, as in ``afan``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

import torch
import torch.nn.functional as F

from ..core.attack import perturbation_norms, pgd
from ..data.cifar import apply_augment, augment_draws, batch_indices
from ..models.resnet import frozen_bn_stats
from ..models.resnet_s import LEARNABLE_TAPS, ResNetS
from ..ops import lowp
from ..parallel.mesh import global_mean, global_sum, share, sum_gradients
from .optim import CapturableSGD, StepCount

Metrics = Dict[str, torch.Tensor]


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor
                  ) -> torch.Tensor:
    """Mean softmax cross-entropy (``nn.CrossEntropyLoss``). On bfloat16
    logits it is ``afan``'s optax ``softmax_cross_entropy_with_integer_
    labels(...).mean()``: ``logsumexp(logits) - label_logit`` in bfloat16
    at the rounding points of ``afan``'s jitted step
    (:mod:`afan_torch.ops.lowp`), then the float32 mean rounded to
    bfloat16."""
    if logits.dtype in (torch.float32, torch.float64):
        return F.cross_entropy(logits, labels)
    label_logit = logits.gather(-1, labels[:, None])[:, 0]
    return lowp.mean(lowp.logsumexp(logits, -1) - label_logit)


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
    """Backward, a zero gradient for every parameter that got none, the
    gradients summed over the data-parallel ranks, one SGD step and one
    schedule step."""
    loss.backward()
    for group in optimizer.param_groups:
        for p in group["params"]:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
    sum_gradients(optimizer)
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
        loss = share(cross_entropy(logits, labels))
        _update(optimizer, scheduler, loss)
        return {"loss": global_sum(loss.detach()),
                "accuracy": global_mean(accuracy(logits.detach(), labels))}

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
            adv = pgd(lambda f: share(cross_entropy(model.tail(f, cfg.tap),
                                                    labels)),
                      feat, steps=cfg.steps, gamma=cfg.gamma, eps=cfg.eps,
                      randinit=cfg.randinit, clip=cfg.clip,
                      generator=generator, step_mode=cfg.step_mode,
                      random_steps=cfg.random_steps)
        norm_l2, norm_linf = perturbation_norms(feat, adv)

        optimizer.zero_grad(set_to_none=True)
        with frozen_bn_stats(model):
            logits_adv = model.tail(adv, cfg.tap)
        logits = model(x)        # the forward that updates the running stats
        loss = share((cross_entropy(logits_adv, labels)
                      + cross_entropy(logits, labels)) / 2)
        _update(optimizer, scheduler, loss)
        return {"loss": global_sum(loss.detach()),
                "accuracy": global_mean(accuracy(logits.detach(), labels)),
                "pert_l2": global_mean(norm_l2.mean()),
                "pert_linf": global_mean(norm_linf.mean())}

    return step_fn


def make_device_data_alfa_step(model: ResNetS,
                               optimizer: torch.optim.Optimizer, scheduler,
                               cfg: AlfaConfig, batch_size: int,
                               record_augment: bool = False):
    """ALFA training from a train split kept on the device (45k images =
    138 MB of uint8): each step gathers its batch from a per-epoch
    permutation, augments it on the device and runs the ALFA step, with no
    host data in the loop. Returns ``step(data_x_uint8, data_y, perm, i,
    generator=None)``, ``i`` an int or an int64 tensor on the device; build
    ``perm`` per epoch with ``torch.randperm`` on the device. With
    ``record_augment`` the metrics add the step's draws, ``crop`` (B, 2)
    and ``flip`` (B,)."""
    alfa = make_alfa_step(model, optimizer, scheduler, cfg)

    def step_fn(data_x: torch.Tensor, data_y: torch.Tensor,
                perm: torch.Tensor, i,
                generator: Optional[torch.Generator] = None) -> Metrics:
        if not torch.is_tensor(i):
            i = torch.full((), i, dtype=torch.int64, device=perm.device)
        idx = batch_indices(perm, i, batch_size)
        offsets, flip = augment_draws(batch_size, generator, data_x.device)
        x = apply_augment(data_x.index_select(0, idx), offsets, flip)
        metrics = alfa(x, data_y.index_select(0, idx), generator)
        if record_augment:
            metrics.update(crop=offsets, flip=flip)
        return metrics

    return step_fn


# Eager steps before the capture: they are real training steps, and they
# initialise what must not initialise inside a capture (cuDNN's plans, the
# allocator's blocks, the PGD-update library's CUDA runtime and module).
GRAPH_WARMUP_STEPS = 3


class AlfaEpochScan:
    """``afan``'s ``make_epoch_scan_alfa`` (`afan/train/loop.py:193`): one
    call trains one epoch of :func:`make_device_data_alfa_step` steps and
    returns each metric stacked along a leading ``(steps_per_epoch,)`` axis.

    Every step runs one body on static buffers: gather batch ``i`` of the
    epoch's ``perm`` (``i`` an int64 tensor on the device), augment it, the
    ALFA step with a :class:`CapturableSGD` (its device count is the step
    count and sets the lr), the metrics written into row ``i``, ``i + 1``.
    On a CPU tensor the body runs eagerly at every step. On the card the
    first :data:`GRAPH_WARMUP_STEPS` steps run it eagerly on a side stream;
    the next step captures it with ``torch.cuda.graph`` and every
    step from there, in this epoch and the later ones, is a replay. The
    host copies ``perm`` into its buffer and zeroes ``i`` once per epoch,
    and does nothing between replays. A failed capture raises; nothing
    falls back to eager steps.

    Gradients are set to None inside the body (the step's
    ``zero_grad(set_to_none=True)``), so the capture allocates them, with
    every other temporary, in the graph's private pool, at the addresses
    every replay writes. The run's generator is registered with the graph,
    so each replay draws anew from it: the random start, and under
    ``random_steps`` the step sizes, which the PGD-update kernel reads on
    the card. ``data_x``, ``data_y`` and the
    generator must be the first call's. ``eager_steps`` and ``replays``
    count the steps run each way.
    """

    def __init__(self, model: ResNetS, optimizer: CapturableSGD,
                 cfg: AlfaConfig, batch_size: int, steps_per_epoch: int,
                 record_augment: bool = False):
        if not isinstance(optimizer, CapturableSGD):
            raise TypeError("an epoch scan needs a CapturableSGD, whose lr "
                            "lives on the device")
        self.step = make_device_data_alfa_step(
            model, optimizer, StepCount(optimizer), cfg, batch_size,
            record_augment)
        self.batch_size = batch_size
        self.steps_per_epoch = steps_per_epoch
        self.record_augment = record_augment
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.eager_steps = 0
        self.replays = 0
        self._static: Optional[dict] = None
        self._stream: Optional[torch.cuda.Stream] = None

    def _buffers(self, data_x, data_y, perm, generator) -> dict:
        dev = perm.device
        n, b = self.steps_per_epoch, self.batch_size
        rows = {k: torch.zeros(n, dtype=torch.float32, device=dev)
                for k in ("loss", "accuracy", "pert_l2", "pert_linf")}
        if self.record_augment:
            rows["crop"] = torch.zeros(n, b, 2, dtype=torch.int64,
                                       device=dev)
            rows["flip"] = torch.zeros(n, b, dtype=torch.bool, device=dev)
        return {"data_x": data_x, "data_y": data_y, "generator": generator,
                "perm": perm.clone(), "rows": rows,
                "i": torch.zeros((), dtype=torch.int64, device=dev)}

    def _body(self) -> None:
        st = self._static
        metrics = self.step(st["data_x"], st["data_y"], st["perm"], st["i"],
                            st["generator"])
        for k, row in st["rows"].items():
            row.index_copy_(0, st["i"].view(1),
                            metrics[k].to(row.dtype).unsqueeze(0))
        st["i"].add_(1)

    def _eager_on_side_stream(self) -> None:
        self._stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(self._stream):
            self._body()
        torch.cuda.current_stream().wait_stream(self._stream)
        self.eager_steps += 1

    def _capture(self) -> None:
        graph = torch.cuda.CUDAGraph()
        generator = self._static["generator"]
        if generator is not None:
            graph.register_generator_state(generator)
        with torch.cuda.graph(graph, stream=self._stream):
            self._body()
        self.graph = graph

    def _replay(self) -> None:
        self.graph.replay()
        self.replays += 1

    def __call__(self, data_x: torch.Tensor, data_y: torch.Tensor,
                 perm: torch.Tensor,
                 generator: Optional[torch.Generator] = None) -> Metrics:
        st = self._static
        if st is None:
            st = self._static = self._buffers(data_x, data_y, perm,
                                              generator)
        else:
            if (data_x is not st["data_x"] or data_y is not st["data_y"]
                    or generator is not st["generator"]):
                raise ValueError("an epoch scan runs on the data tensors and "
                                 "the generator of its first call")
            st["perm"].copy_(perm)
        st["i"].zero_()
        if perm.device.type != "cuda":
            for _ in range(self.steps_per_epoch):
                self._body()
        else:
            if self._stream is None:
                self._stream = torch.cuda.Stream(perm.device)
            for _ in range(self.steps_per_epoch):
                if self.graph is not None:
                    self._replay()
                elif self.eager_steps < GRAPH_WARMUP_STEPS:
                    self._eager_on_side_stream()
                else:
                    self._capture()
                    self._replay()
        return {k: v.clone() for k, v in st["rows"].items()}


def make_epoch_scan_alfa(model: ResNetS, optimizer: CapturableSGD,
                         cfg: AlfaConfig, batch_size: int,
                         steps_per_epoch: int,
                         record_augment: bool = False) -> AlfaEpochScan:
    """``epoch_fn(data_x_uint8, data_y, perm, generator) -> metrics``, each
    metric with a leading ``(steps_per_epoch,)`` axis
    (:class:`AlfaEpochScan`)."""
    return AlfaEpochScan(model, optimizer, cfg, batch_size, steps_per_epoch,
                         record_augment)


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
            advs = [pgd(lambda f, tap=tap: share(cross_entropy(
                            model.tail(f, tap), labels)),
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
                # the float32 η promotes a bfloat16 point, as in afan
                scaled = clean[i].float() + w[i] * (advs[i]
                                                    - clean[i]).float()
                loss_adv = loss_adv + cross_entropy(model.tail(scaled, tap),
                                                    labels)
        logits = model(x)        # the forward that updates the running stats
        loss = (share((cross_entropy(logits, labels)
                       + loss_adv / len(taps)) / 2)
                + share(cfg.l1_coef * w.abs().sum()))
        _update(optimizer, scheduler, loss)
        with torch.no_grad():
            w.copy_(sum_project(w))
        return {"loss": global_sum(loss.detach()),
                "accuracy": global_mean(accuracy(logits.detach(), labels)),
                "pert_l2": global_mean(
                    torch.stack([n[0].mean() for n in norms])),
                "pert_linf": global_mean(
                    torch.stack([n[1].mean() for n in norms])),
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
