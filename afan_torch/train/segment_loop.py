"""Segmentation train steps — the PyTorch counterpart of
``afan/train/segment_loop.py``: the baseline step (`main_ori.py`), the
flagship A-FAN step (`main_aug_final.py`: SE backbone tap + SD aspp/concat
decoder tap, spectrum, AFN, loss 0.7 clean + 0.1 per adversarial site) and
the eval step.

Every loss site and every ascent site ends in
:func:`afan_torch.ops.resize_ce.fused_resize_nll_sums`, which on the card
runs the hand-written upsample + CE kernels and on the CPU its plain
version. There is no fallback: a kernel that fails raises.

BatchNorm rule (``afan/train/segment_loop.py:9-13``, ``loop.py:16-23``):
every forward of the step normalizes with batch statistics, and the running
statistics are updated once per step, from the clean forward only; every
other forward runs under :func:`frozen_bn_stats`. Each spectrum point runs
its own tail forward, so each gets its own batch statistics, as ``afan``'s
``vmap`` gives them.

Images enter as ``(B, H, W, 3)`` in [0, 1] and labels as ``(B, H, W)``
(255 ignored), on the model's device.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

from ..core.afn import mix_feature
from ..core.attack import pgd, uniform_init
from ..core.spectrum import sample_points
from ..eval.seg_miou import confusion_matrix
from ..models.deeplab.modeling import DeepLab
from ..models.resnet import frozen_bn_stats
from ..ops.resize_ce import IGNORE, fused_resize_nll_sums
from ..ops.resize_ce import per_entry_loss_sums as _per_entry_loss_sums

FOCAL = (1.0, 2.0)      # (alpha, gamma) of seg_focal_loss


def seg_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                      ignore_index: int = IGNORE) -> torch.Tensor:
    """``nn.CrossEntropyLoss(ignore_index=255)``: mean over non-ignored
    pixels of logits ``(B, C, H, W)``."""
    n = (labels != ignore_index).sum().clamp_min(1)
    return _per_entry_loss_sums(logits, labels, False,
                                ignore_index=ignore_index).sum() / n


def seg_focal_loss(logits: torch.Tensor, labels: torch.Tensor,
                   alpha: float = 1.0, gamma: float = 2.0,
                   ignore_index: int = IGNORE) -> torch.Tensor:
    """alpha * (1 - exp(-CE))^gamma * CE, mean over valid pixels (``afan``'s
    reading of `Segmentation/utils/loss.py:5-20`, PARITY.md divergence
    12)."""
    n = (labels != ignore_index).sum().clamp_min(1)
    return _per_entry_loss_sums(logits, labels, True, alpha, gamma,
                                ignore_index).sum() / n


@dataclasses.dataclass(frozen=True)
class SegAfanConfig:
    """The flagship's flags (`main_aug_final.py`; gammas ALREADY /255)."""
    tap_se: int = 2                    # pertub_idx_se (backbone layer)
    sd: Optional[str] = "concat"       # 'aspp' | 'concat' | None
    steps: int = 1
    gamma_se: float = 0.02 / 255
    gamma_sd: float = 1.5 / 255
    eps: float = 2.0 / 255
    spectrum: int = 3
    mix_mask: Sequence[int] = (0, 0, 0)
    mix_sd: bool = False
    noise_sd: float = 0.0
    clean_weight: float = 0.7          # loss = .7 l0 + .1 each (`:229`)
    adv_weight: float = 0.1
    randinit: bool = False
    clip: bool = False
    step_mode: str = "sign"            # 'sign' | 'grad'
    random_steps: bool = False
    use_focal: bool = False
    weight_mode: str = "final"


def _nchw(images: torch.Tensor) -> torch.Tensor:
    return images.permute(0, 3, 1, 2).contiguous()


def _site_loss(labels: torch.Tensor, focal) -> Callable:
    """Mean masked loss of one site's os4 logits ``(k * B, C, h, w)`` per
    group of B entries → ``(k,)``: each site's reference loss is its
    entries' loss sum over the shared valid-pixel count of ``labels``."""
    bsz = labels.shape[0]
    npix = (labels != IGNORE).sum().clamp_min(1)
    size = tuple(labels.shape[1:])

    def site_groups(lo: torch.Tensor) -> torch.Tensor:
        reps = lo.shape[0] // bsz
        tiled = labels.repeat(reps, 1, 1) if reps > 1 else labels
        sums = fused_resize_nll_sums(lo, tiled, size, focal)
        return sums.reshape(reps, bsz).sum(dim=1) / npix

    return site_groups


def make_seg_base_step(model: DeepLab, optimizer: torch.optim.Optimizer,
                       scheduler, use_focal: bool = False):
    """`main_ori.py` baseline step: ``step(images, labels) -> {"loss"}``."""
    focal = FOCAL if use_focal else None

    def step_fn(images: torch.Tensor, labels: torch.Tensor
                ) -> Dict[str, torch.Tensor]:
        model.train()
        site = _site_loss(labels, focal)
        optimizer.zero_grad(set_to_none=True)
        loss = site(model.forward_logits(_nchw(images)))[0]
        loss.backward()
        optimizer.step()
        scheduler.step()
        return {"loss": loss.detach()}

    return step_fn


def make_afan_seg_step(model: DeepLab, optimizer: torch.optim.Optimizer,
                       scheduler, cfg: SegAfanConfig):
    """The flagship A-FAN segmentation step (`main_aug_final.py:152-232`):

    1. one attack-side forward → SE tap feature, low_level and the SD
       decoder feature, all detached;
    2. PGD on SE through the full tail and on SD through the classifier;
    3. optional AFN + noise on SD;
    4. spectrum on SE with AFN per the mix mask;
    5. loss = .7 clean + .1 * each adversarial forward; one SGD update.

    ``step(images, labels, generator=None)`` returns the detached
    ``loss``, ``loss_clean``, ``loss_spectrum`` and ``loss_sd``;
    ``generator`` drives ``randinit``, ``random_steps`` and ``noise_sd``.
    """
    n_spec = cfg.spectrum
    if len(cfg.mix_mask) != n_spec:
        raise ValueError(f"mix_mask {cfg.mix_mask} needs {n_spec} entries")
    if cfg.weight_mode != "final":
        raise NotImplementedError(
            f"weight_mode {cfg.weight_mode!r} is not ported yet")
    focal = FOCAL if cfg.use_focal else None

    def attack(loss_fn, x, gamma, generator):
        return pgd(loss_fn, x, steps=cfg.steps, gamma=gamma, eps=cfg.eps,
                   randinit=cfg.randinit, clip=cfg.clip, generator=generator,
                   step_mode=cfg.step_mode, random_steps=cfg.random_steps)

    def step_fn(images: torch.Tensor, labels: torch.Tensor,
                generator: Optional[torch.Generator] = None
                ) -> Dict[str, torch.Tensor]:
        model.train()
        x = _nchw(images)
        site = _site_loss(labels, focal)

        with frozen_bn_stats(model):
            with torch.no_grad():
                if cfg.sd is not None:
                    feat_se, low_level, sd_dict = model.attack_features(
                        x, cfg.tap_se, cfg.sd)
                else:
                    feat_se, low_level = model.backbone_head(x, cfg.tap_se)

            # the ascent differentiates w.r.t. the feature only, so the
            # detached low_level is exact here
            adv_se = attack(lambda f: site(model.forward_tail_logits(
                f, low_level, cfg.tap_se))[0], feat_se, cfg.gamma_se,
                generator)

            adv_sd = None
            if cfg.sd is not None:
                sd_clean = sd_dict["adv"]
                adv_sd = attack(lambda f: site(model.sd_tail_logits(
                    sd_dict, cfg.sd, f))[0], sd_clean, cfg.gamma_sd,
                    generator)
                if cfg.mix_sd:
                    adv_sd = mix_feature(sd_clean, adv_sd)
                if cfg.noise_sd:
                    adv_sd = adv_sd + uniform_init(
                        adv_sd.shape, cfg.gamma_sd * cfg.noise_sd, generator,
                        adv_sd.dtype, adv_sd.device)

            with torch.no_grad():
                spec = sample_points(feat_se, adv_se, n_spec)
                spec_feats = [mix_feature(feat_se, spec[i])
                              if cfg.mix_mask[i] else spec[i]
                              for i in range(1, n_spec)]

        optimizer.zero_grad(set_to_none=True)
        # The clean forward is the one that updates the running stats. Its
        # low_level stays in the graph: the reference does not detach it,
        # so the spectrum (and aspp SD) tails backprop into stem + layer1.
        out, low_diff = model.backbone_head(x, 4)
        parts = [model.classifier(out, low_diff)]
        with frozen_bn_stats(model):
            parts.append(torch.cat([
                model.forward_tail_logits(f, low_diff, cfg.tap_se)
                for f in spec_feats]))
            if cfg.sd is not None:
                parts.append(model.sd_tail_logits(
                    {"low_level": low_diff}, cfg.sd, adv_sd))
        group = torch.cat([site(p) for p in parts])

        l0 = group[0]
        l_adv = group[1:n_spec].sum()
        l_sd = group[n_spec] if cfg.sd is not None else torch.zeros_like(l0)
        loss = cfg.clean_weight * l0 + cfg.adv_weight * l_adv
        if cfg.sd is not None:
            loss = loss + cfg.adv_weight * l_sd
        loss.backward()
        optimizer.step()
        scheduler.step()
        return {"loss": loss.detach(), "loss_clean": l0.detach(),
                "loss_spectrum": l_adv.detach(), "loss_sd": l_sd.detach()}

    return step_fn


def make_seg_eval_step(model: DeepLab, num_classes: int):
    """Eval forward → (pred labels ``(B, H, W)``, confusion matrix
    ``(C, C)``), both on the model's device (`args.py:168-220`)."""

    @torch.no_grad()
    def eval_fn(images: torch.Tensor, labels: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        model.eval()
        preds = model(_nchw(images)).argmax(dim=1)
        return preds, confusion_matrix(labels, preds, num_classes)

    return eval_fn
