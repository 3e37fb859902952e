"""Segmentation train steps — the PyTorch counterpart of
``afan/train/segment_loop.py``: the baseline step (`main_ori.py`), the
input-adversarial step (`main_advtrain.py`), the A-FAN family
(`main_aug_final.py`: SE backbone tap + SD aspp/concat decoder tap,
spectrum, AFN, loss 0.7 clean + 0.1 per adversarial site; and its sat and
multi variants: input PGD on the clean term, extra SE taps, the loss
presets) and the eval step.

Every loss site and every ascent site ends in
:func:`afan_torch.ops.resize_ce.fused_resize_nll_sums`, which on the card
runs the hand-written upsample + CE kernels and on the CPU its plain
version; with ``fused_ce=False`` (``--fused_ce off``) in the library's
composition instead, the upsample then the cross-entropy, as ``afan``'s
``fused_ce=False`` sites. There is no fallback: a kernel that fails
raises.

BatchNorm rule (``afan/train/segment_loop.py:9-13``, ``loop.py:16-23``):
every forward of the step normalizes with batch statistics, and the running
statistics are updated once per step, from the forward of the clean loss
term only (of the input-adversarial image where there is one); every other
forward runs under :func:`frozen_bn_stats`. Each spectrum point runs
its own tail forward, so each gets its own batch statistics, as ``afan``'s
``vmap`` gives them.

Images enter as ``(B, H, W, 3)`` in [0, 1] and labels as ``(B, H, W)``
(255 ignored), on the model's device.

Data parallelism (:mod:`afan_torch.parallel.mesh`): inside a group of N
ranks each rank holds its rows of the global batch, and every site's loss
is its entries' summed loss over the valid-pixel count of the *global*
batch (summed over the ranks), so each rank's loss is its share of
``afan``'s and the shares sum to it, however unequally the ignored pixels
fall; the BatchNorm statistics are the global batch's, the gradients are
summed over the ranks before the update, and the reported losses are the
global ones.

Spatial sharding (``--spatial_shards``): a step run inside
:func:`afan_torch.parallel.spatial.sharded` holds its images, labels and
activations row-sharded (:mod:`afan_torch.parallel.spatial`). Each site's
upsample + CE then reads the window of logits rows its label rows need, on
global taps (the kernels' row window); the entry sums stay this rank's
share, over the same world-summed pixel count. The noise (the SD noise,
the random starts) is drawn at the data row's whole shape and sliced.

Under a bfloat16 model (``--bf16``) the step keeps ``afan``'s dtypes: the
image and the input ascent stay float32; the tap features, their ascents
(the PGD-update kernel's bfloat16 path) and the os4 logits of every site are
bfloat16; the upsample + CE kernels read the bfloat16 logits and return
float32 per-entry sums, so the losses and their mix are float32; the SD
noise is drawn in float32 and promotes the SD feature to float32, as
``afan``'s ``uniform_init`` default does (`segment_loop.py:423-424`).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

from ..core.afn import mix_feature
from ..core.attack import input_pgd, pgd, uniform_init
from ..core.spectrum import sample_points
from ..eval.seg_miou import confusion_matrix
from ..models.deeplab.heads import resize_bilinear, resize_window
from ..models.deeplab.modeling import DeepLab
from ..models.resnet import frozen_bn_stats
from ..ops.resize_ce import (IGNORE, fused_resize_nll_sums,
                             resize_window_rows)
from ..ops.resize_ce import per_entry_loss_sums as _per_entry_loss_sums
from ..parallel import spatial
from ..parallel.mesh import global_sum, sum_gradients
from .remat import remat

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
    """The A-FAN family's flags (`main_aug_final.py` and the sat/multi
    variants; gammas ALREADY /255).

    The multi-layer variants (`main_aug_muti_advt.py:180-232`) add
    ``extra_taps``, each with its own gamma and one adversarial point; the
    first tap carries the spectrum. ``input_adv`` trains the clean term on
    an input-PGD image (the ``*_advt`` variants).
    """
    tap_se: int = 2                    # pertub_idx_se (backbone layer)
    extra_taps: Sequence[int] = ()     # multi variants: extra SE taps
    extra_gammas: Sequence[float] = ()
    sd: Optional[str] = "concat"       # 'aspp' | 'concat' | None
    steps: int = 1
    gamma_se: float = 0.02 / 255
    gamma_sd: float = 1.5 / 255
    eps: float = 2.0 / 255
    spectrum: int = 3
    mix_mask: Sequence[int] = (0, 0, 0)
    mix_sd: bool = False
    mix_all: bool = False              # AFN on each extra tap's point too
    noise_sd: float = 0.0
    clean_weight: float = 0.7          # loss = .7 l0 + .1 each (`:229`)
    adv_weight: float = 0.1
    randinit: bool = False
    clip: bool = False
    step_mode: str = "sign"            # 'sign' | 'grad'
    random_steps: bool = False
    use_focal: bool = False
    # 'final' (the .7/.1 rule) | 'sat_preset' (`main_aug_sat_advt.py:
    # 189-200`) | 'multi_preset' (`main_aug_muti_advt.py`), by loss_setting
    weight_mode: str = "final"
    loss_setting: int = 1
    input_adv: bool = False
    input_adv_steps: int = 3
    input_adv_gamma: float = 0.3 / 255
    input_adv_eps: float = 2.0 / 255
    # recompute each spectrum point's tail logits in the backward
    # (``afan``'s ``jax.checkpoint`` of ``one_tail_logits``)
    remat_tails: bool = False


# (clean weight, weight of the sum of the n adversarial terms) per preset
# (``afan/train/segment_loop.py:466-481``)
LOSS_PRESETS = {
    "sat_preset": {1: lambda n: (1.0 / (1 + n), 1.0 / (1 + n)),
                   2: lambda n: (0.5, 0.5 / max(n, 1)),
                   3: lambda n: (0.8, 0.2 / max(n, 1)),
                   4: lambda n: (0.9, 0.1 / max(n, 1))},
    "multi_preset": {1: lambda n: (0.8, 0.2 / max(n, 1)),
                     2: lambda n: (0.6, 0.4 / max(n, 1))},
}


def loss_weights(cfg: SegAfanConfig) -> Tuple[float, float]:
    """(weight of the clean loss, weight of each adversarial loss) of
    ``cfg``'s weight mode."""
    if cfg.weight_mode == "final":
        return cfg.clean_weight, cfg.adv_weight
    if cfg.loss_setting not in LOSS_PRESETS.get(cfg.weight_mode, {}):
        raise ValueError(f"weight_mode {cfg.weight_mode!r} has no "
                         f"loss_setting {cfg.loss_setting}")
    n_adv = (cfg.spectrum - 1) + len(cfg.extra_taps) + (cfg.sd is not None)
    return LOSS_PRESETS[cfg.weight_mode][cfg.loss_setting](n_adv)


def _nchw(images: torch.Tensor) -> torch.Tensor:
    return images.permute(0, 3, 1, 2).contiguous()


def _site_loss(labels: torch.Tensor, focal, fused: bool = True) -> Callable:
    """Mean masked loss of one site's os4 logits ``(k * B, C, h, w)`` per
    group of B entries → ``(k,)``: each site's reference loss is its
    entries' loss sum over the shared valid-pixel count of ``labels``.
    ``fused``: the upsample + CE kernels (on the card); else the library's
    upsample of the logits, then the loss (``afan``'s ``fused_ce=False``
    sites, `segment_loop.py:505-512`)."""
    bsz = labels.shape[0]
    npix = global_sum((labels != IGNORE).sum()).clamp_min(1)
    size = tuple(labels.shape[1:])

    def site_groups(lo: torch.Tensor) -> torch.Tensor:
        reps = lo.shape[0] // bsz
        tiled = labels.repeat(reps, 1, 1) if reps > 1 else labels
        sh = spatial.active()
        window = None
        if sh is not None:
            lo, window = _site_window(sh, lo, size)
        if window is not None and size[0] == 0:
            sums = spatial.no_rows((lo.shape[0],), torch.float32, lo)
        elif fused:
            sums = fused_resize_nll_sums(lo, tiled, size, focal, window)
        else:
            hi = (resize_bilinear(lo, size) if window is None
                  else resize_window_rows(lo, size, window).to(lo.dtype))
            sums = _per_entry_loss_sums(hi, tiled, focal is not None,
                                        *(focal or ()))
        return sums.reshape(reps, bsz).sum(dim=1) / npix

    return site_groups


def _site_window(sh, lo: torch.Tensor, size):
    """Inside a row-sharded step: the rows of a site's row-sharded logits
    that this rank's label rows (``size``) read, and the row window
    ``(hg, Hg, y0, Y0)`` of the upsample + CE."""
    hg = sh.global_height("site logits", lo.shape[2])
    Hg = sh.global_height("site labels", size[0])
    windows = [resize_window(hg, Hg, sh.rows(Hg, r)) for r in range(sh.size)]
    lo = spatial.window_rows(lo, hg, windows, 0.0)
    return lo, (hg, Hg, windows[sh.index][0], sh.rows(Hg).start)


def make_seg_base_step(model: DeepLab, optimizer: torch.optim.Optimizer,
                       scheduler, use_focal: bool = False,
                       fused_ce: bool = True):
    """`main_ori.py` baseline step: ``step(images, labels) -> {"loss"}``."""
    focal = FOCAL if use_focal else None

    def step_fn(images: torch.Tensor, labels: torch.Tensor
                ) -> Dict[str, torch.Tensor]:
        model.train()
        site = _site_loss(labels, focal, fused_ce)
        optimizer.zero_grad(set_to_none=True)
        loss = site(model.forward_logits(_nchw(images)))[0]
        loss.backward()
        sum_gradients(optimizer)
        optimizer.step()
        scheduler.step()
        return {"loss": global_sum(loss.detach())}

    return step_fn


def make_seg_advtrain_step(model: DeepLab, optimizer: torch.optim.Optimizer,
                           scheduler, steps: int = 3,
                           gamma: float = 2.0 / 255, eps: float = 8.0 / 255,
                           randinit: bool = True, fused_ce: bool = True):
    """`main_advtrain.py:185-200`: input PGD (no projection) clamped to
    [0, 1], then one SGD update on the adversarial image's loss alone,
    whose forward updates the running statistics.
    ``step(images, labels, generator=None) -> {"loss"}``; ``generator``
    drives ``randinit``."""

    def step_fn(images: torch.Tensor, labels: torch.Tensor,
                generator: Optional[torch.Generator] = None
                ) -> Dict[str, torch.Tensor]:
        model.train()
        site = _site_loss(labels, None, fused_ce)
        with frozen_bn_stats(model):
            adv = input_pgd(
                lambda im: site(model.forward_logits(_nchw(im)))[0], images,
                steps=steps, gamma=gamma, eps=eps, randinit=randinit,
                generator=generator, row_axis=1)
        optimizer.zero_grad(set_to_none=True)
        loss = site(model.forward_logits(_nchw(adv)))[0]
        loss.backward()
        sum_gradients(optimizer)
        optimizer.step()
        scheduler.step()
        return {"loss": global_sum(loss.detach())}

    return step_fn


def make_afan_seg_step(model: DeepLab, optimizer: torch.optim.Optimizer,
                       scheduler, cfg: SegAfanConfig, fused_ce: bool = True):
    """The A-FAN segmentation step (`main_aug_final.py:152-232` and the
    sat/multi variants):

    0. with ``input_adv``, input PGD (random start, projection) on the
       image; only the clean loss term sees the result;
    1. one attack-side forward → SE tap feature, low_level and the SD
       decoder feature, all detached;
    2. PGD on SE through the full tail, on each extra tap's feature through
       its tail (AFN under ``mix_all``), and on SD through the classifier;
    3. optional AFN + noise on SD;
    4. spectrum on SE with AFN per the mix mask;
    5. loss = the weight mode's mix of the clean and adversarial terms; one
       SGD update. With ``remat_tails`` each spectrum point's tail logits
       are recomputed in the backward (:func:`afan_torch.train.remat.remat`:
       the running statistics stay updated once, the dropout masks are the
       forward's), which changes memory and time, not the step.

    ``step(images, labels, generator=None)`` returns the detached
    ``loss``, ``loss_clean``, ``loss_spectrum`` and ``loss_sd``;
    ``generator`` drives the input ascent's random start, ``randinit``,
    ``random_steps`` and ``noise_sd``. ``fused_ce=False`` runs every site
    through the library's upsample and loss (:func:`_site_loss`).
    """
    n_spec = cfg.spectrum
    if len(cfg.mix_mask) != n_spec:
        raise ValueError(f"mix_mask {cfg.mix_mask} needs {n_spec} entries")
    if len(cfg.extra_gammas) != len(cfg.extra_taps):
        raise ValueError(f"extra_gammas {cfg.extra_gammas} needs one entry "
                         f"per extra tap {cfg.extra_taps}")
    w_clean, w_adv = loss_weights(cfg)
    focal = FOCAL if cfg.use_focal else None

    def attack(loss_fn, x, gamma, generator):
        return pgd(loss_fn, x, steps=cfg.steps, gamma=gamma, eps=cfg.eps,
                   randinit=cfg.randinit, clip=cfg.clip, generator=generator,
                   step_mode=cfg.step_mode, random_steps=cfg.random_steps,
                   row_axis=2)

    def spectrum_tail(feat, low_level):
        """One spectrum point's os4 logits; its upsample + CE stays outside
        the recomputed region, as in ``afan``."""
        if cfg.remat_tails:
            return remat(model.forward_tail_logits, feat, low_level,
                         cfg.tap_se, module=model)
        return model.forward_tail_logits(feat, low_level, cfg.tap_se)

    def step_fn(images: torch.Tensor, labels: torch.Tensor,
                generator: Optional[torch.Generator] = None
                ) -> Dict[str, torch.Tensor]:
        model.train()
        x = _nchw(images)
        site = _site_loss(labels, focal, fused_ce)

        with frozen_bn_stats(model):
            x_l0 = x
            if cfg.input_adv:
                x_l0 = _nchw(input_pgd(
                    lambda im: site(model.forward_logits(_nchw(im)))[0],
                    images, steps=cfg.input_adv_steps,
                    gamma=cfg.input_adv_gamma, eps=cfg.input_adv_eps,
                    randinit=True, clip=True, generator=generator,
                    step_mode=cfg.step_mode, random_steps=cfg.random_steps,
                    row_axis=1))

            with torch.no_grad():
                if cfg.sd is not None:
                    feat_se, low_level, sd_dict = model.attack_features(
                        x, cfg.tap_se, cfg.sd)
                else:
                    feat_se, low_level = model.backbone_head(x, cfg.tap_se)

            # the ascents differentiate w.r.t. the feature only, so the
            # detached low_level is exact here
            def tail_site(tap):
                return lambda f: site(model.forward_tail_logits(
                    f, low_level, tap))[0]

            adv_se = attack(tail_site(cfg.tap_se), feat_se, cfg.gamma_se,
                            generator)

            extra_advs = []
            for tap, gamma in zip(cfg.extra_taps, cfg.extra_gammas):
                with torch.no_grad():
                    f_t = model.backbone_head(x, tap)[0]
                a = attack(tail_site(tap), f_t, gamma, generator)
                extra_advs.append((tap, mix_feature(f_t, a) if cfg.mix_all
                                   else a))
                del f_t

            adv_sd = None
            if cfg.sd is not None:
                sd_clean = sd_dict["adv"]
                adv_sd = attack(lambda f: site(model.sd_tail_logits(
                    sd_dict, cfg.sd, f))[0], sd_clean, cfg.gamma_sd,
                    generator)
                if cfg.mix_sd:
                    adv_sd = mix_feature(sd_clean, adv_sd)
                if cfg.noise_sd:
                    adv_sd = adv_sd + spatial.draw_rows(
                        lambda shape: uniform_init(
                            shape, cfg.gamma_sd * cfg.noise_sd, generator,
                            torch.float32, adv_sd.device), adv_sd.shape, 2)

            with torch.no_grad():
                spec = sample_points(feat_se, adv_se, n_spec)
                spec_feats = [mix_feature(feat_se, spec[i])
                              if cfg.mix_mask[i] else spec[i]
                              for i in range(1, n_spec)]

        optimizer.zero_grad(set_to_none=True)
        # The clean-term forward is the one that updates the running stats.
        # The tails' low_level stays in the graph: the reference does not
        # detach it, so the spectrum, extra-tap (and aspp SD) tails
        # backprop into stem + layer1. It is the clean image's: without
        # input_adv the clean-term forward's own, with it a stem + layer1
        # forward of its own.
        if cfg.input_adv:
            parts = [model.forward_logits(x_l0)]
            with frozen_bn_stats(model):
                low_diff = model.low_level_feature(x)
        else:
            out, low_diff = model.backbone_head(x, 4)
            parts = [model.classifier(out, low_diff)]
        with frozen_bn_stats(model):
            parts.append(torch.cat([spectrum_tail(f, low_diff)
                                    for f in spec_feats]))
            if cfg.sd is not None:
                parts.append(model.sd_tail_logits(
                    {"low_level": low_diff}, cfg.sd, adv_sd))
            parts += [model.forward_tail_logits(a, low_diff, tap)
                      for tap, a in extra_advs]
        group = torch.cat([site(p) for p in parts])

        l0 = group[0]
        l_adv = group[1:n_spec].sum()
        idx = n_spec + (cfg.sd is not None)
        l_sd = group[n_spec] if cfg.sd is not None else torch.zeros_like(l0)
        l_multi = group[idx:].sum()
        loss = w_clean * l0 + w_adv * (l_adv + l_multi + l_sd)
        loss.backward()
        sum_gradients(optimizer)
        optimizer.step()
        scheduler.step()
        return {"loss": global_sum(loss.detach()),
                "loss_clean": global_sum(l0.detach()),
                "loss_spectrum": global_sum(l_adv.detach()),
                "loss_sd": global_sum(l_sd.detach())}

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
