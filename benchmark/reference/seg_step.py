"""Plain reference of the segmentation train steps the benchmark times:
the A-FAN step (SE tap ascent through the tail, SD 'concat' ascent
through the classifier, AFN, the 3-point spectrum, loss 0.7 clean + 0.1
per adversarial term) and the baseline step, each one SGD update (momentum
0.9, weight decay, poly lr, the backbone at a tenth of the lr).

Every upsample + CE site is written out (the float32 upsample of the
logits, then the masked per-entry sums) and every PGD update is
``x + gamma * sign(g)`` in the feature's dtype, with ``gamma`` rounded to
that dtype first (JAX's weak typing, which the port keeps). The order of
the forwards is the step's, so a global generator seeded alike draws the
same dropout masks.
"""
from __future__ import annotations

from typing import Callable, Dict

import numpy as np
import torch
import torch.nn.functional as F

from .seg_model import DeepLabV3Plus, frozen_bn_stats

IGNORE = 255


def weak_scalar(value: float, dtype: torch.dtype) -> float:
    return torch.tensor(float(value), dtype=dtype).item()


def _taps(n_out: int, n_in: int, device) -> torch.Tensor:
    """The ``(n_out, n_in)`` matrix of ``align_corners=False`` linear
    interpolation, with torch's float32 source index (clamped at 0; the
    upper tap clamped at the last row)."""
    scale = np.float32(n_in) / np.float32(n_out)
    src = (np.float64(scale) * (np.arange(n_out) + 0.5) - 0.5)
    src = np.maximum(src.astype(np.float32), np.float32(0.0))
    i0 = np.minimum(src.astype(np.int64), n_in - 1)
    i1 = np.minimum(i0 + 1, n_in - 1)
    l1 = src - i0.astype(np.float32)
    w = np.zeros((n_out, n_in), np.float32)
    np.add.at(w, (np.arange(n_out), i0), np.float32(1.0) - l1)
    np.add.at(w, (np.arange(n_out), i1), l1)
    return torch.from_numpy(w).to(device)


class _Upsample(torch.autograd.Function):
    """``F.interpolate`` (bilinear, ``align_corners=False``) whose backward
    on the card is the transposed interpolation as two matrix products,
    which sum in a fixed order (the library's backward adds with atomics,
    so two runs of it differ); on the CPU, or with ``fixed_order`` off,
    the library's own backward."""

    @staticmethod
    def forward(ctx, lo, size, fixed_order=True):
        ctx.save_for_backward(lo)
        ctx.size, ctx.fixed_order = size, fixed_order
        return F.interpolate(lo, size=size, mode="bilinear",
                             align_corners=False)

    @staticmethod
    def backward(ctx, g):
        (lo,) = ctx.saved_tensors
        if not (g.is_cuda and ctx.fixed_order):
            with torch.enable_grad():
                x = lo.detach().requires_grad_(True)
                (d,) = torch.autograd.grad(F.interpolate(
                    x, size=ctx.size, mode="bilinear", align_corners=False),
                    x, g)
            return d, None, None
        wh = _taps(ctx.size[0], lo.shape[2], g.device)
        ww = _taps(ctx.size[1], lo.shape[3], g.device)
        d = torch.einsum("bcHW,Ww->bcHw", g, ww)
        return torch.einsum("bcHw,Hh->bchw", d, wh), None, None


def entry_loss_sums(lo: torch.Tensor, labels: torch.Tensor,
                    fixed_order: bool = True) -> torch.Tensor:
    """Per-entry sums ``(B,)`` of the 255-masked CE of the float32 bilinear
    upsample of ``lo`` to the labels' size."""
    hi = _Upsample.apply(lo.float(), tuple(labels.shape[1:]), fixed_order)
    mask = labels != IGNORE
    safe = torch.where(mask, labels, torch.zeros_like(labels)).long()
    ce = -F.log_softmax(hi, dim=1).gather(1, safe[:, None]).squeeze(1)
    return torch.where(mask, ce, torch.zeros_like(ce)).sum(dim=(1, 2))


def site_loss(labels: torch.Tensor, record: Callable = None,
              fixed_order: bool = True) -> Callable:
    """os4 logits ``(k * B, C, h, w)`` → ``(k,)``: each group's summed
    loss over the batch's valid-pixel count. ``record`` sees each call's
    logits and the number of times the labels are tiled."""
    bsz = labels.shape[0]
    npix = (labels != IGNORE).sum().clamp_min(1)

    def site(lo: torch.Tensor) -> torch.Tensor:
        reps = lo.shape[0] // bsz
        if record is not None:
            record("resize_ce", lo, reps)
        tiled = labels.repeat(reps, 1, 1) if reps > 1 else labels
        return entry_loss_sums(lo, tiled, fixed_order).reshape(reps, bsz).sum(dim=1) / npix

    return site


def mix_feature(clean: torch.Tensor, adv: torch.Tensor) -> torch.Tensor:
    """AFN over the channel axis: statistics in float32 (ddof 1) returned
    in the feature's dtype, eps 1e-5 rounded to it."""
    def stats(f):
        var, mean = torch.var_mean(f.float(), dim=1, correction=1,
                                   keepdim=True)
        return var.to(f.dtype), mean.to(f.dtype)

    var_cl, mean_cl = stats(clean)
    var_adv, mean_adv = stats(adv)
    eps = weak_scalar(1e-5, clean.dtype)
    return (clean - mean_cl) / torch.sqrt(var_cl + eps) * torch.sqrt(
        var_adv + eps) + mean_adv


def sign_ascent(loss_fn, x: torch.Tensor, steps: int, gamma: float,
                record: Callable = None) -> torch.Tensor:
    """``steps`` unclipped sign steps from ``x`` up ``loss_fn``."""
    g_t = weak_scalar(gamma, x.dtype)
    x_adv = x.detach()
    for _ in range(steps):
        x_adv = x_adv.detach().requires_grad_(True)
        with torch.enable_grad():
            (g,) = torch.autograd.grad(loss_fn(x_adv), x_adv)
        if record is not None:
            record("pgd_step", x_adv, 1)
        x_adv = x_adv.detach() + g_t * torch.sign(g)
    return x_adv.detach()


def optimizer(model: DeepLabV3Plus, opt: Dict):
    """SGD with the recipe's poly schedule (power 0.9, floor 1e-6)."""
    lr, total = opt["lr"], opt["total_itrs"]
    sgd = torch.optim.SGD(
        [dict(g, lr=lr * g["lr_scale"]) for g in model.param_groups()],
        lr=lr, momentum=opt["momentum"], weight_decay=opt["weight_decay"])

    def poly(count: int) -> float:
        frac = min(max(1.0 - count / total, 0.0), 1.0)
        return max(lr * frac ** 0.9, 1e-6) / lr

    return sgd, torch.optim.lr_scheduler.LambdaLR(sgd, poly)


def make_step(model: DeepLabV3Plus, variant: str, afan: Dict, opt: Dict,
              record: Callable = None, fixed_order: bool = True):
    """``step(images (B, H, W, 3), labels (B, H, W)) -> loss`` of
    ``variant`` ('afan' or 'baseline'), with its own optimizer
    (``fixed_order`` off: the upsample's backward as the library sums
    it)."""
    sgd, sched = optimizer(model, opt)
    tap, n_spec = afan["tap_se"], afan["spectrum"]
    # the recipe's step sizes are in 1/255 units; its mix_layer string
    # sets AFN on the spectrum's points after the clean one
    gamma_se, gamma_sd = afan["gamma_se"] / 255, afan["gamma_sd"] / 255
    mix_mask = [False] + [ch == "1" for ch in afan["mix_layer"]]

    def update(loss):
        loss.backward()
        sgd.step()
        sched.step()
        return loss.detach()

    def base(images, labels):
        model.train()
        site = site_loss(labels, record, fixed_order)
        sgd.zero_grad(set_to_none=True)
        x = images.permute(0, 3, 1, 2).contiguous()
        return update(site(model.forward_logits(x))[0])

    def a_fan(images, labels):
        model.train()
        x = images.permute(0, 3, 1, 2).contiguous()
        site = site_loss(labels, record, fixed_order)
        with frozen_bn_stats(model):
            with torch.no_grad():
                feat, low, sd_clean = model.attack_features(x, tap)
            adv_se = sign_ascent(
                lambda f: site(model.forward_tail_logits(f, low, tap))[0],
                feat, afan["steps"], gamma_se, record)
            adv_sd = sign_ascent(lambda f: site(model.sd_tail_logits(f))[0],
                                 sd_clean, afan["steps"], gamma_sd,
                                 record)
            if afan["mix_sd"]:
                adv_sd = mix_feature(sd_clean, adv_sd)
            with torch.no_grad():
                ws = torch.tensor([0.0] + [i / (n_spec - 1)
                                           for i in range(1, n_spec - 1)]
                                  + [1.0], dtype=feat.dtype,
                                  device=feat.device)
                spec = [feat + ws[i] * (adv_se - feat)
                        for i in range(1, n_spec)]
                spec = [mix_feature(feat, s) if mix_mask[i + 1]
                        else s for i, s in enumerate(spec)]
        sgd.zero_grad(set_to_none=True)
        out, low_diff = model.backbone_head(x, 4)
        parts = [model.classifier(out, low_diff)]
        with frozen_bn_stats(model):
            parts.append(torch.cat([model.forward_tail_logits(f, low_diff,
                                                              tap)
                                    for f in spec]))
            parts.append(model.sd_tail_logits(adv_sd))
        group = torch.cat([site(p) for p in parts])
        loss = afan["clean_weight"] * group[0] + afan["adv_weight"] * (
            group[1:n_spec].sum() + group[n_spec])
        return update(loss)

    chosen = a_fan if variant == "afan" else base
    chosen.optimizer = sgd
    return chosen
