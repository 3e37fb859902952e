"""Segmentation training CLI — the PyTorch counterpart of
``afan/cli/train_segment.py`` for the baseline and the flagship A-FAN
variant, on the card unless ``--device cpu``.

Canonical run: the Cityscapes "final" recipe — DeepLabv3+ ResNet-50 at
output stride 16, crop 768, batch 4, poly lr 0.1, SE tap 2, SD tap concat,
gamma_se 0.02/255, gamma_sd 1.5/255, ``--mix_sd``, spectrum 3, one PGD step
(`sh/city/clean50/091_city_final01.sh`)::

    python -m afan_torch.cli.train_segment --variant afan \\
        --dataset cityscapes --model deeplabv3plus_resnet50 \\
        --crop_size 768 --batch_size 4 --lr 0.1 --pertub_idx_se 2 \\
        --pertub_idx_sd concat --gamma_se 0.02 --gamma_sd 1.5 --mix_sd

Data is ``afan``'s deterministic synthetic Cityscapes stand-in (reading the
datasets from disk is not ported yet); weights start from a seeded random
init. The loop validates with mIoU every ``--val_interval`` iterations and at
the end, and writes ``latest_*.pt`` / ``best_*.pt`` under
``checkpoints/<exp>/``.
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from ..data.seg_data import cityscapes_loaders
from ..eval.seg_miou import StreamSegMetrics
from ..models.deeplab import build_model
from ..models.deeplab.modeling import segmentation_param_groups
from ..train.checkpoint import (load_checkpoint, load_training_state,
                                overlap_restore, save_checkpoint)
from ..train.optim import poly_schedule, sgd
from ..train.segment_loop import (SegAfanConfig, make_afan_seg_step,
                                  make_seg_base_step, make_seg_eval_step)
from ..utils.device import resolve_device
from ..utils.logging import Log

VARIANTS = ("baseline", "afan")


def get_parser():
    p = argparse.ArgumentParser(
        description="A-FAN segmentation training (PyTorch, CUDA)")
    p.add_argument("--variant", choices=VARIANTS, default="afan")
    p.add_argument("--data_root", type=str, default="./datasets/data")
    p.add_argument("--dataset", choices=["cityscapes", "synthetic"],
                   default="cityscapes",
                   help="synthetic: the synthetic Cityscapes samples "
                        "without looking at --data_root")
    p.add_argument("--model", type=str, default="deeplabv3plus_resnet50")
    p.add_argument("--output_stride", type=int, default=16, choices=[8, 16])
    p.add_argument("--total_itrs", type=int, default=30000)
    p.add_argument("--limit_itrs", type=int, default=0,
                   help="stop after this many iterations (the poly "
                        "schedule still spans --total_itrs)")
    p.add_argument("--lr", type=float, default=0.01)
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--crop_size", type=int, default=768)
    p.add_argument("--weight_decay", type=float, default=1e-4)
    p.add_argument("--loss_type", choices=["cross_entropy", "focal_loss"],
                   default="cross_entropy")
    p.add_argument("--val_interval", type=int, default=100)
    p.add_argument("--print_interval", type=int, default=10)
    p.add_argument("--ckpt", type=str, default=None)
    p.add_argument("--continue_training", action="store_true")
    p.add_argument("--exp", type=str, default="afan")
    p.add_argument("--random_seed", type=int, default=1)
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default) or cpu; the port never falls back "
                        "to the CPU by itself")
    # A-FAN flags (`args.py` SE/SD section)
    p.add_argument("--pertub_idx_se", type=int, default=2)
    p.add_argument("--pertub_idx_sd", choices=["aspp", "concat", "none"],
                   default="concat")
    p.add_argument("--gamma_se", type=float, default=0.02)
    p.add_argument("--gamma_sd", type=float, default=1.5)
    p.add_argument("--mix_layer", type=str, default="00",
                   help="AFN mask chars for the spectrum interior+adv points")
    p.add_argument("--mix_sd", action="store_true")
    p.add_argument("--noise_sd", type=float, default=0.0)
    p.add_argument("--steps", type=int, default=1)
    p.add_argument("--eps", type=float, default=2.0)
    p.add_argument("--randinit", action="store_true")
    p.add_argument("--clip", action="store_true")
    return p


def afan_config(args) -> SegAfanConfig:
    """The flagship's config from the flags (gammas and eps in /255
    units, the spectrum's AFN mask from ``--mix_layer``)."""
    spectrum = 3
    mask = [0] * spectrum
    for i, ch in enumerate(args.mix_layer[:spectrum - 1]):
        if ch == "1":
            mask[i + 1] = 1
    return SegAfanConfig(
        tap_se=args.pertub_idx_se,
        sd=None if args.pertub_idx_sd == "none" else args.pertub_idx_sd,
        steps=args.steps, gamma_se=args.gamma_se / 255,
        gamma_sd=args.gamma_sd / 255, eps=args.eps / 255,
        spectrum=spectrum, mix_mask=tuple(mask), mix_sd=args.mix_sd,
        noise_sd=args.noise_sd, randinit=args.randinit, clip=args.clip,
        use_focal=args.loss_type == "focal_loss")


def main(argv=None):
    args = get_parser().parse_args(argv)
    device = resolve_device(args.device)
    exp = (f"{args.dataset}_{args.exp}_selayer_{args.pertub_idx_se}"
           f"_sdlayer_{args.pertub_idx_sd}_gamma_se{args.gamma_se}"
           f"_gamma_sd{args.gamma_sd}MIX{args.mix_layer}")
    outdir = os.path.join("checkpoints", exp)
    os.makedirs(outdir, exist_ok=True)
    Log.initialize(os.path.join(outdir, "train.log"))
    Log.i(f"args: {vars(args)}; save dir: [{exp}]; device {device}")

    train_loader, val_loader, num_classes = cityscapes_loaders(
        None if args.dataset == "synthetic" else args.data_root,
        args.batch_size, args.crop_size, seed=args.random_seed)

    torch.manual_seed(args.random_seed)
    model = build_model(args.model, num_classes, args.output_stride)
    model.reset_parameters(torch.Generator().manual_seed(args.random_seed))
    model.to(device)
    total = args.limit_itrs or args.total_itrs
    optimizer, scheduler = sgd(
        segmentation_param_groups(model),
        poly_schedule(args.lr, args.total_itrs, 0.9), args.lr, 0.9,
        args.weight_decay)

    cur_itrs, best_score = 0, 0.0
    if args.ckpt and os.path.isfile(args.ckpt):
        frac = overlap_restore(model, load_checkpoint(args.ckpt))
        Log.i(f"Model restored ({frac:.1%}) from {args.ckpt}")
        if args.continue_training:
            saved = load_training_state(args.ckpt)
            optimizer.load_state_dict(saved["optimizer_state"])
            scheduler.load_state_dict(saved["scheduler_state"])
            cur_itrs = int(saved["cur_itrs"])
            best_score = float(saved["best_score"])
            Log.i(f"Training state restored at itrs {cur_itrs}")

    if args.variant == "baseline":
        step = make_seg_base_step(model, optimizer, scheduler,
                                  args.loss_type == "focal_loss")
    else:
        step = make_afan_seg_step(model, optimizer, scheduler,
                                  afan_config(args))
    eval_step = make_seg_eval_step(model, num_classes)

    def to_device(imgs, labs):
        return (torch.from_numpy(imgs).to(device, non_blocking=True),
                torch.from_numpy(labs).to(device, non_blocking=True))

    def validate():
        metrics = StreamSegMetrics(num_classes)
        for imgs, labs in val_loader:
            _, hist = eval_step(*to_device(imgs, labs))
            metrics.update_hist(hist.cpu().numpy())
        return metrics.get_results()

    interval_loss = 0.0
    t0 = time.time()
    while cur_itrs < total:
        for imgs, labs in train_loader:
            cur_itrs += 1
            metrics = step(*to_device(imgs, labs))
            loss = float(metrics["loss"])
            if not np.isfinite(loss):
                raise FloatingPointError(f"loss {loss} at itrs {cur_itrs}")
            interval_loss += loss
            if cur_itrs % args.print_interval == 0:
                rate = (args.print_interval * args.batch_size
                        / (time.time() - t0))
                Log.i(f"Itrs {cur_itrs}/{total}, Loss="
                      f"{interval_loss / args.print_interval:.4f} "
                      f"({rate:.2f} imgs/sec)")
                interval_loss = 0.0
                t0 = time.time()
            if cur_itrs % args.val_interval == 0 or cur_itrs >= total:
                results = validate()
                score = results["Mean IoU"]
                Log.i(f"[Val] itrs {cur_itrs}: "
                      f"{StreamSegMetrics.to_str(results)}")
                save_checkpoint(
                    os.path.join(outdir,
                                 f"latest_{args.model}_{args.dataset}.pt"),
                    model, optimizer, scheduler, cur_itrs,
                    max(best_score, score))
                if score > best_score:
                    best_score = score
                    save_checkpoint(
                        os.path.join(outdir,
                                     f"best_{args.model}_{args.dataset}.pt"),
                        model, optimizer, scheduler, cur_itrs, best_score)
            if cur_itrs >= total:
                break

    Log.i(f"done; best mIoU {best_score:.4f}")
    return best_score


if __name__ == "__main__":
    main()
