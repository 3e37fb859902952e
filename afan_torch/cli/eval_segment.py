"""Segmentation evaluation CLI — the PyTorch counterpart of
``afan/cli/eval_segment.py`` (the ``--test_only`` / ``--save_val_results`` /
``pgd_validate`` surface of `Segmentation/args.py:168-255` and
`main_aug_final.py`), on the card unless ``--device cpu``.

``--task miou``: the clean validation mIoU (:class:`StreamSegMetrics`).
``--task pgd``: the mIoU under input PGD (`args.py:223-255`): sign steps
against the eval-mode model's cross-entropy, optionally from a random start
(``--randinit_pgd``) and projected (``--clip_pgd``), then a clamp to
[0, 1] (:func:`make_seg_pgd_fn`).
``--save_val_results``: a colour-decoded prediction PNG per batch (the VOC
palette or Cityscapes' train-id colours), written by
:mod:`afan_torch.utils.png`.

The flags, aliases and defaults are ``afan``'s, plus ``--device``. The data
are ``afan``'s synthetic VOC or Cityscapes stand-ins (reading the datasets
from disk is not ported yet); the weights start from a seeded random init,
then ``--ckpt`` (a port checkpoint) and ``--torch_ckpt`` (a reference
``.pth``: the port keeps the reference's key names) are overlap-restored.

``--fused_ce`` picks the attack loss: ``auto`` and ``on`` end each forward
in :func:`afan_torch.ops.resize_ce.fused_resize_nll_sums`, which on the
card launches the hand-written upsample + CE kernels, forward and backward
(``afan``'s ``auto`` means its kernel on its TPU); ``off`` is the plain
``resize_bilinear`` + ``seg_cross_entropy`` (``afan``'s ``off``,
`train/segment_loop.py:224`). Nothing switches from one to the other on a
failure: a kernel that fails raises. Every sign step runs the PGD-update
kernel, clipped under ``--clip_pgd``.
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from ..core.attack import pgd
from ..data.seg_data import (CITY_TRAIN_COLORS, cityscapes_loaders,
                             voc_seg_loaders)
from ..eval.seg_miou import StreamSegMetrics
from ..models.deeplab import build_model
from ..models.deeplab.heads import resize_bilinear
from ..models.deeplab.modeling import DeepLab
from ..train.checkpoint import load_checkpoint, overlap_restore
from ..train.segment_loop import (_site_loss, make_seg_eval_step,
                                  seg_cross_entropy)
from ..utils.device import resolve_device
from ..utils.logging import Log
from ..utils.png import voc_color_map, write_png


def get_parser():
    p = argparse.ArgumentParser(
        description="A-FAN segmentation eval (PyTorch, CUDA)")
    p.add_argument("--task", choices=["miou", "pgd"], default="miou")
    p.add_argument("--data_root", default="./datasets/data")
    p.add_argument("--dataset", choices=["voc", "cityscapes"], default="voc")
    p.add_argument("--model", default="deeplabv3plus_resnet50")
    p.add_argument("--output_stride", type=int, default=16)
    p.add_argument("--crop_size", type=int, default=513)
    p.add_argument("--ckpt", default=None)
    p.add_argument("--torch_ckpt", default=None,
                   help="a reference `Segmentation` torch .pth, "
                        "overlap-restored")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default) or cpu; the port never falls back "
                        "to the CPU by itself")
    p.add_argument("--save_val_results", action="store_true")
    p.add_argument("--results_dir", default="results")
    p.add_argument("--fused_ce", choices=["auto", "on", "off"],
                   default="auto",
                   help="the upsample + CE kernels in the pgd attack loss "
                        "(auto, on) or the plain resize + CE (off)")
    # pgd flags (`args.py` eval section; the reference's names aliased)
    p.add_argument("--pgd_steps", "--steps_pgd", type=int, default=3,
                   dest="pgd_steps")
    p.add_argument("--pgd_gamma", "--gamma_pgd", type=float, default=2.0,
                   dest="pgd_gamma")
    p.add_argument("--pgd_eps", "--eps_pgd", type=float, default=8.0,
                   dest="pgd_eps")
    p.add_argument("--pgd_bailout_tol", type=float, default=None,
                   help="stop the eval attack once the relative loss "
                        "change per step drops below this")
    p.add_argument("--randinit_pgd", action="store_true")
    p.add_argument("--clip_pgd", action="store_true")
    p.add_argument("--limit_images", type=int, default=0)
    p.add_argument("--crop_val", action="store_true",
                   help="resize+center-crop val images to crop_size")
    p.add_argument("--val_batch_size", type=int, default=1)
    p.add_argument("--year", type=str, default="2012")
    p.add_argument("--num_classes", type=int, default=None)
    return p


def make_seg_pgd_fn(model: DeepLab, args):
    """``attack(images (B, H, W, 3), labels (B, H, W), generator) ->
    adversarial images``: ``afan``'s composition (`eval_segment.py:
    130-155`) — ``args.pgd_steps`` sign steps of ``pgd_gamma / 255`` on
    the eval-mode model's mean 255-masked CE of its upsampled logits,
    from a uniform start in ``(-eps, eps)`` drawn from ``generator`` under
    ``randinit_pgd``, projected onto the eps-ball under ``clip_pgd``, then
    clamped to [0, 1]. ``args.fused_ce`` picks the loss's path (module
    docstring)."""
    fused = args.fused_ce != "off"

    def attack(images: torch.Tensor, labels: torch.Tensor,
               generator: torch.Generator) -> torch.Tensor:
        model.eval()
        size = tuple(labels.shape[1:])
        site = _site_loss(labels, None) if fused else None

        def loss_fn(x: torch.Tensor) -> torch.Tensor:
            lo = model.forward_logits(x.permute(0, 3, 1, 2).contiguous())
            if fused:
                return site(lo)[0]
            return seg_cross_entropy(resize_bilinear(lo, size), labels)

        adv = pgd(loss_fn, images, steps=args.pgd_steps,
                  gamma=args.pgd_gamma / 255, eps=args.pgd_eps / 255,
                  randinit=args.randinit_pgd, clip=args.clip_pgd,
                  generator=generator, bailout_tol=args.pgd_bailout_tol)
        return adv.clamp(0.0, 1.0)

    return attack


def restore(model: DeepLab, args) -> None:
    """``--ckpt`` then ``--torch_ckpt``, overlap-restored."""
    for flag, path in (("ckpt", args.ckpt), ("torch_ckpt", args.torch_ckpt)):
        if path:
            frac = overlap_restore(model, load_checkpoint(path))
            Log.i(f"restored {frac:.1%} of the entries from {path} "
                  f"(--{flag})")


def decode_palette(dataset: str, num_classes: int) -> np.ndarray:
    """The colours of the label maps: Cityscapes' train ids or the VOC
    palette."""
    return (CITY_TRAIN_COLORS if dataset == "cityscapes"
            else voc_color_map()[:num_classes])


def main(argv=None):
    args = get_parser().parse_args(argv)
    device = resolve_device(args.device)
    Log.initialize()

    if args.dataset == "cityscapes":
        _, val_loader, num_classes = cityscapes_loaders(
            args.data_root, 1, args.crop_size,
            val_batch_size=args.val_batch_size, crop_val=args.crop_val)
    else:
        _, val_loader, num_classes = voc_seg_loaders(
            args.data_root, 1, args.crop_size, year=args.year,
            val_batch_size=args.val_batch_size, crop_val=args.crop_val)
    if args.num_classes is not None:
        num_classes = args.num_classes

    model = build_model(args.model, num_classes, args.output_stride)
    model.reset_parameters(torch.Generator().manual_seed(0))
    restore(model, args)
    model.to(device).eval()
    eval_step = make_seg_eval_step(model, num_classes)
    attack = make_seg_pgd_fn(model, args) if args.task == "pgd" else None
    generator = torch.Generator(device)

    metrics = StreamSegMetrics(num_classes)
    palette = decode_palette(args.dataset, num_classes)
    if args.save_val_results:
        os.makedirs(args.results_dir, exist_ok=True)
    for i, (imgs, labs) in enumerate(val_loader):
        if args.limit_images and i >= args.limit_images:
            break
        x = torch.from_numpy(imgs).to(device)
        y = torch.from_numpy(labs).to(device)
        if attack is not None:
            x = attack(x, y, generator.manual_seed(i))
        preds, hist = eval_step(x, y)
        metrics.update_hist(hist.cpu().numpy())
        if args.save_val_results:
            pred = preds[0].cpu().numpy()
            write_png(os.path.join(args.results_dir, f"{i:06d}_pred.png"),
                      palette[np.clip(pred, 0, len(palette) - 1)])
    results = metrics.get_results()
    Log.i(StreamSegMetrics.to_str(results))
    return results["Mean IoU"]


if __name__ == "__main__":
    main()
