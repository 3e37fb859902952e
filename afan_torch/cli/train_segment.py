"""Segmentation training CLI — the PyTorch counterpart of
``afan/cli/train_segment.py``, on the card unless ``--device cpu``.

``--variant`` picks one of the reference's nine mains: ``baseline``
(`main_ori.py`), ``advtrain`` (`main_advtrain.py`: input PGD, the
adversarial loss alone), ``afan`` (`main_aug_final.py`), and the
``sat``/``multi``/``sat_multi`` ablations with (input PGD on the clean
term) or without (``*_clean``) input-adversarial training
(`main_aug_{sat,muti,sat_muti}_{advt,clean}.py`).

The three segmentation recipes run as written, with ``afan_torch`` for
``afan``: the Cityscapes "final" recipe — DeepLabv3+ ResNet-50 at output
stride 16, crop 768, batch 4, poly lr 0.1, SE tap 2, SD tap concat, gamma_se
0.02/255, gamma_sd 1.5/255, AFN on the spectrum's adversarial point
(``--mix_layer 01``), ``--mix_sd``, spectrum 3, one PGD step, bfloat16
compute (`sh/city/clean50/091_city_final01.sh`,
``recipes/seg_city_final.sh``)::

    python -m afan_torch.cli.train_segment --variant afan \\
        --dataset cityscapes --model deeplabv3plus_resnet50 \\
        --crop_size 768 --batch_size 4 --lr 0.1 --pertub_idx_se 2 \\
        --pertub_idx_sd concat --adv_loss_weight_sd 0.3 --gamma_se 0.02 \\
        --gamma_sd 1.5 --mix_layer 01 --mix_sd --bf16

and the VOC recipes ``recipes/seg_voc07_final1.sh`` and
``seg_voc12_final50.sh`` (``--dataset voc``, the default: 21 classes, crop
513). ``--bf16`` makes bfloat16 the models' compute dtype
(:mod:`afan_torch.models.resnet`); the parameters stay float32.

``--model`` takes every DeepLab of ``afan`` (v3 and v3+ on ResNet-50,
ResNet-101 and MobileNetV2), ``--separable_conv`` makes the head's k > 1
convolutions depthwise-separable, and ``--pretrained_backbone`` overlap-loads
a torchvision ResNet ``.pth`` into the backbone, logging ``afan``'s two
matched fractions (a MobileNetV2 backbone matches none of its keys, as in
``afan``).

Data is read from ``--data_root``: VOC 2012 segmentation (``VOC2012/``,
``VOCdevkit/VOC2012/`` or the root itself, with ``SegmentationClass/``;
SBD's ``train_aug.txt`` and ``SegmentationClassAug/`` when there) or
Cityscapes (``leftImg8bit/`` and ``gtFine/``), decoded by
:mod:`afan_torch.utils.imread` in the loop, as ``afan`` reads them (no
prefetch thread). Without the dataset there, the data is ``afan``'s
deterministic synthetic stand-in (``--dataset synthetic`` is VOC's, as in
``afan``). Weights start from a seeded random init. The loop validates
with mIoU every ``--val_interval`` iterations and at the end, and writes
``latest_*.pt`` / ``best_*.pt`` under ``checkpoints/<exp>/``;
``--enable_vis`` adds input | target | prediction PNG panels of the first
``--vis_num_samples`` validation images under ``runs/<exp>/vis/``.
``--test_only CKPT`` restores a checkpoint, validates, prints the metrics
and returns them, training nothing. Each step's loss and each validation's
mIoU go to ``runs/<exp>/scalars.jsonl`` (``train/loss``, ``val/mIoU``),
and to TensorBoard there where ``torch.utils.tensorboard`` imports, as
``afan`` writes them.

``--fused_ce auto|on`` runs every loss and ascent site through the upsample
+ CE kernels on the card; ``off`` through the library's upsample and
cross-entropy. A kernel that fails raises: there is no switch to ``off``.
``afan``'s other flags parse as in ``afan``: ``--gpu_id``, ``--vis_port``,
``--vis_env`` and ``--adv_type`` are ignored, ``--download`` logs that
nothing is downloaded. ``--backbone_remat`` recomputes the ResNet
backbone's stages in every backward (MobileNetV2 ignores it, as in
``afan``) and ``--remat_tails`` the spectrum tails
(:mod:`afan_torch.train.remat`): less memory, more time, the same step.
``--num_devices N`` above 1 trains data-parallel on N
cards, one process each (``--device cpu``: N gloo processes; every
visible card by default on the card): each rank loads the global batch of
the one-process run and keeps its rows, the loss divides by the global
valid-pixel count, BatchNorm takes the global statistics
(:mod:`afan_torch.parallel.mesh`), validation sums the ranks' confusion
matrices, and rank 0 alone logs and writes. ``--spatial_shards S`` trains
on a ``N/S x S`` data x spatial mesh of the N ranks, with ``afan``'s
checks and messages (N, the crop and the batch times S must divide): each
data row of S ranks takes its share of the global batch and splits its
images' rows over its S ranks, and each training step runs row-sharded
(:mod:`afan_torch.parallel.spatial`); validation and ``--test_only`` run as
at ``--num_devices N``, as ``afan``'s do.
"""
from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

from ..data.seg_data import cityscapes_loaders, voc_seg_loaders
from ..eval.seg_miou import StreamSegMetrics
from ..models.deeplab import build_model
from ..models.deeplab.modeling import segmentation_param_groups
from ..parallel import mesh as dp
from ..parallel import spatial
from ..parallel.launch import launch_cli
from ..train.checkpoint import (load_checkpoint, load_training_state,
                                overlap_restore, restore_pretrained_backbone,
                                save_checkpoint)
from ..train.optim import poly_schedule, sgd, step_schedule
from ..train.segment_loop import (SegAfanConfig, make_afan_seg_step,
                                  make_seg_advtrain_step, make_seg_base_step,
                                  make_seg_eval_step)
from ..utils.device import resolve_device
from ..utils.logging import Log
from ..utils.observe import ScalarWriter, save_image_panel
from .eval_segment import decode_palette

VARIANTS = ("baseline", "advtrain", "afan", "sat", "sat_clean", "multi",
            "multi_clean", "sat_multi", "sat_multi_clean")


def get_parser():
    p = argparse.ArgumentParser(
        description="A-FAN segmentation training (PyTorch, CUDA)")
    p.add_argument("--variant", choices=VARIANTS, default="afan")
    p.add_argument("--data_root", type=str, default="./datasets/data")
    p.add_argument("--dataset", choices=["voc", "cityscapes", "synthetic"],
                   default="voc",
                   help="synthetic reads VOC like voc: with no VOC under "
                        "--data_root, the synthetic VOC samples")
    p.add_argument("--model", type=str, default="deeplabv3plus_resnet50")
    p.add_argument("--output_stride", type=int, default=16, choices=[8, 16])
    p.add_argument("--separable_conv", action="store_true",
                   help="AtrousSeparableConvolution in the decoder "
                        "(convert_to_separable_conv parity)")
    p.add_argument("--total_itrs", type=int, default=30000)
    p.add_argument("--limit_itrs", type=int, default=0,
                   help="stop after this many iterations (the poly "
                        "schedule still spans --total_itrs)")
    p.add_argument("--lr", type=float, default=0.01)
    p.add_argument("--lr_policy", choices=["poly", "step"], default="poly")
    p.add_argument("--step_size", type=int, default=10000,
                   help="--lr_policy step: lr x0.1 every this many "
                        "iterations")
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--crop_size", type=int, default=513)
    p.add_argument("--weight_decay", type=float, default=1e-4)
    p.add_argument("--loss_type", choices=["cross_entropy", "focal_loss"],
                   default="cross_entropy")
    p.add_argument("--val_interval", type=int, default=100)
    p.add_argument("--print_interval", type=int, default=10)
    p.add_argument("--ckpt", type=str, default=None)
    p.add_argument("--pretrained_backbone", default=None,
                   help="torchvision resnet .pth; overlap-loaded into the "
                        "backbone like the reference's ImageNet init "
                        "(`network/backbone/resnet.py:307-319`)")
    p.add_argument("--continue_training", action="store_true")
    p.add_argument("--exp", type=str, default="afan")
    p.add_argument("--random_seed", type=int, default=1)
    p.add_argument("--num_classes", type=int, default=None,
                   help="override the dataset's class count")
    p.add_argument("--year", type=str, default="2012",
                   choices=["2012_aug", "2012", "2011", "2009", "2008",
                            "2007"])
    p.add_argument("--crop_val", action="store_true",
                   help="resize + centre-crop val images to crop_size")
    p.add_argument("--val_batch_size", type=int, default=1)
    p.add_argument("--bf16", action="store_true",
                   help="bfloat16 compute in the model (parameters stay "
                        "float32)")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default) or cpu; the port never falls back "
                        "to the CPU by itself")
    # A-FAN flags (`args.py` SE/SD section)
    p.add_argument("--pertub_idx_se", type=int, default=2)
    p.add_argument("--pertub_idx_sd", choices=["aspp", "concat", "none"],
                   default="concat")
    p.add_argument("--gamma_se", type=float, default=0.02)
    p.add_argument("--gamma_sd", type=float, default=1.5)
    # read only for the run's directory name, as in afan's segmentation CLI
    p.add_argument("--adv_loss_weight_sd", type=float, default=0.3)
    p.add_argument("--mix_layer", type=str, default="00",
                   help="AFN mask chars for the spectrum interior+adv points")
    p.add_argument("--mix_sd", action="store_true")
    p.add_argument("--noise_sd", type=float, default=0.0)
    p.add_argument("--steps", type=int, default=1)
    p.add_argument("--loss_settings", type=int, default=1,
                   help="the sat/multi loss preset (1-4 sat, 1-2 multi)")
    p.add_argument("--eps", type=float, default=2.0)
    p.add_argument("--randinit", action="store_true")
    p.add_argument("--clip", action="store_true")
    p.add_argument("--pgd_step_mode", choices=("sign", "grad"),
                   default="sign",
                   help="grad: raw-gradient steps normalized per sample, "
                        "for every ascent of the step")
    p.add_argument("--pgd_random_steps", action="store_true",
                   help="per-step random step sizes in (0, 2 gamma)")
    p.add_argument("--mix_all", action="store_true",
                   help="AFN on every adversarial point: the spectrum's, "
                        "the SD point and each extra tap's")
    p.add_argument("--input_adv", action="store_true",
                   help="input PGD on the clean term of --variant afan (the "
                        "sat/multi variants but *_clean imply it)")
    p.add_argument("--test_only", type=str, default="",
                   help="path to a checkpoint: restore, validate, print and "
                        "exit (`args.py:17`)")
    # the reference's visdom image panels as PNG files under runs/
    p.add_argument("--enable_vis", action="store_true",
                   help="write input|target|prediction panels at each "
                        "validation")
    p.add_argument("--vis_num_samples", type=int, default=8)
    # afan's flags of its TPU runs: the kernel's switch, the meshes and
    # recomputation
    p.add_argument("--fused_ce", choices=["auto", "on", "off"],
                   default="auto",
                   help="auto, on: the upsample + CE kernels at every loss "
                        "site (on the card); off: the library's upsample "
                        "and cross-entropy")
    p.add_argument("--remat_tails", action="store_true", default=False,
                   help="recompute the spectrum tails in the backward")
    p.add_argument("--backbone_remat", action="store_true", default=False,
                   help="recompute the ResNet backbone's stages in the "
                        "backward (ignored for MobileNetV2)")
    p.add_argument("--num_devices", type=int, default=None,
                   help="devices: one process each (NCCL, one card each; "
                        "gloo processes with --device cpu); every visible "
                        "card by default on the card, 1 on the CPU")
    p.add_argument("--spatial_shards", type=int, default=1,
                   help="row shards of a data x spatial mesh of the "
                        "--num_devices ranks (each image's rows split over "
                        "S ranks)")
    # the reference's remaining `args.py` flags
    p.add_argument("--download", action="store_true",
                   help="downloads nothing: a warning is logged and the "
                        "data on disk, or the synthetic fallback, is used")
    p.add_argument("--gpu_id", type=str, default=None, help="ignored")
    p.add_argument("--vis_port", type=str, default=None, help="ignored")
    p.add_argument("--vis_env", type=str, default=None, help="ignored")
    p.add_argument("--adv_type", type=str, default="baseline",
                   help="ignored (unused by the reference trainers too)")
    return p


def afan_config(args) -> SegAfanConfig:
    """The A-FAN family's config of ``args.variant`` (``afan``'s
    `cli/train_segment.py:170-212`; gammas and eps in /255 units, the
    spectrum's AFN mask from ``--mix_layer``)."""
    base = args.variant.replace("_clean", "")
    spectrum = {"afan": 3, "sat": 3, "multi": 2, "sat_multi": 3}[base]
    mask = [0] * spectrum
    for i, ch in enumerate(args.mix_layer[:spectrum - 1]):
        if ch == "1":
            mask[i + 1] = 1
    if args.mix_all:
        mask = [0] + [1] * (spectrum - 1)
    input_adv = args.input_adv or (args.variant != "afan"
                                   and not args.variant.endswith("_clean"))
    weight_mode = {"afan": "final", "sat": "sat_preset",
                   "multi": "multi_preset", "sat_multi": "multi_preset"}[base]
    if base in ("multi", "sat_multi"):
        # `main_aug_muti_advt.py:180-197`: taps 1-4, gamma .1/255 on tap 3
        # (which carries the spectrum), .001/255 on the others
        tap_se, extra, extra_gammas = 3, (1, 2, 4), (0.001 / 255,) * 3
        gamma_se = 0.1 / 255
    else:
        tap_se, extra, extra_gammas = args.pertub_idx_se, (), ()
        gamma_se = args.gamma_se / 255
    return SegAfanConfig(
        tap_se=tap_se, extra_taps=extra, extra_gammas=extra_gammas,
        sd=None if args.pertub_idx_sd == "none" else args.pertub_idx_sd,
        steps=args.steps, gamma_se=gamma_se,
        gamma_sd=args.gamma_sd / 255, eps=args.eps / 255,
        spectrum=spectrum, mix_mask=tuple(mask),
        mix_sd=args.mix_sd or args.mix_all, mix_all=args.mix_all,
        noise_sd=args.noise_sd, randinit=args.randinit, clip=args.clip,
        step_mode=args.pgd_step_mode, random_steps=args.pgd_random_steps,
        use_focal=args.loss_type == "focal_loss", weight_mode=weight_mode,
        loss_setting=args.loss_settings, input_adv=input_adv,
        remat_tails=args.remat_tails)


def build_step(args, model, optimizer, scheduler):
    """The train step of ``args.variant``."""
    fused = args.fused_ce != "off"
    if args.variant == "baseline":
        return make_seg_base_step(model, optimizer, scheduler,
                                  args.loss_type == "focal_loss", fused)
    if args.variant == "advtrain":
        return make_seg_advtrain_step(model, optimizer, scheduler,
                                      steps=args.steps,
                                      gamma=args.gamma_se / 255,
                                      eps=args.eps / 255, fused_ce=fused)
    return make_afan_seg_step(model, optimizer, scheduler, afan_config(args),
                              fused_ce=fused)


def lr_schedule(args):
    """PolyLR over ``--total_itrs`` or StepLR(``--step_size``, 0.1)
    (`main_aug_final.py:84-87`)."""
    if args.lr_policy == "step":
        return step_schedule(args.lr, args.step_size)
    return poly_schedule(args.lr, args.total_itrs, 0.9)


def experiment_name(args) -> str:
    """The run's directory under ``checkpoints/``, named as afan's
    segmentation CLI names it."""
    return (f"{args.dataset}_{args.exp}_selayer_{args.pertub_idx_se}"
            f"_sdlayer_{args.pertub_idx_sd}_gamma_se{args.gamma_se}"
            f"_gamma_sd{args.gamma_sd}_advweight{args.adv_loss_weight_sd}"
            f"MIX{args.mix_layer}")


def check_mesh(args, n_ranks: int) -> None:
    """``afan``'s checks of the ranks against the batch, and of the data x
    spatial mesh (`afan/cli/train_segment.py:274-289`), with its
    messages."""
    sp = args.spatial_shards
    if sp < 1:
        raise SystemExit(f"--spatial_shards {sp}: need at least 1")
    if sp == 1:
        dp.check_divisible(args.batch_size, n_ranks)
        return
    if n_ranks % sp:
        raise SystemExit(f"device count {n_ranks} must divide by "
                         f"--spatial_shards {sp}")
    dp.check_divisible(args.batch_size * sp, n_ranks)
    if args.crop_size % sp:
        raise SystemExit("--crop_size must divide by --spatial_shards")


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    args = get_parser().parse_args(argv)
    device = resolve_device(args.device)
    n_ranks = dp.resolve_size(args.num_devices, device)
    check_mesh(args, n_ranks)
    if n_ranks > 1 and dp.data_group() is None:
        return launch_cli(__name__, argv, n_ranks, device)
    exp = experiment_name(args)
    outdir = os.path.join("checkpoints", exp)
    os.makedirs(outdir, exist_ok=True)
    Log.initialize(os.path.join(outdir, "train.log") if dp.is_main()
                   else None, quiet=not dp.is_main())
    Log.i(f"args: {vars(args)}; save dir: [{exp}]; device {device}; "
          f"data-parallel ranks {dp.world_size()}")
    mesh = dp.make_mesh_2d(n_ranks // args.spatial_shards,
                           args.spatial_shards)
    if args.spatial_shards > 1:
        Log.i(f"2-D mesh: data={mesh.shape['data']} x "
              f"spatial={mesh.shape['spatial']}")

    if args.download:
        Log.i("--download requested: this environment has no egress; "
              "falling back to on-disk data or the synthetic pipeline")

    if args.dataset == "cityscapes":
        train_loader, val_loader, num_classes = cityscapes_loaders(
            args.data_root, args.batch_size, args.crop_size,
            seed=args.random_seed, val_batch_size=args.val_batch_size,
            crop_val=args.crop_val)
    else:
        train_loader, val_loader, num_classes = voc_seg_loaders(
            args.data_root, args.batch_size, args.crop_size, year=args.year,
            seed=args.random_seed, val_batch_size=args.val_batch_size,
            crop_val=args.crop_val)
    if args.num_classes is not None:
        num_classes = args.num_classes
    # training: the data row's rows of each batch; validation: every
    # rank a data rank
    train_loader.shard = (mesh.data_index, mesh.data)
    val_loader.shard = (dp.rank(), dp.world_size())

    # dropout draws from the global generator: its own stream per data row
    torch.manual_seed(dp.rank_seed(args.random_seed, mesh.data_index))
    model = build_model(args.model, num_classes, args.output_stride,
                        torch.bfloat16 if args.bf16 else torch.float32,
                        separable_conv=args.separable_conv,
                        backbone_remat=args.backbone_remat)
    model.reset_parameters(torch.Generator().manual_seed(args.random_seed))
    if args.pretrained_backbone:
        fp, fs = restore_pretrained_backbone(model.backbone,
                                             args.pretrained_backbone)
        Log.i(f"ImageNet backbone loaded (params {fp:.1%}, stats {fs:.1%}) "
              f"from {args.pretrained_backbone}")
    model.to(device)
    total = args.limit_itrs or args.total_itrs
    optimizer, scheduler = sgd(
        segmentation_param_groups(model),
        lr_schedule(args), args.lr, 0.9, args.weight_decay)

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
    dp.replicate_state(model, optimizer)

    step = build_step(args, model, optimizer, scheduler)
    eval_step = make_seg_eval_step(model, num_classes)

    def to_device(imgs, labs):
        return (torch.from_numpy(imgs).to(device, non_blocking=True),
                torch.from_numpy(labs).to(device, non_blocking=True))

    palette = decode_palette(args.dataset, num_classes)

    def decode(lab: np.ndarray) -> np.ndarray:
        rgb = np.zeros(lab.shape + (3,), np.uint8)
        ok = lab < len(palette)
        rgb[ok] = palette[lab[ok]]
        return rgb

    def validate(itrs=0, vis=args.enable_vis):
        """The validation mIoU; with ``vis``, the first
        ``--vis_num_samples`` images' panels, named as ``afan`` names them
        (`cli/train_segment.py:355-368`)."""
        metrics = StreamSegMetrics(num_classes)
        vis_left = args.vis_num_samples if vis and dp.is_main() else 0
        for imgs, labs in val_loader:
            if not len(imgs):
                continue
            preds, hist = eval_step(*to_device(imgs, labs))
            metrics.update_hist(hist.cpu().numpy())
            if vis_left:
                preds = preds.cpu().numpy()
            for j in range(min(vis_left, len(imgs))):
                save_image_panel(
                    os.path.join("runs", exp, "vis",
                                 f"itrs{itrs:06d}_{vis_left:02d}.png"),
                    imgs[j], decode(labs[j]), decode(preds[j]))
                vis_left -= 1
        metrics.confusion_matrix = dp.sum_numpy(metrics.confusion_matrix)
        return metrics.get_results()

    if args.test_only:
        frac = overlap_restore(model, load_checkpoint(args.test_only))
        Log.i(f"[test_only] restored {frac:.1%} of the entries from "
              f"{args.test_only}")
        results = validate(vis=False)
        Log.i(StreamSegMetrics.to_str(results))
        return results

    writer = ScalarWriter(os.path.join("runs", exp)) if dp.is_main() \
        else None
    interval_loss = 0.0
    t0 = time.time()
    while cur_itrs < total:
        for imgs, labs in train_loader:
            cur_itrs += 1
            with spatial.sharded(mesh):
                metrics = step(*to_device(*dp.shard_rows(mesh, imgs, labs)))
            loss = float(metrics["loss"])
            if not np.isfinite(loss):
                raise FloatingPointError(f"loss {loss} at itrs {cur_itrs}")
            if writer:
                writer.add_scalar("train/loss", loss, cur_itrs)
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
                results = validate(cur_itrs)
                score = results["Mean IoU"]
                Log.i(f"[Val] itrs {cur_itrs}: "
                      f"{StreamSegMetrics.to_str(results)}")
                if dp.is_main():
                    writer.add_scalar("val/mIoU", score, cur_itrs)
                    save_checkpoint(
                        os.path.join(outdir,
                                     f"latest_{args.model}_{args.dataset}.pt"),
                        model, optimizer, scheduler, cur_itrs,
                        max(best_score, score))
                if score > best_score:
                    best_score = score
                    if dp.is_main():
                        save_checkpoint(
                            os.path.join(
                                outdir,
                                f"best_{args.model}_{args.dataset}.pt"),
                            model, optimizer, scheduler, cur_itrs,
                            best_score)
            if cur_itrs >= total:
                break
    if writer:
        writer.close()

    Log.i(f"done; best mIoU {best_score:.4f}")
    return best_score


if __name__ == "__main__":
    main()
