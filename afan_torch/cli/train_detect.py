"""Detection training CLI — the PyTorch counterpart of
``afan/cli/train_detect.py``, on the card unless ``--device cpu``.

``--variant`` picks one of the reference's train scripts: ``baseline``,
``advtrain`` (input PGD, the adversarial loss alone), ``afan`` (the
flagship), the SAT family (``sat``, ``sat3``/``sat7``/``sat10``,
``sat_clean``: the SAT loss presets, no SD tap, input PGD on the clean term
but for ``*_clean``), the multi-layer family (``multi``, ``sat_multi``,
their ``*_clean``: SE taps 3, 1 and 2) and ``single`` (one adversarial
point, half the loss).

Canonical run: VOC2007 final setting 1
(`Detection/sh/voc2007/clean50/090_final_setting1.sh`,
``recipes/detect_voc07_final_setting1.sh`` as written): ResNet-50 Faster
R-CNN, batch 8, lr 0.008 with warmup and steps at 6250 and 8750, SE tap 2
with gamma 1.0/255 and AFN on the upper spectrum points (``--mix_layer
0011``), SD on the pooled ROI vector with gamma 0.1/255 and weight 0.3,
bfloat16 compute::

    python -m afan_torch.cli.train_detect --variant afan -s voc2007 \\
        -b resnet50 -o ./outputs/voc07_final1 --batch_size 8 \\
        --learning_rate 0.008 --step_lr_sizes "[6250, 8750]" \\
        --num_steps_to_snapshot 1250 --num_steps_to_finish 11250 \\
        --mix_layer 0011 --pertub_idx_se 2 --gamma_se 1.0 --gamma_sd 0.1 \\
        --sd_adv_loss_weight 0.3 --only_roi_sd --bf16

``--bf16`` makes bfloat16 the model's compute dtype (``afan``'s
``FasterRCNN(dtype=bf16)``); parameters, optimizer state and checkpoints
stay float32. ``recipes/detect_coco_final_setting.sh`` N (1-6) runs as
written too: ``-s coco2017`` at 800x1333, four anchor sizes, 92 classes.
``--pertub_idx_sd rpn`` puts the SD attack on the RPN trunk feature.

Data is ``afan``'s synthetic stand-in of each dataset (reading VOC or COCO
images from disk is not ported yet); weights start from a seeded random
init, the torso from ``--pretrained_backbone`` where given. The loop writes
``model-{step}.pt`` (model, optimizer, schedule and step) every
``--num_steps_to_snapshot`` steps and at the end, and ends with the test
split's mAP: VOC's protocol, or COCO's (AP@[.5:.95]) for the COCO names.
"""
from __future__ import annotations

import argparse
import ast
import os
import time
from collections import deque

import numpy as np
import torch

from ..data.prefetch import Prefetcher
from ..data.registry import DETECTION_DATASETS, detection_loaders
from ..eval.det_map import DetectionEvaluator
from ..models.frcnn import FRCNNConfig, FasterRCNN
from ..train.checkpoint import (load_checkpoint, load_training_state,
                                overlap_restore, restore_optimizer,
                                save_detect_checkpoint)
from ..train.detect_loop import (DetAfanConfig, detection_param_groups,
                                 make_advtrain_det_step, make_afan_det_step,
                                 make_baseline_det_step, make_detect_fn)
from ..train.optim import sgd, warmup_multistep_schedule
from ..utils.device import resolve_device
from ..utils.logging import Log

VARIANTS = ("baseline", "advtrain", "afan", "sat", "sat_clean", "sat3",
            "sat7", "sat10", "multi", "multi_clean", "sat_multi",
            "sat_multi_clean", "single")


def get_parser():
    p = argparse.ArgumentParser(
        description="A-FAN detection training (PyTorch, CUDA)")
    p.add_argument("--variant", choices=VARIANTS, default="afan")
    p.add_argument("-s", "--dataset", default="voc2007",
                   choices=list(DETECTION_DATASETS)
                   + ["voc2007-cat-dog", "coco2017-person",
                      "coco2017-car", "coco2017-animal"])
    p.add_argument("-b", "--backbone", default="resnet50",
                   choices=["resnet18", "resnet50", "resnet101"])
    p.add_argument("-d", "--data_dir", default="./data")
    p.add_argument("-o", "--outputs_dir", default="./outputs")
    p.add_argument("-r", "--resume_checkpoint", default=None)
    p.add_argument("--pretrained_backbone", default=None,
                   help="torchvision resnet state dict (.pth), overlap-"
                        "loaded into the torso, as the reference's ImageNet "
                        "init (`backbone/resnet50_ori.py:281-293`)")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default) or cpu; the port never falls back "
                        "to the CPU by itself")
    # Config/TrainConfig surface (`Detection/config/train_config.py`)
    p.add_argument("--image_min_side", type=float, default=600.0)
    p.add_argument("--image_max_side", type=float, default=1000.0)
    p.add_argument("--anchor_sizes", type=str, default="[128, 256, 512]")
    p.add_argument("--anchor_ratios", type=str,
                   default="[(1, 2), (1, 1), (2, 1)]")
    p.add_argument("--batch_size", type=int, default=1)
    p.add_argument("--learning_rate", type=float, default=0.001)
    p.add_argument("--momentum", type=float, default=0.9)
    p.add_argument("--weight_decay", type=float, default=0.0005)
    p.add_argument("--step_lr_sizes", type=str, default="[50000, 70000]")
    p.add_argument("--step_lr_gamma", type=float, default=0.1)
    p.add_argument("--warm_up_factor", type=float, default=0.3333)
    p.add_argument("--warm_up_num_iters", type=int, default=500)
    p.add_argument("--anchor_smooth_l1_loss_beta", type=float, default=1.0)
    p.add_argument("--proposal_smooth_l1_loss_beta", type=float, default=1.0)
    p.add_argument("--pooler_mode", choices=["align", "pooling"],
                   default="align")
    p.add_argument("--rpn_pre_nms_top_n", type=int, default=12000)
    p.add_argument("--rpn_post_nms_top_n", type=int, default=2000)
    p.add_argument("--num_steps_to_display", type=int, default=20)
    p.add_argument("--num_steps_to_snapshot", type=int, default=10000)
    p.add_argument("--num_steps_to_finish", type=int, default=90000)
    # A-FAN flags (`train_aug_final.py:200-247`)
    p.add_argument("--pertub_idx_se", type=int, default=2)
    p.add_argument("--sd_only", action="store_true",
                   help="no SE taps: the SD attack only")
    p.add_argument("--pertub_idx_sd", type=str, default="roi",
                   choices=["roi", "rpn", "none"])
    p.add_argument("--gamma_se", type=float, default=0.9)
    p.add_argument("--gamma_sd", type=float, default=0.1)
    p.add_argument("--sd_adv_loss_weight", type=float, default=0.3)
    p.add_argument("--mix_layer", type=str, default="0000",
                   help="AFN mask chars for spectrum points 1..N-1")
    p.add_argument("--mix_sd", action="store_true")
    p.add_argument("--noise_sd", type=float, default=0.0)
    p.add_argument("--only_roi_sd", action="store_true", default=True)
    p.add_argument("--randinit", action="store_true")
    p.add_argument("--clip", action="store_true")
    p.add_argument("--steps", type=int, default=1)
    p.add_argument("--pgd_step_mode", choices=("sign", "grad"),
                   default="sign")
    p.add_argument("--pgd_random_steps", action="store_true")
    p.add_argument("--loss_settings", type=int, default=1,
                   help="SAT weight preset 1-4")
    p.add_argument("--share_proposals", action="store_true", default=True,
                   help="sample anchors and proposals once per step and "
                        "reuse them across the step's forwards (default)")
    p.add_argument("--no_share_proposals", dest="share_proposals",
                   action="store_false",
                   help="resample in every forward, as the reference does")
    p.add_argument("--remat_tails", action="store_true", default=False,
                   help="not ported yet: raises")
    p.add_argument("--unfreeze_backbone", action="store_true",
                   help="train the stem, layer1 and the BatchNorm affines "
                        "too (training from scratch)")
    p.add_argument("--bf16", action="store_true",
                   help="bfloat16 compute in the model (parameters stay "
                        "float32)")
    p.add_argument("--num_devices", type=int, default=None,
                   help="data-parallel devices (only 1 is ported)")
    p.add_argument("--eval_every", type=int, default=0,
                   help="run the mAP eval every N steps (0 = only at end)")
    p.add_argument("--seed", "--random_seed", type=int, default=0,
                   dest="seed")
    return p


def refuse_unported(args) -> None:
    """The flags whose paths are not ported yet raise, naming the ROADMAP,
    instead of running something else (``--remat_tails`` raises in the
    step's factory)."""
    where = "not ported yet (ROADMAP.md, queue 1: detection)"
    if args.num_devices is not None and args.num_devices > 1:
        raise NotImplementedError(f"--num_devices > 1 is {where}")


def afan_config_for(args) -> DetAfanConfig:
    """``afan``'s variant → :class:`DetAfanConfig` mapping (gammas in /255
    units, the spectrum's AFN mask from ``--mix_layer``)."""
    spectrum = {"afan": 5, "sat": 5, "sat_clean": 5, "sat3": 3, "sat7": 7,
                "sat10": 10, "single": 2, "multi": 2, "multi_clean": 2,
                "sat_multi": 5, "sat_multi_clean": 5}[args.variant]
    mask = [0] * spectrum
    for i, ch in enumerate(args.mix_layer[:spectrum - 1]):
        if ch == "1":
            mask[i + 1] = 1
    if args.sd_only:
        taps, gammas = (), ()
    elif args.variant in ("multi", "multi_clean", "sat_multi",
                          "sat_multi_clean"):
        # `train_aug_muti_advt.py:91-100`: layers 3, 1, 2, the main gamma
        # on 3 and a tenth of it on 1 and 2
        taps = (3, 1, 2)
        gammas = (args.gamma_se / 255, 0.1 * args.gamma_se / 255,
                  0.1 * args.gamma_se / 255)
    else:
        taps = (args.pertub_idx_se,)
        gammas = (args.gamma_se / 255,)
    sd = None if args.pertub_idx_sd == "none" else args.pertub_idx_sd
    weight_mode = "final"
    input_adv = False
    if args.variant.startswith("sat") and args.variant != "sat_multi":
        weight_mode = "sat_preset"
        sd = None
        input_adv = not args.variant.endswith("_clean")
    elif args.variant == "single":
        weight_mode = "single"
        sd = None
    elif args.variant.endswith("_clean"):
        input_adv = False
    elif args.variant in ("multi", "sat_multi"):
        input_adv = True
    return DetAfanConfig(
        taps_se=taps, gammas_se=gammas, spectrum=spectrum,
        mix_mask=tuple(mask), sd=sd, gamma_sd=args.gamma_sd / 255,
        only_roi_sd=args.only_roi_sd, mix_sd=args.mix_sd,
        noise_sd=args.noise_sd, sd_weight=args.sd_adv_loss_weight,
        steps=args.steps, randinit=args.randinit, clip=args.clip,
        step_mode=args.pgd_step_mode, random_steps=args.pgd_random_steps,
        weight_mode=weight_mode, loss_setting=args.loss_settings,
        input_adv=input_adv, share_proposals=args.share_proposals,
        remat_tails=args.remat_tails)


def frcnn_config(args, num_classes: int) -> FRCNNConfig:
    return FRCNNConfig(
        backbone=args.backbone, num_classes=num_classes,
        anchor_sizes=tuple(ast.literal_eval(args.anchor_sizes)),
        anchor_ratios=tuple(ast.literal_eval(args.anchor_ratios)),
        train_pre_nms_top_n=args.rpn_pre_nms_top_n,
        train_post_nms_top_n=args.rpn_post_nms_top_n,
        anchor_smooth_l1_beta=args.anchor_smooth_l1_loss_beta,
        proposal_smooth_l1_beta=args.proposal_smooth_l1_loss_beta,
        pooler_mode=args.pooler_mode)


def main(argv=None):
    args = get_parser().parse_args(argv)
    refuse_unported(args)
    device = resolve_device(args.device)
    os.makedirs(args.outputs_dir, exist_ok=True)
    Log.initialize(os.path.join(args.outputs_dir, "train.log"))
    Log.i(f"args: {vars(args)}; device {device}")

    train_loader, eval_loader, num_classes = detection_loaders(
        args.dataset, args.data_dir, args.batch_size, args.image_min_side,
        args.image_max_side, seed=args.seed)
    Log.i(f"Found {len(train_loader.samples)} train samples")

    model = FasterRCNN(frcnn_config(args, num_classes),
                       torch.bfloat16 if args.bf16 else torch.float32)
    model.reset_parameters(torch.Generator().manual_seed(args.seed))
    if args.pretrained_backbone:
        frac = overlap_restore(model.features,
                               load_checkpoint(args.pretrained_backbone))
        Log.i(f"Backbone loaded ({frac:.1%} of the torso's entries) from "
              f"{args.pretrained_backbone}")
    model.to(device)
    schedule = warmup_multistep_schedule(
        args.learning_rate, ast.literal_eval(args.step_lr_sizes),
        args.step_lr_gamma, args.warm_up_factor, args.warm_up_num_iters)
    optimizer, scheduler = sgd(
        detection_param_groups(model, freeze=not args.unfreeze_backbone),
        schedule, args.learning_rate, args.momentum, args.weight_decay)

    step = 0
    if args.resume_checkpoint:
        frac = overlap_restore(model, load_checkpoint(args.resume_checkpoint))
        saved = load_training_state(args.resume_checkpoint)
        ok = restore_optimizer(optimizer, saved["optimizer_state_dict"])
        scheduler.load_state_dict(saved["scheduler_state_dict"])
        step = int(saved["step"])
        Log.i(f"Model restored ({frac:.1%} keys) from "
              f"{args.resume_checkpoint} at step {step}; optimizer state "
              + ("restored" if ok else "mismatch, fresh"))

    if args.variant == "baseline":
        train_step = make_baseline_det_step(model, optimizer, scheduler)
    elif args.variant == "advtrain":
        train_step = make_advtrain_det_step(model, optimizer, scheduler)
    else:
        train_step = make_afan_det_step(model, optimizer, scheduler,
                                        afan_config_for(args))
    generator = torch.Generator(device).manual_seed(args.seed)
    evaluator = DetectionEvaluator(
        eval_loader, make_detect_fn(model), num_classes,
        protocol="coco" if args.dataset.startswith("coco") else "voc")

    def to_device(batch):
        return (torch.from_numpy(batch.images).to(device),
                torch.from_numpy(batch.boxes).to(device),
                torch.from_numpy(batch.labels).long().to(device),
                torch.from_numpy(batch.valid).to(device))

    losses = deque(maxlen=100)
    t0 = time.time()
    should_stop = step >= args.num_steps_to_finish
    while not should_stop:
        for batch in Prefetcher(train_loader):
            metrics = train_step(*to_device(batch), generator)
            step += 1
            losses.append(float(metrics["loss"]))
            if not np.isfinite(losses[-1]):
                raise FloatingPointError(f"loss {losses[-1]} at step {step}")
            should_stop = step >= args.num_steps_to_finish
            if step % args.num_steps_to_display == 0:
                rate = (args.num_steps_to_display * args.batch_size
                        / max(time.time() - t0, 1e-9))
                t0 = time.time()
                Log.i(f"[Step {step}] Avg. Loss = "
                      f"{sum(losses) / len(losses):.6f} "
                      f"({rate:.2f} samples/sec)")
            if step % args.num_steps_to_snapshot == 0 or should_stop:
                path = save_detect_checkpoint(
                    os.path.join(args.outputs_dir, f"model-{step}.pt"),
                    model, optimizer, scheduler, step)
                Log.i(f"Model saved to {path}")
            if args.eval_every and step % args.eval_every == 0:
                Log.i(f"[Step {step}] mAP = {evaluator.evaluate()[0]:.4f}")
            if should_stop:
                break

    mean_ap, detail = evaluator.evaluate()
    Log.i(f"final mAP = {mean_ap:.4f}\n{detail}")
    return mean_ap


if __name__ == "__main__":
    main()
