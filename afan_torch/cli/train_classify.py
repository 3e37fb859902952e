"""CIFAR training CLI — the PyTorch counterpart of
``afan/cli/train_classify.py``: base / ALFA / learnable-η, on the card unless
``--device cpu``.

Canonical runs (reference `Classification/cmd/`)::

    python -m afan_torch.cli.train_classify --mode base    --seed 3
    python -m afan_torch.cli.train_classify --mode alfa    --gamma 0.5 --steps 5
    python -m afan_torch.cli.train_classify --mode learnable

The model is ResNet-56s at full width; weights start from a seeded random
init. Data is CIFAR from ``--data`` or, where none is found, ``afan``'s
deterministic synthetic CIFAR. Augmentation (crop + flip) runs on the card
unless ``--host_aug``; ``--device_data`` keeps the whole train split on the
card (ALFA mode), and ``--epoch_scan`` (ALFA mode; it implies
``--device_data``) trains each epoch as replays of one CUDA graph of the
step (:class:`afan_torch.train.loop.AlfaEpochScan`; eagerly on the CPU).
Base and ALFA run SGD with its lr and step count on the device
(:class:`afan_torch.train.optim.CapturableSGD`). Outputs, as the
reference's: per-epoch train/val/test accuracy, ``checkpoint.pt`` and
best-on-val ``best_model.pt``
(`main_perturb.py:116-136`), ``result.pkl`` accuracy curves and
``result_norm.pkl`` perturbation-norm telemetry (`main_perturb.py:138-150`)
in ``--save_dir``. ``--num_devices N`` above 1 trains data-parallel on N
cards, one process each (``--device cpu``: N gloo processes): every rank
draws the global batch of the one-process run and keeps its rows, the
step computes the global batch's function (:mod:`afan_torch.parallel.mesh`),
validation sums the ranks' counts, and rank 0 alone logs and writes;
``--device_data`` and ``--epoch_scan`` are off under it, as in ``afan``. On
the card ``--num_devices`` defaults to every visible card. ``--bf16`` makes bfloat16 the model's compute dtype in
every mode (``afan``'s ``ResNetS(dtype=bf16)``); parameters, optimizer
state and checkpoints stay float32.
"""
from __future__ import annotations

import argparse
import os
import pickle
import sys
import time

import numpy as np
import torch

from ..data.cifar import (augment_batch_device, cifar10_dataloaders,
                          cifar100_dataloaders)
from ..data.prefetch import Prefetcher
from ..parallel import mesh as dp
from ..parallel.launch import launch_cli
from ..models.resnet_s import LEARNABLE_TAPS, ResNetS
from ..train.checkpoint import (load_checkpoint, load_training_state,
                                overlap_restore, restore_optimizer,
                                save_classify_checkpoint)
from ..train.loop import (AlfaConfig, LearnableConfig, make_alfa_step,
                          make_base_step, make_device_data_alfa_step,
                          make_epoch_scan_alfa, make_eval_step,
                          make_learnable_step)
from ..train.optim import (capturable_sgd, learnable_sgd,
                           multistep_warmup_schedule,
                           multistep_warmup_schedule_tensor)
from ..utils.device import resolve_device
from ..utils.logging import Log
from ..utils.meters import AverageMeter


def get_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="A-FAN CIFAR training (PyTorch, CUDA)")
    # base settings (`main_perturb.py:27-34`)
    p.add_argument("--mode", choices=["base", "alfa", "learnable"],
                   default="alfa")
    p.add_argument("--data", type=str, default="../data")
    p.add_argument("--dataset", choices=["cifar10", "cifar100"],
                   default="cifar10")
    p.add_argument("--print_freq", default=50, type=int)
    p.add_argument("--seed", default=None, type=int)
    p.add_argument("--gpu", default=None, type=str,
                   help="accepted for reference-script compat; ignored "
                        "(see --device)")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default) or cpu; the port never falls back "
                        "to the CPU by itself")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--save_dir", default="res56s_adv_aug", type=str)
    # optimizer (`main_perturb.py:36-42`)
    p.add_argument("--batch_size", type=int, default=128)
    p.add_argument("--lr", default=0.1, type=float)
    p.add_argument("--momentum", default=0.9, type=float)
    p.add_argument("--weight_decay", default=5e-4, type=float)
    p.add_argument("--epochs", default=200, type=int)
    p.add_argument("--decreasing_lr", default="50,150")
    # attack (`main_perturb.py:44-50`)
    p.add_argument("--steps", default=5, type=int)
    p.add_argument("--perturb_idx", default=13, type=int)
    p.add_argument("--gamma", default=1.5, type=float,
                   help="PGD step size, /255 applied internally")
    p.add_argument("--eps", default=2.0, type=float)
    p.add_argument("--randinit", action="store_true")
    p.add_argument("--clip", action="store_true")
    p.add_argument("--pgd_step_mode", choices=["sign", "grad"],
                   default="sign",
                   help="'grad' = normalized raw-gradient steps "
                        "(arxiv 2312.01260)")
    p.add_argument("--pgd_random_steps", action="store_true",
                   help="per-step random step size in (0, 2*gamma) "
                        "(WITCHcraft, arxiv 1911.07989)")
    # ETA (`main_learnable.py:52-55`)
    p.add_argument("--w_lr", default=0.01, type=float)
    p.add_argument("--init_weight", default=1.0 / 9, type=float)
    p.add_argument("--l1_coef", default=1.0, type=float)
    # afan's accelerator options
    p.add_argument("--bf16", action="store_true",
                   help="bfloat16 compute in the model (parameters stay "
                        "float32)")
    p.add_argument("--num_devices", type=int, default=None,
                   help="data-parallel devices: every visible card by "
                        "default; with --device cpu, N processes")
    p.add_argument("--limit_batches", type=int, default=0,
                   help="debug: cap batches per epoch")
    p.add_argument("--synthetic_ok", action="store_true", default=True)
    p.add_argument("--host_aug", action="store_true",
                   help="augment on the host (numpy) instead of on the "
                        "card; the card's augmentation has the same "
                        "distribution and is the default")
    p.add_argument("--device_data", action="store_true",
                   help="keep the whole train split on the card and "
                        "gather + augment each batch there (alfa mode)")
    p.add_argument("--epoch_scan", action="store_true",
                   help="alfa mode: train each epoch as replays of one "
                        "CUDA graph of the device-data step (implies "
                        "--device_data; base and learnable ignore it)")
    return p


def build_model(args, generator: torch.Generator) -> ResNetS:
    classes = 100 if args.dataset == "cifar100" else 10
    init_w = args.init_weight if args.mode == "learnable" else 1.0
    return ResNetS((9, 9, 9), classes, init_w, generator=generator,
                   dtype=torch.bfloat16 if args.bf16 else torch.float32)


def build_optimizer(args, model: ResNetS, steps_per_epoch: int):
    """SGD at the warmup + multistep schedule. The one-group modes (base,
    alfa) keep its lr and step count on the device (:class:`CapturableSGD`,
    which ``--epoch_scan`` needs); learnable's two groups are
    ``torch.optim.SGD`` under ``LambdaLR``."""
    milestones = [int(e) * steps_per_epoch
                  for e in args.decreasing_lr.split(",")]
    if args.mode == "learnable":
        schedule = multistep_warmup_schedule(args.lr, milestones, 0.1,
                                             warmup_steps=steps_per_epoch)
        return learnable_sgd(model, schedule, args.lr, args.w_lr,
                             args.momentum, args.weight_decay)
    return capturable_sgd(
        list(model.parameters()),
        multistep_warmup_schedule_tensor(args.lr, milestones, 0.1,
                                         warmup_steps=steps_per_epoch),
        args.lr, args.momentum, args.weight_decay)


def alfa_config(args) -> AlfaConfig:
    return AlfaConfig(tap=args.perturb_idx, steps=args.steps,
                      gamma=args.gamma / 255, eps=args.eps / 255,
                      randinit=args.randinit, clip=args.clip,
                      step_mode=args.pgd_step_mode,
                      random_steps=args.pgd_random_steps)


def build_step(args, model, optimizer, scheduler, device_data: bool):
    if args.mode == "base":
        return make_base_step(model, optimizer, scheduler)
    if args.mode == "alfa":
        cfg = alfa_config(args)
        if device_data:
            return make_device_data_alfa_step(model, optimizer, scheduler,
                                              cfg, args.batch_size)
        return make_alfa_step(model, optimizer, scheduler, cfg)
    cfg = LearnableConfig(taps=LEARNABLE_TAPS, steps=args.steps,
                          gamma=args.gamma / 255, eps=args.eps / 255,
                          randinit=args.randinit, clip=args.clip,
                          l1_coef=args.l1_coef)
    return make_learnable_step(model, optimizer, scheduler, cfg)


def validate(eval_step, loader, device) -> float:
    """Top-1 in percent; under data parallelism each rank evaluates its
    rows of each batch and the ranks' counts are summed."""
    correct, count = 0, 0
    for x, y in loader:
        if dp.world_size() > 1:
            rows = dp.rank_rows(len(x))
            x, y = x[rows], y[rows]
            if not len(x):
                continue
        out = eval_step(torch.from_numpy(x).to(device),
                        torch.from_numpy(y).to(device))
        correct += int(out["correct"])
        count += int(out["count"])
    if dp.world_size() > 1:
        correct, count = (int(v) for v in dp.sum_numpy(
            np.asarray([correct, count], np.int64)))
    return 100.0 * correct / max(count, 1)


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    args = get_parser().parse_args(argv)
    device = resolve_device(args.device)
    n_ranks = dp.resolve_size(args.num_devices, device)
    dp.check_divisible(args.batch_size, n_ranks)
    if n_ranks > 1 and dp.data_group() is None:
        return launch_cli(__name__, argv, n_ranks, device)
    os.makedirs(args.save_dir, exist_ok=True)
    Log.initialize(quiet=not dp.is_main())
    Log.i(f"args: {vars(args)}; device {device}; data-parallel ranks "
          f"{dp.world_size()}")
    if dp.world_size() > 1 and (args.device_data or args.epoch_scan):
        Log.i("--device_data/--epoch_scan are off under data parallelism "
              "(as in afan): each rank steps on its rows of host batches")
        args.device_data = args.epoch_scan = False

    seed = args.seed if args.seed is not None else 0
    loaders = (cifar10_dataloaders if args.dataset == "cifar10"
               else cifar100_dataloaders)
    train_loader, val_loader, test_loader = loaders(
        args.batch_size, args.batch_size, data_dir=args.data, seed=seed)
    device_data = (args.device_data or args.epoch_scan) and args.mode == "alfa"
    scan = args.epoch_scan and device_data
    device_aug = not args.host_aug and args.dataset == "cifar10"
    if device_aug:
        train_loader.raw = True          # uint8 batches, augmented on device

    steps_per_epoch = len(train_loader)
    if args.limit_batches:
        steps_per_epoch = min(steps_per_epoch, args.limit_batches)

    torch.manual_seed(dp.rank_seed(seed))
    model = build_model(args, torch.Generator().manual_seed(seed)).to(device)
    optimizer, scheduler = build_optimizer(args, model, steps_per_epoch)
    if scan:
        epoch_fn = make_epoch_scan_alfa(model, optimizer, alfa_config(args),
                                        args.batch_size, steps_per_epoch)
    else:
        train_step = build_step(args, model, optimizer, scheduler,
                                device_data)
    eval_step = make_eval_step(model)
    generator = torch.Generator(device=device).manual_seed(dp.rank_seed(seed))

    start_epoch, step, best_prec1 = 0, 0, 0.0
    ckpt_path = os.path.join(args.save_dir, "checkpoint.pt")
    if args.resume and os.path.isfile(ckpt_path):
        frac = overlap_restore(model, load_checkpoint(ckpt_path))
        saved = load_training_state(ckpt_path)
        ok = restore_optimizer(optimizer, saved["optimizer"])
        if ok:
            scheduler.load_state_dict(saved["scheduler"])
        Log.i(f"resume: restored {frac:.1%} of the model from {ckpt_path}; "
              f"optimizer state "
              + ("restored" if ok else "structure mismatch — kept fresh"))
        start_epoch = int(saved["epoch"])
        step = int(saved["step"])
        best_prec1 = float(saved["best_prec1"])
    dp.replicate_state(model, optimizer)

    all_result = {"train": [], "ta": [], "test_ta": []}
    all_norm = {"l2": {}, "linf": {}}
    if device_data:
        data_x = torch.from_numpy(train_loader.x).to(device)
        data_y = torch.from_numpy(train_loader.y).to(device)
        Log.i(f"device-resident train split: {data_x.nbytes / 1e6:.0f} MB")

    for epoch in range(start_epoch, args.epochs):
        losses, top1 = AverageMeter(), AverageMeter()
        norm_l2, norm_linf = AverageMeter(), AverageMeter()
        t0, seen = time.time(), 0
        if device_data:
            perm = torch.randperm(len(data_x), generator=generator,
                                  device=device)
        if scan:
            seen = scan_epoch(epoch_fn, data_x, data_y, perm, generator,
                              epoch, (losses, top1, norm_l2, norm_linf))
            step += steps_per_epoch
            batches = ()
        elif device_data:
            batches = range(steps_per_epoch)
        else:
            batches = Prefetcher(train_loader)
        for i, batch in enumerate(batches):
            if i >= steps_per_epoch:
                break
            if device_data:
                metrics = train_step(data_x, data_y, perm, i, generator)
            else:
                bx, by = batch[:2]
                if dp.world_size() > 1:
                    bx, by = dp.shard_batch(bx, by)
                x = torch.from_numpy(bx).to(device, non_blocking=True)
                y = torch.from_numpy(by).to(device, non_blocking=True)
                if device_aug:
                    x = augment_batch_device(x, generator)
                if args.mode == "base":
                    metrics = train_step(x, y)
                else:
                    metrics = train_step(x, y, generator)
            step += 1
            seen += args.batch_size
            if i % args.print_freq == 0:
                loss = float(metrics["loss"])
                if not np.isfinite(loss):
                    raise FloatingPointError(
                        f"loss {loss} at epoch {epoch} batch {i}")
                losses.update(loss, args.batch_size)
                top1.update(float(metrics["accuracy"]), args.batch_size)
                if "pert_l2" in metrics:
                    norm_l2.update(float(metrics["pert_l2"].mean()))
                    norm_linf.update(float(metrics["pert_linf"].mean()))
                Log.i(f"Epoch: [{epoch}][{i}/{steps_per_epoch}] "
                      f"Loss {losses.val:.4f} ({losses.avg:.4f}) "
                      f"Acc {top1.val:.3f} ({top1.avg:.3f})")
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        dt = time.time() - t0
        Log.i(f"epoch {epoch}: {seen / max(dt, 1e-9):.1f} imgs/sec")
        if args.mode != "base":
            all_norm["l2"][epoch + 1] = norm_l2.avg
            all_norm["linf"][epoch + 1] = norm_linf.avg

        tacc = validate(eval_step, val_loader, device)
        test_tacc = validate(eval_step, test_loader, device)
        Log.i(f"epoch {epoch}: val {tacc:.2f} test {test_tacc:.2f}")
        all_result["train"].append(top1.avg)
        all_result["ta"].append(tacc)
        all_result["test_ta"].append(test_tacc)

        is_best = tacc > best_prec1
        best_prec1 = max(tacc, best_prec1)
        if dp.is_main():
            save_classify_checkpoint(ckpt_path, model, optimizer, scheduler,
                                     epoch + 1, step, best_prec1)
            if is_best:
                save_classify_checkpoint(
                    os.path.join(args.save_dir, "best_model.pt"), model,
                    optimizer, scheduler, epoch + 1, step, best_prec1)
            _dump_results(args.save_dir, all_result, all_norm)

    Log.i(f"done; best val accuracy {best_prec1:.2f}")
    return best_prec1


def scan_epoch(epoch_fn, data_x, data_y, perm, generator, epoch,
               meters) -> int:
    """One ``--epoch_scan`` epoch: the stacked losses are checked once, and
    the meters take the epoch's means. Returns the images seen."""
    losses, top1, norm_l2, norm_linf = meters
    em = {k: v.cpu().numpy()
          for k, v in epoch_fn(data_x, data_y, perm, generator).items()}
    bad = np.flatnonzero(~np.isfinite(em["loss"]))
    if bad.size:
        raise FloatingPointError(
            f"loss {em['loss'][bad[0]]} at epoch {epoch} batch {bad[0]}")
    seen = epoch_fn.steps_per_epoch * epoch_fn.batch_size
    losses.update(float(em["loss"].mean()), seen)
    top1.update(float(em["accuracy"].mean()), seen)
    norm_l2.update(float(em["pert_l2"].mean()))
    norm_linf.update(float(em["pert_linf"].mean()))
    Log.i(f"Epoch: [{epoch}] {epoch_fn.steps_per_epoch} steps "
          f"({epoch_fn.eager_steps} eager and {epoch_fn.replays} graph "
          f"replays so far): last-step loss {em['loss'][-1]:.4f}, "
          f"mean loss {losses.avg:.4f}, mean acc {top1.avg:.3f}, "
          f"perturbation L2 {norm_l2.avg:.4f} Linf {norm_linf.avg:.6f}")
    return seen


def _dump_results(save_dir, all_result, all_norm):
    """result.pkl + result_norm.pkl (`main_perturb.py:138-150` dumps)."""
    with open(os.path.join(save_dir, "result.pkl"), "wb") as f:
        pickle.dump(all_result, f)
    with open(os.path.join(save_dir, "result_norm.pkl"), "wb") as f:
        pickle.dump(all_norm, f)


if __name__ == "__main__":
    main()
