"""Classification inference — the PyTorch counterpart of
``afan/cli/infer_classify.py`` (`Classification/main_inference.py`): load a
checkpoint into ResNet-56s and report test-set top-1 on the card unless
``--device cpu``.

It reads this port's ``checkpoint.pt`` / ``best_model.pt`` and the
reference's own checkpoints (``sequential_model.*`` keys, bare or under
``state_dict``), by overlap restore. ``--pgd`` reports robust accuracy
instead, under input PGD-``--pgd_steps`` (`afan/cli/infer_classify.py:72-86`:
steps of ``--pgd_gamma``/255 from a uniform start within ``--pgd_eps``/255),
through :func:`afan_torch.eval.robustness.make_robust_eval_step`, whose
sign steps run the PGD-update kernel on the card.
"""
from __future__ import annotations

import argparse
import os

import torch

from ..data.cifar import cifar10_dataloaders, cifar100_dataloaders
from ..eval.robustness import make_robust_eval_step
from ..models.resnet_s import resnet56
from ..train.checkpoint import load_checkpoint, overlap_restore
from ..train.loop import make_eval_step
from ..utils.device import resolve_device
from ..utils.logging import Log
from .train_classify import validate


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--data", type=str, default="../data")
    p.add_argument("--dataset", choices=["cifar10", "cifar100"],
                   default="cifar10")
    p.add_argument("--batch_size", type=int, default=128)
    p.add_argument("--seed", type=int, default=0,
                   help="data seed (the synthetic fallback regenerates its "
                        "class templates from it)")
    p.add_argument("--pretrained", type=str, required=True,
                   help="checkpoint path (checkpoint.pt / best_model.pt or "
                        "a reference checkpoint)")
    p.add_argument("--pgd", action="store_true",
                   help="report robust accuracy under input PGD")
    p.add_argument("--pgd_steps", type=int, default=3)
    p.add_argument("--pgd_gamma", type=float, default=2.0)
    p.add_argument("--pgd_eps", type=float, default=8.0)
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default) or cpu")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    Log.initialize()
    if not os.path.exists(args.pretrained):
        raise FileNotFoundError(args.pretrained)

    loaders = (cifar10_dataloaders if args.dataset == "cifar10"
               else cifar100_dataloaders)
    _, _, test_loader = loaders(args.batch_size, args.batch_size,
                                data_dir=args.data, seed=args.seed)
    classes = 100 if args.dataset == "cifar100" else 10
    model = resnet56(num_classes=classes)
    frac = overlap_restore(model, load_checkpoint(args.pretrained))
    model.to(device)
    Log.i(f"loaded {frac:.1%} of the model from {args.pretrained}")

    if args.pgd:
        generator = torch.Generator(device=device).manual_seed(args.seed)
        step = make_robust_eval_step(
            model, classes, steps=args.pgd_steps, gamma=args.pgd_gamma / 255,
            eps=args.pgd_eps / 255, generator=generator)
        acc = validate(step, test_loader, device)
        Log.i(f"robust accuracy (PGD-{args.pgd_steps}): {acc:.2f}% of "
              f"{len(test_loader.x)} images")
        return acc
    acc = validate(make_eval_step(model), test_loader, device)
    Log.i(f"test accuracy: {acc:.2f}% of {len(test_loader.x)} images")
    return acc


if __name__ == "__main__":
    main()
