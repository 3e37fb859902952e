"""Detection evaluation CLI — the PyTorch counterpart of
``afan/cli/eval_detect.py``, on the card unless ``--device cpu``: the
reference's `Detection/eval.py` (clean mAP), `eval_rob_ori.py` (mAP under
input PGD), `eval_sat_layers.py` (mAP from an interpolated adversarial
feature) and `eval_loss_vis.py` (weight-space loss probe) behind ``--task``,
with ``afan``'s two analysis tasks: ``sat_vis`` (spectrum feature-map PNGs)
and ``input_surface`` (the ALP input-space loss surface, pickled).

``--task rob`` is the working `eval_rob_ori.py` path: the reference's
`eval_rob.py` calls an ``untarget_PGD`` that is commented out.

The parser is ``afan``'s, flag aliases included, plus ``--device``. The
data are ``afan``'s synthetic VOC test images at batch 1 (reading VOC from
disk is not ported yet); the weights start from a seeded random init, then
``--checkpoint`` (a port checkpoint) and ``--torch_checkpoint`` (a
reference ``.pth``; the port keeps the reference's key names) are
overlap-restored. Every attack step runs the PGD-update kernel at the
attacked tensor's shape and every detect or loss forward the NMS kernel, on
the card.
"""
from __future__ import annotations

import argparse
import ast
import os
import pickle

import numpy as np
import torch

from ..data.registry import detection_loaders
from ..eval.det_map import (DetectionEvaluator, evaluate_detections,
                            ground_truth)
from ..eval.feature_vis import make_spectrum_features_fn, save_spectrum_pngs
from ..eval.robustness import (loss_landscape_probe, make_detection_pgd_fn,
                               make_input_surface_fn,
                               make_sat_layer_detect_fn,
                               perturb_weight_directions)
from ..models.frcnn import FRCNNConfig, FasterRCNN
from ..train.checkpoint import load_checkpoint, overlap_restore
from ..train.detect_loop import make_detect_fn
from ..utils.device import resolve_device
from ..utils.logging import Log

TASKS = ("map", "rob", "sat_layers", "loss_vis", "sat_vis", "input_surface")
LOSS_VIS_SCALES = (0.0, 0.5, 1.0, 2.0, 5.0)


def get_parser():
    p = argparse.ArgumentParser(
        description="A-FAN detection eval (PyTorch, CUDA)")
    p.add_argument("--task", choices=TASKS, default="map")
    p.add_argument("-s", "--dataset", default="voc2007")
    p.add_argument("-b", "--backbone", default="resnet50")
    p.add_argument("-d", "--data_dir", default="./data")
    p.add_argument("-c", "--checkpoint", required=False, default=None)
    p.add_argument("--torch_checkpoint", default=None,
                   help="a reference `Detection/model.py` torch .pth, "
                        "overlap-restored (model.py:200-217)")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default) or cpu; the port never falls back "
                        "to the CPU by itself")
    p.add_argument("--image_min_side", type=float, default=600.0)
    p.add_argument("--image_max_side", type=float, default=1000.0)
    p.add_argument("--anchor_sizes", type=str, default="[128, 256, 512]")
    p.add_argument("--anchor_ratios", type=str,
                   default="[(1, 2), (1, 1), (2, 1)]")
    p.add_argument("--rpn_pre_nms_top_n", type=int, default=6000)
    p.add_argument("--rpn_post_nms_top_n", type=int, default=300)
    p.add_argument("--convert", action="store_true",
                   help="reference legacy-key remap flag (`model.py:420`); "
                        "accepted: the port keeps the reference's keys")
    # robustness (the reference's eval scripts name these --steps/--gamma/
    # --eps)
    p.add_argument("--pgd_steps", "--steps", type=int, default=3,
                   dest="pgd_steps")
    p.add_argument("--pgd_gamma", "--gamma", type=float, default=2.0,
                   dest="pgd_gamma")
    p.add_argument("--pgd_eps", "--eps", type=float, default=8.0,
                   dest="pgd_eps")
    p.add_argument("--pgd_bailout_tol", type=float, default=None,
                   help="stop the eval attack once the relative loss "
                        "change per step drops below this")
    # sat layers (`eval_sat_layers.py:42-49`)
    p.add_argument("--sat_tap", "--pertub_idx", type=int, default=2,
                   dest="sat_tap")
    p.add_argument("--sat_alpha", type=float, default=0.5)
    p.add_argument("--sat_layer", type=int, default=None,
                   help="spectrum index k of a --spectrum-point lerp: "
                        "alpha = k/(spectrum-1) (overrides --sat_alpha)")
    p.add_argument("--mix", action="store_true",
                   help="AFN the interpolated feature with the clean "
                        "stats (`evaluator.py:168-170` argument order)")
    # sat_vis (`train_sat_vis.py:129-138` feature dumps)
    p.add_argument("--spectrum", type=int, default=5)
    p.add_argument("--gamma_se", type=float, default=0.9)
    p.add_argument("--dump_dir", default="feature_maps")
    p.add_argument("--limit_images", type=int, default=4)
    # input_surface (the ALP probe, `py/evaluator_alp_zzy.py:158-161`)
    p.add_argument("--grid_points", type=int, default=40)
    p.add_argument("--grid_extent", type=float, default=0.1)
    p.add_argument("--surface_out", default="alp_adv.pkl")
    return p


def frcnn_config(args, num_classes: int) -> FRCNNConfig:
    return FRCNNConfig(
        backbone=args.backbone, num_classes=num_classes,
        anchor_sizes=tuple(ast.literal_eval(args.anchor_sizes)),
        anchor_ratios=tuple(ast.literal_eval(args.anchor_ratios)),
        eval_pre_nms_top_n=args.rpn_pre_nms_top_n,
        eval_post_nms_top_n=args.rpn_post_nms_top_n)


def build_model(args, num_classes: int, device: torch.device) -> FasterRCNN:
    """The seeded model, then the checkpoints' overlapping entries."""
    model = FasterRCNN(frcnn_config(args, num_classes))
    model.reset_parameters(torch.Generator().manual_seed(0))
    for flag, path in (("checkpoint", args.checkpoint),
                       ("torch_checkpoint", args.torch_checkpoint)):
        if path:
            frac = overlap_restore(model, load_checkpoint(path))
            Log.i(f"Loaded weights ({frac:.1%} of the entries) from {path} "
                  f"(--{flag})")
    return model.to(device).eval()


def batch_tensors(batch, device: torch.device):
    """(images, gt boxes, gt classes, gt valid) of a loader batch on
    ``device``."""
    return (torch.from_numpy(batch.images).to(device),
            torch.from_numpy(batch.boxes).to(device),
            torch.from_numpy(batch.labels).long().to(device),
            torch.from_numpy(batch.valid).to(device))


def main(argv=None):
    args = get_parser().parse_args(argv)
    device = resolve_device(args.device)
    Log.initialize()
    _, eval_loader, num_classes = detection_loaders(
        args.dataset, args.data_dir, 1, args.image_min_side,
        args.image_max_side)
    model = build_model(args, num_classes, device)
    generator = torch.Generator(device)

    if args.task == "map":
        mean_ap, detail = DetectionEvaluator(
            eval_loader, make_detect_fn(model), num_classes).evaluate()
        Log.i(f"mean AP = {mean_ap:.4f}\n{detail}")
        return mean_ap

    if args.task == "rob":
        # `evaluator.ori_rob_evaluate` (`evaluator.py:90-133`): attack each
        # image with eval_PGD (it needs the ground truth), then the clean
        # detect path on the adversarial image, through the standard
        # evaluator over a loader of attacked batches
        attack = make_detection_pgd_fn(model, args.pgd_steps,
                                       args.pgd_gamma / 255,
                                       args.pgd_eps / 255,
                                       bailout_tol=args.pgd_bailout_tol)

        class _AttackedLoader:
            samples = eval_loader.samples

            def __iter__(self):
                for b in eval_loader:
                    b.images = attack(*batch_tensors(b, device),
                                      generator.manual_seed(1))
                    yield b

        mean_ap, detail = DetectionEvaluator(
            _AttackedLoader(), make_detect_fn(model), num_classes).evaluate()
        Log.i(f"robust mean AP = {mean_ap:.4f}\n{detail}")
        return mean_ap

    if args.task == "sat_layers":
        alpha = (args.sat_alpha if args.sat_layer is None
                 else args.sat_layer / max(args.spectrum - 1, 1))
        detect = make_sat_layer_detect_fn(
            model, args.sat_tap, alpha, attack_steps=args.pgd_steps,
            gamma=args.pgd_gamma / 255, eps=args.pgd_eps / 255, mix=args.mix)
        # its own loop: the attack needs the ground truth
        # (`evaluator.py:135-183`)
        all_ids, all_boxes, all_classes, all_probs = [], [], [], []
        for b in eval_loader:
            boxes, probs, keep = (t.cpu().numpy() for t in detect(
                *batch_tensors(b, device), generator.manual_seed(1)))
            shown = keep & (probs > DetectionEvaluator.PROB_THRESH)
            for j, image_id in enumerate(b.image_ids):
                sel = np.nonzero(shown[j])
                for p_idx, c in zip(*sel):
                    all_ids.append(image_id)
                    all_boxes.append(boxes[j, p_idx, c] / b.scales[j])
                    all_classes.append(int(c))
                    all_probs.append(float(probs[j, p_idx, c]))
        if all_ids:
            mean_ap, _ = evaluate_detections(
                num_classes, ground_truth(eval_loader.samples), all_ids,
                np.stack(all_boxes), np.asarray(all_classes),
                np.asarray(all_probs))
        else:
            mean_ap = 0.0
        Log.i(f"sat-layer (tap {args.sat_tap}, alpha {alpha}, "
              f"mix {args.mix}) mean AP = {mean_ap:.4f}")
        return mean_ap

    if args.task == "sat_vis":
        # one PNG per spectrum point and image (`Detection/train_sat_vis.py:
        # 129-138`, `attack_algo.py:268-292`)
        fn = make_spectrum_features_fn(model, args.sat_tap,
                                       args.gamma_se / 255,
                                       steps=args.pgd_steps,
                                       eps=args.pgd_eps / 255,
                                       n_points=args.spectrum)
        written = done = 0
        for b in eval_loader:
            spec = fn(*batch_tensors(b, device), generator.manual_seed(done))
            written += save_spectrum_pngs(spec, b.images, b.image_ids,
                                          args.dump_dir)
            done += len(b.image_ids)
            if args.limit_images and done >= args.limit_images:
                break
        Log.i(f"wrote {written} PNGs ({done} images x {args.spectrum} "
              f"spectrum points) to {args.dump_dir}")
        return written

    if args.task == "input_surface":
        # the ALP loss-surface probe (`Detection/py/eval_ALP_zzy.py`,
        # `evaluator_alp_zzy.py:131-186`): per image a grid of losses over
        # sign-gradient x Rademacher input directions, pickled as
        # {image_id: (points, points) array}; --limit_images bounds the
        # images (the reference samples 20)
        fn = make_input_surface_fn(model, args.grid_extent, args.grid_points)
        surfaces = {}
        for i, b in enumerate(eval_loader):
            if args.limit_images and i >= args.limit_images:
                break
            z = fn(*batch_tensors(b, device), generator.manual_seed(i))
            surfaces[b.image_ids[0]] = z.cpu().numpy()
        os.makedirs(os.path.dirname(args.surface_out) or ".", exist_ok=True)
        with open(args.surface_out, "wb") as f:
            pickle.dump(surfaces, f)
        Log.i(f"wrote {len(surfaces)} loss surfaces "
              f"({args.grid_points}x{args.grid_points}) to "
              f"{args.surface_out}")
        return surfaces

    # loss_vis: the training losses of the first test image at weights
    # shifted along one random direction (`eval_loss_vis.py`)
    b = next(iter(eval_loader))
    tensors = batch_tensors(b, device)
    dirs = perturb_weight_directions(model, np.random.RandomState(0))

    def loss_at():
        return model.losses(*tensors, generator.manual_seed(0)).total()

    losses = loss_landscape_probe(loss_at, model, dirs, LOSS_VIS_SCALES)
    for s, loss in zip(LOSS_VIS_SCALES, losses):
        Log.i(f"scale {s}: loss {loss:.4f}")
    return losses


if __name__ == "__main__":
    main()
