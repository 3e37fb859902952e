"""Smoke run of the PyTorch port (afan_torch) on one CUDA card.

Run from the repository root, with one card and no arguments:

    python3 chip_smoke.py

``--only nms`` runs phases 1-3, 5 and the NMS timings of phase 6 (the
greedy-NMS kernel alone, no server); ``--only ce`` runs phases 1, 2, 7 and
the kernel timings of phase 10 (the upsample + CE kernels alone, no
trainer); ``--only seg`` phases 1, 2 and
7-10; ``--only det`` phases 1-6; ``--only cls`` phases 1, 2 and 11-14 (phase
11 then lacks the segmentation ascents' shapes); ``--only dettrain`` phases
1, 2 and 15-17. The kernels line then lists the kernels of the phases that
ran; without phase 8 the upsample + CE kernels have no launch count (null).

Phases (any failure exits non-zero):
  1. the device: name, power limit, TF32 settings;
  2. build the hand-written CUDA kernels from afan_torch/csrc, one nvcc per
     source, all at once;
  3. hold the greedy-NMS kernel against its plain PyTorch version on the
     card: the reference's golden fixture, uniform and clustered boxes
     (N = 12000 too), invalid slots, plus_one off, a batched call, and the
     edges of its per-word scan (NMS_EDGE_CASES) — keep masks equal;
  4. serve frames through the detection server's FrameBatcher with the
     ResNet-50 Faster R-CNN at full width (seeded random weights, 21 VOC
     classes, canvas 608x1008, max_batch 4), in batches of 1 and 4, and
     check the answers and that the main path launched the kernel;
  5. hold the post-backbone path with the kernel against the same path with
     the plain NMS: proposals and keep masks identical;
  6. time the detect call and the peak memory, and the NMS kernel (CUDA
     events; each pass's device time from torch.profiler), its plain
     version and its bound at the detect call's two NMS calls, then the
     kernel where most boxes are kept (G=4, N=6000 uniform) and at the
     training proposal NMS (G=1 and 4, N=12000, uniform and clustered);
  7. hold the upsample + CE forward and backward kernels against their
     plain version on eleven geometries (city768 at B=2 and B=8, city512,
     voc513 with odd H, two focal cases, tiny32, 9x7 -> 33x28, 1x1 -> 4x4,
     6x5 -> 24x20, an entry whose labels are all 255): sums within 1e-5,
     gradient within 1.1e-5 (max abs error over max abs value), two runs
     bit-equal;
  8. train the A-FAN DeepLabv3+ ResNet-50 at full width through
     ``afan_torch.cli.train_segment.main`` (Cityscapes final recipe: OS 16,
     19 classes, crop 768, batch 4, SE tap 2 with AFN on the spectrum's
     adversarial point, SD concat, mix_sd, synthetic data, seeded random
     weights) for a few iterations and one validation: finite losses, a
     checkpoint, and the kernels' launch counts;
  9. one A-FAN step with the kernels against one with the plain op, from
     the same weights, batch and dropout masks (cuDNN deterministic, no
     TF32): losses within 1e-4, logits-conv gradient within 1e-4;
 10. time the A-FAN and base steps and their peak memory, profile where
     the A-FAN step's device time goes, and time each upsample + CE kernel
     in turns with the library composition F.interpolate + F.cross_entropy
     (library, kernel, kernel, library, twice) and its plain version at the
     step's shapes, with what ptxas and the card report of each kernel
     (registers, shared memory, spills, blocks per SM);
 11. hold the PGD-update kernel against its plain PyTorch version, bit for
     bit (NaN included): the sizes of tests/test_kernels.py, odd counts,
     misaligned views, the ALFA and learnable tap shapes and the
     segmentation ascents' shapes, gradients with zeros, -0, denormals, NaN
     and infinities, with and without the clip;
 12. train ALFA ResNet-56 on CIFAR-10 at full width through
     ``afan_torch.cli.train_classify.main`` (batch 128, tap 13, 5 PGD
     steps, synthetic data, seeded random weights) for a few batches, one
     validation and one test pass: finite losses, the reference's four
     output files, and exactly 5 kernel launches per step; then a few
     batches of the learnable-eta mode (27 launches per step) and of ALFA
     with clip, randinit and the train split kept on the card; then the
     inference CLI on the best checkpoint;
 13. one ALFA step with the kernel against one with the plain update, from
     the same weights and batch (cuDNN deterministic, no TF32): adversarial
     feature bit-equal, loss, perturbation norms and updated parameters
     within 1e-6;
 14. time the ALFA, base and learnable steps and their peak memory, the
     ALFA step with the plain update in turns with the kernel, profile
     where the ALFA step's device time goes, and time the kernel, its plain
     version and its bound at the ALFA tap shape;
 15. train the A-FAN Faster R-CNN ResNet-50 at full width through
     ``afan_torch.cli.train_detect.main`` (VOC final setting 1: batch 8,
     canvas 608x1008, 12000 -> 2000 proposals at 0.7, SE tap 2 with AFN on
     the upper spectrum points, SD on the pooled ROI vector; synthetic VOC,
     seeded random weights, the torso through ``--pretrained_backbone``
     with its frozen-BatchNorm statistics fitted on a synthetic batch, as
     an ImageNet torso's fit its data) for a few steps, resume one more step from its
     checkpoint, train the baseline for two, each run ending with the VOC
     mAP of the 16 test images: finite losses, the checkpoints, and the
     proposal-NMS and PGD-update launches of every step (2 and 2 per A-FAN
     step, 1 and 0 per baseline step) and of each eval (2 per image);
 16. one A-FAN detection step with the NMS and PGD-update kernels against
     one with their plain versions, from the same weights, batch and seeded
     draws (cuDNN deterministic, no TF32): proposal keep masks identical,
     losses and updated parameters within 1e-4;
 17. time the A-FAN and baseline detection steps and their peak memory,
     the A-FAN step with each image's ROIs pooled from its own rows in
     turns with the contraction over all images' rows, profile where the
     A-FAN step's device time goes, and time the NMS
     kernel on the step's own proposals (G=8, N=12000) and the PGD update
     at the step's two ascent shapes, with their plain versions and bounds.

The line before the last lists each kernel with its launches on its main
paths, its largest disagreement with the plain version, its time, the plain
version's time, its bound and the library's time (NMS: per batch-4 detect
call plus per A-FAN detection step; PGD update: per ALFA step plus per A-FAN
detection step); the last line is the device summary.
"""
import argparse
import asyncio
import contextlib
import copy
import gc
import itertools
import json
import os
import pickle
import shutil
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from afan_torch.cli import (infer_classify, train_classify, train_detect,
                            train_segment)
from afan_torch.cli.infer_detect import build_state, preprocess_frame
from afan_torch.cli.serve_websocket import FrameBatcher
from afan_torch.core import attack
from afan_torch.data import cifar
from afan_torch.data.voc_det import voc_detection_loaders
from afan_torch.models.deeplab import build_model
from afan_torch.models.deeplab.modeling import segmentation_param_groups
from afan_torch.models.frcnn import FasterRCNN, FRCNNConfig, roi_head
from afan_torch.models.frcnn.rpn import generate_proposals
from afan_torch.models.resnet import FrozenBatchNorm
from afan_torch.models.resnet_s import LEARNABLE_TAPS, resnet56
from afan_torch.ops import nms as tnms
from afan_torch.ops import pgd_step as tpgd
from afan_torch.ops import resize_ce as trce
from afan_torch.ops.kernels import build as kbuild
from afan_torch.ops.kernels import nms as knms
from afan_torch.ops.kernels import pgd_step as kpgd
from afan_torch.ops.kernels import resize_ce as krce
from afan_torch.train import loop as cls_loop
from afan_torch.train import detect_loop, segment_loop
from afan_torch.train.checkpoint import load_checkpoint, overlap_restore
from afan_torch.train.detect_loop import make_detect_fn
from afan_torch.train.optim import (learnable_sgd, multistep_warmup_schedule,
                                    poly_schedule, sgd,
                                    warmup_multistep_schedule)

ROOT = os.path.dirname(os.path.abspath(__file__))
FIXTURES = os.path.join(ROOT, "tests", "fixtures")
MIN_SIDE, MAX_SIDE = 600.0, 1000.0
PROB_THRESH = 0.6
MAX_BATCH = 4
# H100 SXM published peaks (NVIDIA data sheet): HBM bytes/s and f32 FLOP/s
# outside the tensor cores. Each IoU test is 16 f32 operations (see
# afan_torch/csrc/nms.cu:over).
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
OPS_PER_IOU = 16
# f32 operations that the upsample + CE function needs, counted from the
# function at its least, not from the kernels. Bilinear upsampling is
# separable: a pass along W over the h low-res rows (each output a 2-tap
# lerp a + t * (b - a), 3 operations), then a pass along H over the H output
# rows (3 again), so per (output pixel, class) it costs 3 + 3 * h / H
# (3.75 at 192 -> 768); its transpose, in the backward, costs the same.
# Per (valid pixel, class) the forward then adds max, exp of the difference
# (2) and the sum of exps (CE_LSE_OPS = 4); the backward recomputes all of
# the forward (its input is lo, not the upsampled logits), forms
# softmax - onehot scaled by the cotangent (CE_SOFTMAX_GRAD_OPS = 3), and
# runs the transposed interpolation. Per valid pixel the forward adds log,
# lse - picked and the masked sum (CE_PIXEL_OPS = 3).
CE_LERP_OPS = 3
CE_LSE_OPS = 4
CE_SOFTMAX_GRAD_OPS = 3
CE_PIXEL_OPS = 3
# (name, B, (h, w) in, (H, W) out, C, focal): the first six are
# scripts/smoke_fused_ce_tpu.py:27-34; then the A-FAN step's B=8 spectrum
# site and the band plan's edges (tests/test_torch_resize_ce.py:PLAN_CASES):
# odd sizes, a single low-res pixel, h not a multiple of the band's rows and
# odd w; "all_ignored" gives its last entry only 255 labels.
CE_CASES = [
    ("city768", 2, (192, 192), (768, 768), 19, None),
    ("city512", 2, (128, 128), (512, 512), 19, None),
    ("voc513", 2, (129, 129), (513, 513), 21, None),
    ("voc513_focal", 2, (129, 129), (513, 513), 21, (1.0, 2.0)),
    ("city768_focal", 2, (192, 192), (768, 768), 19, (1.0, 2.0)),
    ("tiny32", 2, (8, 8), (32, 32), 4, None),
    ("city768_b8", 8, (192, 192), (768, 768), 19, None),
    ("odd9x7", 2, (9, 7), (33, 28), 5, None),
    ("one_pixel", 2, (1, 1), (4, 4), 4, None),
    ("h6_w5", 2, (6, 5), (24, 20), 3, (1.0, 2.0)),
    ("all_ignored", 2, (128, 128), (512, 512), 19, None),
]
CE_SUM_TOL, CE_GRAD_TOL = 1e-5, 1.1e-5
SEG_MODEL, SEG_CROP, SEG_BATCH, SEG_ITRS = "deeplabv3plus_resnet50", 768, 4, 6
# recipes/seg_city_final.sh's flags but --bf16 (not ported) and the data
SEG_FLAGS = ["--variant", "afan", "--dataset", "synthetic", "--model",
             SEG_MODEL, "--output_stride", "16", "--crop_size", str(SEG_CROP),
             "--batch_size", str(SEG_BATCH), "--lr", "0.1",
             "--pertub_idx_se", "2", "--pertub_idx_sd", "concat",
             "--adv_loss_weight_sd", "0.3", "--gamma_se", "0.02",
             "--gamma_sd", "1.5", "--mix_layer", "01", "--mix_sd"]
# The ALFA recipe (`afan/train/loop.py:70-83`, `afan/cli/train_classify.py`
# defaults): ResNet-56, CIFAR-10, batch 128, tap 13, 5 sign steps of
# 1.5/255, eps 2/255; the learnable-eta mode takes 3 steps at 9 taps.
CLS_BATCH, CLS_ALFA_BATCHES, CLS_SHORT_BATCHES = 128, 8, 2
ALFA_TAP, ALFA_STEPS, ALFA_GAMMA, ALFA_EPS = 13, 5, 1.5 / 255, 2.0 / 255
LEARNABLE_STEPS = 3
# The PGD update reads x and g (and the centre, with the clip) once and
# writes its output once; its least operations per element are the step's
# sign, multiply and add (3), and with the clip c - eps, c + eps, maximum
# and minimum (4 more).
PGD_OPS, PGD_CLIP_OPS = 3, 7


def require(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def sorted_boxes(n, seed, clustered=False):
    rng = np.random.RandomState(seed)
    if clustered:
        centers = rng.rand(8, 2) * 300
        xy = centers[rng.randint(0, 8, n)] + rng.randn(n, 2) * 12
        wh = rng.rand(n, 2) * 120 + 60
    else:
        xy = rng.rand(n, 2) * 1000
        wh = rng.rand(n, 2) * 150 + 4
    boxes = np.concatenate([xy, xy + wh], 1).astype(np.float32)
    return boxes[np.argsort(-rng.rand(n), kind="stable")]


def chain_boxes(n, lead=0):
    """Boxes sliding right by 3 of their 12 pixels: iou(i, i+1) >= 0.5 >
    iou(i, i+2) (with or without +1-pixel areas), so greedy NMS keeps every
    other box; ``lead`` far-away boxes first shift the kept ones by one
    slot, so that a kept box ends a 64-box word and suppresses the next
    word's first."""
    x = 3.0 * np.arange(n)
    chain = np.stack([x, 0 * x, x + 12, 0 * x + 12], 1)
    far = [[1000.0 + 20 * i, 1000, 1010 + 20 * i, 1010] for i in range(lead)]
    return np.concatenate([np.reshape(far, (-1, 4)), chain]).astype(
        np.float32)


def degenerate_boxes(n, seed):
    """Zero-width, zero-height and inverted (x2 < x1, y2 < y1) boxes among
    ordinary ones."""
    b = sorted_boxes(n, seed).copy()
    b[0::5, 2] = b[0::5, 0]
    b[1::5, 3] = b[1::5, 1]
    b[2::5, [0, 2]] = b[2::5, [2, 0]]
    b[3::7, [1, 3]] = b[3::7, [3, 1]]
    return b


def holes(n):
    """All valid but a few slots inside words and at their edges."""
    v = np.ones(n, bool)
    v[[3, 4, 10, 62, 63, 64, 65, 100, 101, 102, 127, 128]] = False
    return v


# The edges of the kernel's per-word scan: name -> () -> (boxes (N, 4) f32
# score-sorted, valid (N,) bool, threshold). Ragged last words, suppression
# chains inside and across words, identical boxes, thresholds under which
# everything or nothing suppresses, degenerate boxes, invalid slots inside a
# word. tests/test_torch_nms.py holds the plain version to afan on them.
NMS_EDGE_CASES = {
    **{f"n{n}": (lambda n=n: (sorted_boxes(n, n), np.ones(n, bool), 0.6))
       for n in (1, 63, 64, 65, 6001)},
    "chain": lambda: (chain_boxes(200), np.ones(200, bool), 0.5),
    "chain_shifted": lambda: (chain_boxes(200, 1), np.ones(201, bool), 0.5),
    "identical": lambda: (np.tile(np.float32([[10, 20, 50, 70]]), (150, 1)),
                          np.ones(150, bool), 0.5),
    "thr_zero": lambda: (sorted_boxes(150, 7), np.ones(150, bool), 0.0),
    "thr_above_one": lambda: (sorted_boxes(150, 8), np.ones(150, bool), 1.01),
    "degenerate": lambda: (degenerate_boxes(300, 9), np.ones(300, bool), 0.3),
    "invalid_in_word": lambda: (chain_boxes(200), holes(200), 0.5),
}


def cuda(a):
    return torch.from_numpy(np.ascontiguousarray(a)).cuda()


def kernel_vs_plain(name, boxes, valid, thr, plus_one, errs):
    """Kernel and plain version on the same (G, N, 4) / (G, N) inputs;
    appends the largest |kernel - plain| over the keep mask to ``errs`` and
    returns the kernel's keep mask after requiring equality."""
    got = knms.nms_sorted_mask(boxes, valid, thr, plus_one)
    want = tnms.nms_sorted_mask_plain(boxes, valid, thr, plus_one)
    torch.cuda.synchronize()
    errs.append(float((got.float() - want.float()).abs().max()))
    require(torch.equal(got, want), f"NMS kernel != plain on {name}")
    print(f"  nms {name}: G={boxes.shape[0]} N={boxes.shape[1]} thr={thr} "
          f"plus_one={plus_one} kept={int(got.sum())} equal")
    return got


@contextlib.contextmanager
def patched_nms(fn):
    """Route afan_torch.ops.nms through ``fn`` instead of the kernel
    wrapper for the duration of the block."""
    saved = tnms.nms_sorted_mask
    tnms.nms_sorted_mask = fn
    try:
        yield
    finally:
        tnms.nms_sorted_mask = saved


def cuda_ms(fn, reps, warmup=2):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def cuda_samples(fn, n, warmup=3):
    """Per-call device times (ms) of ``n`` calls, each between two CUDA
    events."""
    for _ in range(warmup):
        fn()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(n)]
    for start, end in events:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return np.array([s.elapsed_time(e) for s, e in events])


def host_ms(fn, n=20):
    """Median wall time (ms) of ``n`` calls of the host function ``fn``,
    after one warmup call."""
    fn()
    t = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        t.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(t))


def nms_bound_parts(boxes, valid, keep):
    """The two floors (ms) of the same work on an H100: the bytes the
    function must move (boxes and valid read once, keep written once) over
    HBM bandwidth, and the IoU tests this data needs over the f32 rate. A
    kept box must be tested against every earlier kept box; a suppressed
    valid box needs at least one test."""
    g, n = valid.shape
    nbytes = g * n * (16 + 1 + 1)
    kc = torch.cumsum(keep.to(torch.int64), dim=1)
    tests = int(((kc - 1) * keep).sum()) + int((valid & ~keep).sum())
    return (nbytes / HBM_BYTES_PER_S * 1e3,
            tests * OPS_PER_IOU / F32_OPS_PER_S * 1e3)


async def serve_group(batcher, frames):
    """Enqueue ``frames`` together, then let a worker drain them (one
    batched device call when they fit in max_batch)."""
    subs = [asyncio.create_task(batcher.submit(f)) for f in frames]
    await asyncio.sleep(0)
    worker = asyncio.create_task(batcher.worker())
    try:
        return await asyncio.gather(*subs)
    finally:
        worker.cancel()
        with contextlib.suppress(asyncio.CancelledError):
            await worker


async def serve_all(batcher, groups, zero_frames):
    """Serve each group in turn on one event loop (the batcher's queue
    belongs to the loop that first used it), then ``zero_frames`` at
    prob_thresh 0 → (answers, answers at 0)."""
    answers = []
    for group in groups:
        answers += await serve_group(batcher, group)
    batcher.prob_thresh = 0.0
    try:
        zero = await serve_group(batcher, zero_frames)
    finally:
        batcher.prob_thresh = PROB_THRESH
    return answers, zero[0]


def check_answer(dets, thresh):
    require(isinstance(dets, list), "answer is not a list")
    for box, label, prob in dets:
        require(np.shape(box) == (4,) and np.isfinite(box).all(),
                f"bad box {box}")
        require(1 <= label <= 20, f"label {label} outside 1..20")
        require(prob > thresh, f"prob {prob} not above {thresh}")


def nms_kernel_vs_plain(errs):
    """Phase 3."""
    print("[3] NMS kernel vs plain version")
    det = np.load(os.path.join(FIXTURES, "nms-large-input.npy"))
    order = np.argsort(-det[:, 4], kind="stable")
    gold = cuda(det[order, :4].astype(np.float32))[None]
    ones = torch.ones(gold.shape[:2], dtype=torch.bool, device="cuda")
    keep = kernel_vs_plain("golden", gold, ones, 0.7, True, errs)
    kept = sorted(order[keep[0].cpu().numpy()].tolist())
    expect = np.load(os.path.join(FIXTURES, "nms-large-output.npy"))
    require(len(kept) == 1934 and kept == sorted(expect.tolist()),
            f"golden fixture kept {len(kept)}, expected 1934")
    public = tnms.nms_mask(cuda(det[:, :4].astype(np.float32)),
                           cuda(det[:, 4].astype(np.float32)), 0.7)
    require(int(public.sum()) == 1934, "nms_mask on the card != 1934 kept")
    for n in (6000, 12000):
        b = cuda(sorted_boxes(n, n))[None]
        ones = torch.ones(b.shape[:2], dtype=torch.bool, device="cuda")
        kernel_vs_plain(f"uniform{n}", b, ones, 0.7, True, errs)
    b = cuda(sorted_boxes(12000, 12, clustered=True))[None]
    kernel_vs_plain("clustered12000", b, ones, 0.7, True, errs)
    b = cuda(sorted_boxes(2600, 99, clustered=True))[None]
    ones = torch.ones(b.shape[:2], dtype=torch.bool, device="cuda")
    kernel_vs_plain("clustered", b, ones, 0.5, True, errs)
    keep = kernel_vs_plain("all_invalid", b, ~ones, 0.5, True, errs)
    require(not keep.any(), "all-invalid input kept a box")
    b = cuda(sorted_boxes(6000, 1))[None]
    part = cuda(np.random.RandomState(2).rand(1, 6000) < 0.7)
    keep = kernel_vs_plain("partial_valid", b, part, 0.7, True, errs)
    require(not (keep & ~part).any(), "an invalid slot was kept")
    kernel_vs_plain("no_plus_one", b, torch.ones_like(part), 0.7, False, errs)
    b = cuda(np.stack([sorted_boxes(300, i, clustered=True)
                       for i in range(80)]))
    ones = torch.ones(b.shape[:2], dtype=torch.bool, device="cuda")
    kernel_vs_plain("batched", b, ones, 0.3, True, errs)
    for name, case in NMS_EDGE_CASES.items():
        boxes, valid, thr = case()
        for plus_one in (True, False):
            kernel_vs_plain(name, cuda(boxes)[None], cuda(valid)[None], thr,
                            plus_one, errs)


def detector():
    """The served ResNet-50 Faster R-CNN (21 classes, seeded weights) and
    its canvas."""
    args = argparse.Namespace(backbone="resnet50", checkpoint=None,
                              image_min_side=MIN_SIDE,
                              image_max_side=MAX_SIDE)
    model, canvas_hw = build_state(args, num_classes=21)
    require(next(model.parameters()).is_cuda, "model is not on the card")
    return model, canvas_hw


def serve(model, canvas_hw, frames):
    """Phase 4; returns the NMS kernel's launches in the served calls."""
    print("[4] serve: FrameBatcher, ResNet-50 Faster R-CNN, 21 classes")
    detect_fn = make_detect_fn(model)
    batch_sizes = []

    def recording_detect(images):
        batch_sizes.append(images.shape[0])
        return detect_fn(images)

    batcher = FrameBatcher(recording_detect, canvas_hw, MIN_SIDE, MAX_SIDE,
                           PROB_THRESH, max_batch=MAX_BATCH)
    t0 = time.time()
    batcher.warmup()
    torch.cuda.synchronize()
    print(f"    canvas {canvas_hw}, warmup {time.time() - t0:.1f} s")
    groups = [frames[0:1], frames[1:2], frames[2:6], frames[6:8]]
    batch_sizes.clear()
    knms.launches = 0
    t0 = time.time()
    answers, zero = asyncio.run(serve_all(batcher, groups, frames[8:9]))
    torch.cuda.synchronize()
    serve_s = time.time() - t0
    launches = knms.launches
    for dets in answers:
        check_answer(dets, PROB_THRESH)
    check_answer(zero, 0.0)
    require(len(zero) > 0, "no detections at prob_thresh 0")
    require(batch_sizes == [1, 1, 4, 4, 1],
            f"unexpected batch sizes {batch_sizes}")
    require(launches == 2 * len(batch_sizes),
            f"NMS kernel launched {launches} times in "
            f"{len(batch_sizes)} detect calls (expected 2 per call)")
    print(f"    {len(frames)} frames in {serve_s:.2f} s, batch sizes "
          f"{batch_sizes}, detections per frame "
          f"{[len(d) for d in answers]} (>{PROB_THRESH}), {len(zero)} at "
          f"prob_thresh 0; NMS kernel launches {launches}")
    return launches


def path_kernel_vs_plain(model, hw, x4, errs):
    """Phase 5; returns the NMS inputs of the batch-4 detect call (the
    proposal NMS and the per-class NMS)."""
    print("[5] path with the kernel vs path with the plain NMS")
    recorded = []

    def recording_kernel(boxes, valid, thr, plus_one=True):
        recorded.append((boxes.clone(), valid.clone(), thr, plus_one))
        return knms.nms_sorted_mask(boxes, valid, thr, plus_one)

    def post(features):
        obj, reg = model.rpn(features)
        anchors = model._anchors(hw, tuple(features.shape[2:]))
        props = generate_proposals(anchors, obj, reg, hw[1], hw[0],
                                   model.cfg.eval_pre_nms_top_n,
                                   model.cfg.eval_post_nms_top_n)
        return props + model.detect_from_features(features, hw)

    with torch.inference_mode():
        features = model.features_clean(x4.permute(0, 3, 1, 2))
        with patched_nms(recording_kernel):
            k_out = post(features)
        with patched_nms(tnms.nms_sorted_mask_plain):
            p_out = post(features)
    torch.cuda.synchronize()
    names = ("proposals", "proposal_valid", "boxes", "probs", "keep")
    for nm, a, b in zip(names, k_out, p_out):
        require(torch.equal(a, b), f"{nm} differ between kernel and plain")
    props, pvalid, boxes, probs, keep = k_out
    require(tuple(boxes.shape) == (MAX_BATCH, 300, 21, 4)
            and tuple(probs.shape) == (MAX_BATCH, 300, 21)
            and tuple(keep.shape) == (MAX_BATCH, 300, 21),
            f"detect shapes {boxes.shape} {probs.shape} {keep.shape}")
    require(bool(torch.isfinite(boxes[keep]).all()), "non-finite kept box")
    require(bool(torch.allclose(probs.sum(-1), torch.ones_like(probs[..., 0]),
                                atol=1e-4)), "probs do not sum to 1")
    print(f"    proposals {tuple(props.shape)}, valid per image "
          f"{pvalid.sum(1).tolist()}, kept detections per image "
          f"{keep.sum((1, 2)).tolist()}: identical")
    # recorded: proposal NMS twice (props, detect) then per-class NMS
    main_inputs = [recorded[1], recorded[2]]
    for boxes_in, valid_in, thr, plus_one in main_inputs:
        kernel_vs_plain("main_path", boxes_in, valid_in, thr, plus_one, errs)
    return main_inputs


def time_detect(card, model, x4, frame, canvas_hw):
    """Phase 6, the detect call and the host's pre-processing."""
    x1 = x4[:1].contiguous()
    with torch.inference_mode():
        for bs, x in ((1, x1), (MAX_BATCH, x4)):
            t = cuda_samples(lambda: model.detect(x), 110)
            print(f"    detect batch {bs}: median {np.median(t):.3f} ms, "
                  f"p90 {np.percentile(t, 90):.3f} ms over {len(t)} calls, "
                  f"{bs * 1e3 / np.median(t):.1f} frames/s ({card})")
        torch.cuda.reset_peak_memory_stats()
        model.detect(x4)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"    peak memory, detect at batch {MAX_BATCH}: {peak:.2f} GiB")
    pre_ms = host_ms(lambda: preprocess_frame(frame, canvas_hw, MIN_SIDE,
                                              MAX_SIDE))
    _, scale = preprocess_frame(frame, canvas_hw, MIN_SIDE, MAX_SIDE)
    u8 = torch.from_numpy((frame * 255).astype(np.uint8))
    x = u8.permute(2, 0, 1)[None].to(torch.float32)
    size = (round(frame.shape[0] * scale), round(frame.shape[1] * scale))
    lib_ms = host_ms(lambda: F.interpolate(x, size=size, mode="bilinear",
                                           antialias=True))
    print(f"    host pre-processing of a {frame.shape[0]}x{frame.shape[1]} "
          f"frame at scale {scale}: preprocess_frame (PIL's integer resize) "
          f"median {pre_ms:.3f} ms; one antialiased F.interpolate of the "
          f"same frame {lib_ms:.3f} ms ({torch.get_num_threads()} host "
          f"threads)")


def nms_pass_ms(call, n=5):
    """Device ms per call of the kernel's two passes, from a torch.profiler
    trace of ``n`` calls: (mask pass, scan pass), or None when the trace
    holds no device time."""
    from torch.profiler import ProfilerActivity, profile
    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            call()
        torch.cuda.synchronize()
    ms = {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            for part in ("nms_mask_kernel", "nms_scan_kernel"):
                if part in e.key:
                    ms[part] = e.self_device_time_total / 1e3 / n
    if len(ms) < 2:
        return None
    return ms["nms_mask_kernel"], ms["nms_scan_kernel"]


def time_nms_shape(card, label, boxes, valid, thr, plus_one=True, plain=True):
    """One shape of phase 6: kept count, the two passes' device time, the
    kernel's time (calls queued behind a sleep kernel, so that the host's
    cost per call does not hide the card's), the plain version's and the
    bound."""
    call = lambda: knms.nms_sorted_mask(boxes, valid, thr, plus_one)
    keep = call()
    kept = keep.sum(1).tolist()
    k_ms = queued_ms(call, reps=50)
    p_ms = (cuda_ms(lambda: tnms.nms_sorted_mask_plain(
        boxes, valid, thr, plus_one), reps=3, warmup=1) if plain else None)
    b, o = nms_bound_parts(boxes, valid, keep)
    split = nms_pass_ms(call)
    parts = ("passes not measured (no device time in the trace)"
             if split is None else
             f"mask pass {split[0]:.4f} ms + scan pass {split[1]:.4f} ms")
    plain_s = "" if p_ms is None else f", plain {p_ms:.3f} ms"
    print(f"    nms {label} G={valid.shape[0]} N={valid.shape[1]} thr={thr}, "
          f"kept {kept}: kernel {k_ms:.4f} ms ({parts}){plain_s}, bound "
          f"max(bytes {b:.6f}, operations {o:.6f}) ms ({card})")
    return k_ms, p_ms, b, o


def time_nms(card, main_inputs):
    """Phase 6, the kernel: the detect call's two NMS calls (with the plain
    version), then the shapes where most boxes are kept and the training
    proposal NMS (12000 in, at 0.7). Returns (ms, plain ms, bound ms,
    bound_by) per batch-4 detect call."""
    ms = plain_ms = byte_ms = op_ms = 0.0
    for boxes_in, valid_in, thr, plus_one in main_inputs:
        k, p, b, o = time_nms_shape(card, "main path", boxes_in, valid_in,
                                    thr, plus_one)
        ms, plain_ms = ms + k, plain_ms + p
        byte_ms, op_ms = byte_ms + b, op_ms + o
    bound = max(byte_ms, op_ms)
    bound_by = "bytes" if byte_ms >= op_ms else "operations"
    print(f"    nms per detect call at batch {MAX_BATCH}: kernel {ms:.4f} ms, "
          f"plain {plain_ms:.3f} ms, bound {bound:.6f} ms ({bound_by})")
    # random weights keep few proposals; uniform boxes keep most
    shapes = [("uniform", 6000, 4, False)] + [
        ("clustered" if cl else "uniform", 12000, g, cl)
        for g in (1, 4) for cl in (False, True)]
    for label, n, g, cl in shapes:
        b = cuda(np.stack([sorted_boxes(n, 10 + i, clustered=cl)
                           for i in range(g)]))
        ones = torch.ones(b.shape[:2], dtype=torch.bool, device="cuda")
        time_nms_shape(card, label, b, ones, 0.7, plain=False)
    return ms, plain_ms, bound, bound_by


def detection_phases(card, nms_only=False):
    """Phases 3-6 (with ``nms_only``, phases 3 and 5 and the NMS timings of
    phase 6: no server, no detect timing); returns the NMS kernel's entry
    of the kernels line."""
    errs = []
    nms_kernel_vs_plain(errs)
    model, canvas_hw = detector()
    rng = np.random.RandomState(0)
    frames = [rng.rand(480, 640, 3).astype(np.float32) for _ in range(9)]
    launches = None if nms_only else serve(model, canvas_hw, frames)
    x4 = cuda(np.stack([preprocess_frame(f, canvas_hw, MIN_SIDE, MAX_SIDE)[0]
                        for f in frames[:MAX_BATCH]]))
    main_inputs = path_kernel_vs_plain(model, tuple(canvas_hw), x4, errs)
    print(f"[6] timing on {card}")
    if not nms_only:
        time_detect(card, model, x4, frames[0], canvas_hw)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    ms, plain_ms, bound, bound_by = time_nms(card, main_inputs)
    return {
        "name": "nms", "route": "cuda", "source": "afan_torch/csrc/nms.cu",
        "replaces": "afan/ops/kernels/nms_kernel.py:65",
        "launches": launches, "max_abs_err": max(errs), "ms": ms,
        "plain_ms": plain_ms, "bound_ms": bound, "bound_by": bound_by,
        "library_ms": None}


def rel_err(got, want):
    """max |got - want| / max |want|."""
    return float((got - want).abs().max() / want.abs().max())


def ce_inputs(B, hw, HW, C, seed=0, all_ignored=False):
    """Seeded logits (B, C, h, w), labels (B, H, W) with an ignored corner
    (and, with ``all_ignored``, a last entry of ignored labels only), and a
    per-entry cotangent."""
    rng = np.random.RandomState(seed)
    lo = cuda(rng.randn(B, C, *hw).astype(np.float32))
    lab = rng.randint(0, C, (B, *HW)).astype(np.int32)
    lab[:, :3, :3] = 255
    if all_ignored:
        lab[-1] = 255
    g = cuda(np.linspace(0.5, 1.5, B).astype(np.float32))
    return lo, cuda(lab), g


@contextlib.contextmanager
def patched_update(fn):
    """Route ``core.attack.pgd``'s sign steps through ``fn`` instead of
    ``ops.pgd_step.pgd_update`` for the duration of the block."""
    saved = attack.pgd_update
    attack.pgd_update = fn
    try:
        yield
    finally:
        attack.pgd_update = saved


def recording_update(shapes):
    """``pgd_update`` that appends each call's (shape, clip) to ``shapes``
    and then runs it (its kernel wrapper counts the launch)."""
    def update(x, g, center=None, **kw):
        shapes.append((tuple(x.shape), bool(kw.get("clip"))))
        return tpgd.pgd_update(x, g, center, **kw)
    return update


@contextlib.contextmanager
def patched_site_op(fn):
    """Route the segmentation step's loss and ascent sites through ``fn``
    instead of ``fused_resize_nll_sums`` for the duration of the block."""
    saved = segment_loop.fused_resize_nll_sums
    segment_loop.fused_resize_nll_sums = fn
    try:
        yield
    finally:
        segment_loop.fused_resize_nll_sums = saved


def ce_kernels_vs_plain(errs):
    """Phase 7: both kernels against the plain version on the geometries
    of ``CE_CASES``; appends the largest absolute errors to ``errs``."""
    print("[7] upsample + CE kernels vs plain version")
    for name, B, hw, HW, C, focal in CE_CASES:
        lo, lab, g = ce_inputs(B, hw, HW, C, all_ignored=name == "all_ignored")
        sums = krce.resize_ce_forward(lo, lab, focal)
        dlo = krce.resize_ce_backward(lo, lab, g, focal)
        again = (krce.resize_ce_forward(lo, lab, focal),
                 krce.resize_ce_backward(lo, lab, g, focal))
        want_s = trce.fused_resize_nll_sums_plain(lo, lab, HW, focal)
        want_d = trce.resize_ce_grad_plain(lo, lab, g, focal)
        torch.cuda.synchronize()
        es, eg = rel_err(sums, want_s), rel_err(dlo, want_d)
        errs["fwd"].append(float((sums - want_s).abs().max()))
        errs["bwd"].append(float((dlo - want_d).abs().max()))
        repeat = torch.equal(again[0], sums) and torch.equal(again[1], dlo)
        print(f"  {name}: B={B} {hw}->{HW} C={C} focal={focal}: sums rel "
              f"{es:.3e}, grad rel {eg:.3e}, repeat bit-equal {repeat}")
        require(es <= CE_SUM_TOL, f"{name}: sums rel err {es} > {CE_SUM_TOL}")
        require(eg <= CE_GRAD_TOL,
                f"{name}: grad rel err {eg} > {CE_GRAD_TOL}")
        require(repeat, f"{name}: two runs of the kernels differ")
        if name == "all_ignored":
            require(float(sums[-1]) == 0.0 and not dlo[-1].any(),
                    "an entry of ignored labels has a loss or a gradient")
    # the autograd Function on a CUDA tensor goes through both kernels
    lo, lab, g = ce_inputs(2, (192, 192), (768, 768), 19, seed=1)
    before = (krce.fwd_launches, krce.bwd_launches)
    x = lo.clone().requires_grad_(True)
    sums = trce.fused_resize_nll_sums(x, lab.long(), (768, 768))
    (grad,) = torch.autograd.grad(sums, x, g)
    require((krce.fwd_launches, krce.bwd_launches)
            == (before[0] + 1, before[1] + 1),
            "fused_resize_nll_sums did not launch both kernels")
    require(torch.equal(sums, krce.resize_ce_forward(lo, lab))
            and torch.equal(grad, krce.resize_ce_backward(lo, lab, g)),
            "the autograd Function disagrees with the kernel wrappers")


def train_full_width():
    """Phase 8: the trainer through its CLI entry point. Returns (forward
    launches, backward launches, launches per step, per-step losses, the
    (shape, clip) of each PGD update)."""
    print("[8] train: A-FAN DeepLabv3+ ResNet-50, OS 16, crop 768, batch 4, "
          "Cityscapes final recipe, synthetic data")
    for d in os.listdir("checkpoints") if os.path.isdir("checkpoints") else ():
        if d.startswith("synthetic_chip_smoke_"):
            shutil.rmtree(os.path.join("checkpoints", d))
    losses, configs = [], []
    real = train_segment.make_afan_seg_step

    def recording(model, optimizer, scheduler, cfg):
        configs.append(cfg)
        step = real(model, optimizer, scheduler, cfg)

        def run(images, labels, generator=None):
            out = step(images, labels, generator)
            losses.append({k: float(v) for k, v in out.items()})
            return out
        return run

    train_segment.make_afan_seg_step = recording
    updates = []
    krce.fwd_launches = krce.bwd_launches = kpgd.launches = 0
    t0 = time.time()
    try:
        with patched_update(recording_update(updates)):
            score = train_segment.main(SEG_FLAGS + [
                "--limit_itrs", str(SEG_ITRS), "--val_interval",
                str(SEG_ITRS), "--print_interval", "1", "--exp",
                "chip_smoke"])
        torch.cuda.synchronize()
    finally:
        train_segment.make_afan_seg_step = real
    fwd, bwd, pgd_launches = (krce.fwd_launches, krce.bwd_launches,
                              kpgd.launches)
    secs = time.time() - t0
    cfg = configs[0]
    sd = cfg.sd is not None
    per_step = sites_per_step(cfg)
    require(len(losses) == SEG_ITRS, f"{len(losses)} steps ran")
    require(all(np.isfinite(v) for rec in losses for v in rec.values()),
            f"non-finite loss in {losses}")
    require(fwd == bwd == SEG_ITRS * per_step,
            f"resize+CE launches fwd={fwd} bwd={bwd} in {SEG_ITRS} steps "
            f"(expected {per_step} each per step)")
    # one PGD-update launch per sign step of each ascent (SE, and SD)
    pgd_per_step = (1 + sd) * cfg.steps
    require(cfg.step_mode == "sign"
            and pgd_launches == len(updates) == SEG_ITRS * pgd_per_step,
            f"PGD-update launches {pgd_launches} ({len(updates)} updates) in "
            f"{SEG_ITRS} steps (expected {pgd_per_step} per step)")
    dirs = [d for d in os.listdir("checkpoints")
            if d.startswith("synthetic_chip_smoke_")]
    path = os.path.join("checkpoints", dirs[0],
                        f"latest_{SEG_MODEL}_synthetic.pt")
    require(len(dirs) == 1 and os.path.isfile(path), "no checkpoint written")
    saved = torch.load(path, map_location="cpu", weights_only=True)
    require(saved["cur_itrs"] == SEG_ITRS
            and all(bool(torch.isfinite(v).all())
                    for v in saved["model_state"].values()
                    if v.is_floating_point()),
            "checkpoint is not the finished run's")
    print(f"    {SEG_ITRS} steps + 1 validation in {secs:.1f} s (first "
          f"step includes cuDNN set-up); losses "
          f"{[round(r['loss'], 4) for r in losses]}; mIoU {score:.4f}; "
          f"checkpoint {path}")
    print(f"    resize+CE launches: forward {fwd}, backward {bwd} = "
          f"{per_step} each per step; PGD-update launches {pgd_launches} = "
          f"{pgd_per_step} per step, shapes {sorted(set(updates))}")
    return fwd, bwd, per_step, losses, updates


def seg_recipe():
    args = train_segment.get_parser().parse_args(SEG_FLAGS)
    return train_segment.afan_config(args)


def sites_per_step(cfg):
    """Upsample + CE launches, each way, per A-FAN step: one per PGD step
    of each ascent (SE, and SD when set), and one per loss site (clean, the
    stacked spectrum tails, and SD when set)."""
    sd = cfg.sd is not None
    return (1 + sd) * cfg.steps + (2 + sd)


def seg_batch(seed=0):
    loader, _, _ = train_segment.cityscapes_loaders(None, SEG_BATCH,
                                                    SEG_CROP, seed=seed)
    imgs, labs = next(iter(loader))
    return cuda(imgs), cuda(labs)


def seg_model_and_batch(seed=0):
    model = build_model(SEG_MODEL, 19, 16)
    model.reset_parameters(torch.Generator().manual_seed(seed))
    return (model.cuda(),) + seg_batch(seed)


def seg_step(model, afan=True):
    opt, sched = sgd(segmentation_param_groups(model),
                     poly_schedule(0.1, 30000), 0.1, 0.9, 1e-4)
    if afan:
        return segment_loop.make_afan_seg_step(model, opt, sched,
                                               seg_recipe())
    return segment_loop.make_seg_base_step(model, opt, sched)


def step_kernel_vs_plain(model, imgs, labs):
    """Phase 9: one A-FAN step with the kernels and one with the plain op
    from the same weights, batch and dropout masks, in full f32."""
    print("[9] A-FAN step with the kernels vs with the plain op")
    state = copy.deepcopy(model.state_dict())
    flags = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark, torch.backends.cudnn.allow_tf32)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.allow_tf32 = False
    runs = []
    try:
        for op in (trce.fused_resize_nll_sums,
                   trce.fused_resize_nll_sums_plain):
            model.load_state_dict(state)
            step = seg_step(model)
            torch.manual_seed(0)
            with patched_site_op(op):
                out = step(imgs, labs)
            conv = model.classifier.classifier[3]
            runs.append(({k: float(v) for k, v in out.items()},
                         conv.weight.grad.clone(), conv.bias.grad.clone()))
        torch.cuda.synchronize()
    finally:
        (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark,
         torch.backends.cudnn.allow_tf32) = flags
        model.load_state_dict(state)
    (lk, wk, bk), (lp, wp, bp) = runs
    loss_err = max(abs(lk[k] - lp[k]) / max(abs(lp[k]), 1e-30) for k in lk)
    grad_err = max(rel_err(wk, wp), rel_err(bk, bp))
    print(f"    losses kernel {lk}")
    print(f"    losses plain  {lp}")
    print(f"    largest loss rel err {loss_err:.3e}; logits-conv gradient "
          f"rel err {grad_err:.3e} (weight {rel_err(wk, wp):.3e}, bias "
          f"{rel_err(bk, bp):.3e})")
    require(loss_err <= 1e-4, f"step losses differ by {loss_err}")
    require(grad_err <= 1e-4, f"logits-conv gradients differ by {grad_err}")


def ce_parts(lo, lab, g):
    """Timings (ms) at one of the step's shapes: each kernel in turns with
    the library composition F.interpolate + F.cross_entropy + per-entry sum
    (library, kernel, kernel, library, twice; the backward's library on a
    kept graph), each the device time of calls queued back to back; the
    plain version (forward; backward alone on a kept graph); and the two
    bounds."""
    size = tuple(lab.shape[1:])
    lab64 = lab.long()

    def library(x):
        hi = F.interpolate(x, size=size, mode="bilinear", align_corners=False)
        return F.cross_entropy(hi, lab64, reduction="none",
                               ignore_index=255).sum(dim=(1, 2))

    x = lo.clone().requires_grad_(True)
    plain_sums = trce.fused_resize_nll_sums_plain(x, lab, size)
    lib_sums = library(x)
    calls = {
        "fwd": lambda: krce.resize_ce_forward(lo, lab),
        "bwd": lambda: krce.resize_ce_backward(lo, lab, g),
        "lib_fwd": lambda: library(lo),
        "lib_bwd": lambda: torch.autograd.grad(lib_sums, x, g,
                                               retain_graph=True),
    }
    turns = {}
    for theirs, ours in (("lib_fwd", "fwd"), ("lib_bwd", "bwd")):
        got = turns[theirs] = {theirs: [], ours: []}
        for k in (theirs, ours, ours, theirs) * 2:
            got[k].append(queued_ms(calls[k], reps=50))
    out = {
        "fwd": float(np.mean(turns["lib_fwd"]["fwd"])),
        "bwd": float(np.mean(turns["lib_bwd"]["bwd"])),
        "lib_fwd": float(np.mean(turns["lib_fwd"]["lib_fwd"])),
        "lib_bwd": float(np.mean(turns["lib_bwd"]["lib_bwd"])),
        "turns": turns,
        "plain_fwd": cuda_ms(
            lambda: trce.fused_resize_nll_sums_plain(lo, lab, size), reps=20),
        "plain_bwd": cuda_ms(lambda: torch.autograd.grad(
            plain_sums, x, g, retain_graph=True), reps=20),
    }
    b, c, h = lo.shape[:3]
    valid = int((lab != 255).sum())
    lo_bytes, lab_bytes = lo.numel() * 4, lab.numel() * 4
    interp = CE_LERP_OPS * (1 + h / size[0])
    fwd_ops = interp + CE_LSE_OPS
    bwd_ops = fwd_ops + CE_SOFTMAX_GRAD_OPS + interp
    for half, nbytes, ops in (
            ("fwd", lo_bytes + lab_bytes + b * 4,
             valid * (c * fwd_ops + CE_PIXEL_OPS)),
            ("bwd", 2 * lo_bytes + lab_bytes + b * 4,
             valid * (c * bwd_ops + CE_PIXEL_OPS))):
        out[f"{half}_bytes_ms"] = nbytes / HBM_BYTES_PER_S * 1e3
        out[f"{half}_ops_ms"] = ops / F32_OPS_PER_S * 1e3
    return out


def profile_step(step, n=3, label="A-FAN"):
    """Where the device time of ``label`` steps (``step()``) goes:
    torch.profiler over ``n`` steps after a warmup; the device's busy share
    of the wall time and the kernels with the most device time."""
    from torch.profiler import ProfilerActivity, profile
    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        for _ in range(n):
            step()
        torch.cuda.synchronize()
        wall_ms = (time.time() - t0) * 1e3 / n
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / n
    if not busy_ms:
        print("    profile: the trace holds no device time (not measured)")
        return
    launches = sum(e.count for e in kernels) / n
    print(f"    profile of {n} {label} steps: {wall_ms:.3f} ms wall per step, "
          f"device busy {busy_ms:.3f} ms ({100 * busy_ms / wall_ms:.1f}%), "
          f"{launches:.0f} device kernels per step; top kernels by device "
          f"time per step:")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]:
        ms = e.self_device_time_total / 1e3 / n
        print(f"      {ms:8.3f} ms {100 * ms / busy_ms:5.1f}% "
              f"x{e.count // n:<4d} {e.key[:90]}")


def time_seg_steps(card, model, imgs, labs):
    """Phase 10, the steps: the A-FAN and base steps' times and peak
    memory, and where the A-FAN step's device time goes."""
    for afan, name in ((True, "A-FAN"), (False, "base")):
        step = seg_step(model, afan)
        t = cuda_samples(lambda: step(imgs, labs), 20)
        torch.cuda.reset_peak_memory_stats()
        step(imgs, labs)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() / 2**30
        print(f"    {name} step, batch {SEG_BATCH}, crop {SEG_CROP}: median "
              f"{np.median(t):.3f} ms, p90 {np.percentile(t, 90):.3f} ms over "
              f"{len(t)} steps, {SEG_BATCH * 1e3 / np.median(t):.2f} imgs/s, "
              f"peak memory {peak:.2f} GiB ({card})")
    step = seg_step(model)
    profile_step(lambda: step(imgs, labs))


def ptxas_lines(log, key):
    """The lines of a ``ptxas -v`` log about the kernels whose mangled
    names contain ``key``."""
    out, keep = [], False
    for line in log.splitlines():
        if "Compiling entry function" in line:
            keep = key in line
        if keep:
            out.append(line.strip())
    return out


def time_ce_kernels(card, labs, per_step):
    """Phase 10, the kernels: what ptxas and the card report of the two
    upsample + CE kernels, and each kernel in turns with the library
    composition, its plain version and its bound at the step's shapes.
    Returns the two kernels' entries of the kernels line (times per A-FAN
    step: its B=4 sites and its B=8 spectrum site)."""
    log = kbuild.build_log("resize_ce.cu")
    for key in ("resize_ce_fwd", "resize_ce_bwd_bands"):
        for line in ptxas_lines(log, key) or [f"no ptxas record of {key}"]:
            print(f"    ptxas: {line}")
    h = SEG_CROP // 4
    for kind in ("forward", "backward"):
        info = krce.kernel_info(kind, 19, h, h, SEG_CROP, SEG_CROP)
        print(f"    {kind} kernel at C=19 {h}->{SEG_CROP}: {info} ({card})")
    # the step's sites: SE and SD ascents, clean and SD losses at B=4; the
    # two stacked spectrum tails at B=8
    shapes = {SEG_BATCH: per_step - 1, 2 * SEG_BATCH: 1}
    total = {}
    rng = np.random.RandomState(5)
    for b, count in shapes.items():
        lab = labs.repeat(b // SEG_BATCH, 1, 1).to(torch.int32).contiguous()
        lo = cuda(rng.randn(b, 19, h, h).astype(np.float32))
        parts = ce_parts(lo, lab, torch.ones(b, device="cuda"))
        for k, v in parts.items():
            if k != "turns":
                total[k] = total.get(k, 0.0) + count * v
        print(f"    resize+CE B={b} {h}->{SEG_CROP} C=19 (x{count} per step): "
              f"forward kernel {parts['fwd']:.4f} ms, plain "
              f"{parts['plain_fwd']:.4f}, library {parts['lib_fwd']:.4f}, "
              f"bound max(bytes {parts['fwd_bytes_ms']:.5f}, operations "
              f"{parts['fwd_ops_ms']:.5f}); backward kernel "
              f"{parts['bwd']:.4f} ms, plain {parts['plain_bwd']:.4f}, "
              f"library {parts['lib_bwd']:.4f}, bound max(bytes "
              f"{parts['bwd_bytes_ms']:.5f}, operations "
              f"{parts['bwd_ops_ms']:.5f}) ({card})")
        for theirs, got in parts["turns"].items():
            (t_name, t_ms), (o_name, o_ms) = got.items()
            print(f"    B={b} in turns ({t_name}, {o_name}, {o_name}, "
                  f"{t_name}, twice): {o_name} {[round(t, 4) for t in o_ms]}"
                  f" ms, mean {np.mean(o_ms):.4f}; {t_name} "
                  f"{[round(t, 4) for t in t_ms]} ms, mean "
                  f"{np.mean(t_ms):.4f}; {o_name} "
                  f"{np.mean(t_ms) / np.mean(o_ms):.2f}x faster ({card})")
    entries = []
    for half, name, line in (("fwd", "resize_ce_forward", 92),
                             ("bwd", "resize_ce_backward", 127)):
        byte_ms, op_ms = total[f"{half}_bytes_ms"], total[f"{half}_ops_ms"]
        entries.append({
            "name": name, "route": "cuda",
            "source": "afan_torch/csrc/resize_ce.cu",
            "replaces": f"afan/ops/kernels/resize_ce_kernel.py:{line}",
            "ms": total[half], "plain_ms": total[f"plain_{half}"],
            "bound_ms": max(byte_ms, op_ms),
            "bound_by": "bytes" if byte_ms >= op_ms else "operations",
            "library_ms": total[f"lib_{half}"]})
        print(f"    {name} per A-FAN step ({per_step} launches): kernel "
              f"{total[half]:.4f} ms, plain {total[f'plain_{half}']:.4f}, "
              f"library {total[f'lib_{half}']:.4f}, bound "
              f"{max(byte_ms, op_ms):.5f} ms ({entries[-1]['bound_by']}); "
              f"kernel at {total[half] / max(byte_ms, op_ms):.1f}x its bound")
    return entries


def segmentation_phases(card, kernels_only=False):
    """Phases 7-10 (with ``kernels_only``, phase 7 and the kernel timings
    of phase 10); returns the upsample + CE kernels' entries and the
    (shape, clip) of the PGD updates of the segmentation trainer."""
    errs = {"fwd": [], "bwd": []}
    ce_kernels_vs_plain(errs)
    per_step, launches, updates = sites_per_step(seg_recipe()), None, []
    if kernels_only:
        print(f"[10] upsample + CE kernel timing on {card} (no trainer)")
        _, labs = seg_batch()
    else:
        fwd, bwd, per_step, _, updates = train_full_width()
        launches = (fwd, bwd)
        gc.collect()
        torch.cuda.empty_cache()
        model, imgs, labs = seg_model_and_batch()
        step_kernel_vs_plain(model, imgs, labs)
        print(f"[10] timing on {card}")
        time_seg_steps(card, model, imgs, labs)
        del model, imgs
        gc.collect()
        torch.cuda.empty_cache()
    entries = time_ce_kernels(card, labs, per_step)
    for i, (entry, half) in enumerate(zip(entries, ("fwd", "bwd"))):
        entry["launches"] = launches[i] if launches else None
        entry["max_abs_err"] = max(errs[half])
    return entries, sorted(set(updates))


def bits_equal(a, b):
    """Bit-equal, NaN included: the int32 views are compared."""
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


SPECIAL = (0.0, -0.0, 1e-40, -1e-40, 1e-45, float("nan"), float("inf"),
           -float("inf"))


def pgd_inputs(shape, seed):
    """Seeded x, g, c on the card; g holds zeros, -0, denormals, NaN and
    infinities among normal values."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    n = int(np.prod(shape))
    x, g, c = (torch.randn(n, generator=gen, device="cuda")
               for _ in range(3))
    pos = torch.randperm(n, generator=gen, device="cuda")[:min(n, 1024)]
    special = torch.tensor(SPECIAL, device="cuda")
    g[pos] = special[torch.arange(len(pos), device="cuda") % len(SPECIAL)]
    return tuple(t.reshape(shape) for t in (x, g, c))


def pgd_case(name, x, g, c, clip, errs, gamma=ALFA_GAMMA, eps=ALFA_EPS):
    """Kernel (twice) and plain version on the same inputs: bit-equal, and
    the largest |kernel - plain| over entries finite in both goes to
    ``errs``."""
    kw = dict(gamma=gamma, eps=eps if clip else None, clip=clip)
    centre = c if clip else None
    got = kpgd.pgd_update(x, g, centre, **kw)
    again = kpgd.pgd_update(x, g, centre, **kw)
    want = tpgd.pgd_update_plain(x, g, centre, **kw)
    torch.cuda.synchronize()
    finite = torch.isfinite(got) & torch.isfinite(want)
    errs.append(float((got - want)[finite].abs().max()) if finite.any()
                else 0.0)
    same, repeat = bits_equal(got, want), bits_equal(got, again)
    print(f"  {name}: shape {tuple(x.shape)} clip={clip} gamma={gamma:.6g}: "
          f"bit-equal {same}, repeat bit-equal {repeat}")
    require(same, f"PGD-update kernel != plain on {name} clip={clip}")
    require(repeat, f"two runs of the PGD-update kernel differ on {name}")


def pgd_kernel_vs_plain(seg_updates, errs):
    """Phase 11."""
    print("[11] PGD-update kernel vs plain version")
    special = torch.tensor(SPECIAL + (2.0, -3.0), device="cuda")
    print(f"    torch.sign on the card of {special.tolist()}: "
          f"{torch.sign(special).tolist()}")
    model = resnet56().cuda().eval()
    with torch.no_grad():
        feats = model.multi_head(torch.zeros(CLS_BATCH, 3, 32, 32,
                                             device="cuda"),
                                 (ALFA_TAP,) + LEARNABLE_TAPS)
    cls_shapes = sorted({tuple(f.shape) for f in feats}, reverse=True)
    del model, feats
    # the sizes of tests/test_kernels.py:9-31, odd counts (a float4 pass
    # and a scalar tail; fewer than 4 elements), the ALFA and learnable taps
    # and the segmentation trainer's ascents
    cases = [((128,), False), ((4, 33, 7), False), ((2, 16, 16, 16), False),
             ((3, 50), True), ((1001,), False), ((1001,), True),
             ((3,), True), ((2_097_153,), True)]
    cases += [(s, clip) for s in cls_shapes for clip in (False, True)]
    cases += [(s, clip) for s, _ in seg_updates for clip in (False, True)]
    for i, (shape, clip) in enumerate(cases):
        pgd_case(f"case {i}", *pgd_inputs(shape, i), clip, errs)
    x, g, c = pgd_inputs((4097,), 99)
    for clip in (False, True):
        # views one float off 16-byte alignment take the scalar loop
        pgd_case("all views offset", x[1:], g[1:], c[1:], clip, errs)
        pgd_case("x offset", x[1:], g[:-1], c[:-1], clip, errs)
    x, g, c = pgd_inputs((4096,), 7)
    x[:8] = torch.tensor(SPECIAL, device="cuda")
    c[8:16] = torch.tensor(SPECIAL, device="cuda")
    for clip in (False, True):
        pgd_case("special x and centre", x, g, c, clip, errs)
        pgd_case("gamma 0.3 eps 0.2", x, g, c, clip, errs, 0.3, 0.2)
    print(f"    {len(errs)} cases bit-equal; classification tap shapes "
          f"{cls_shapes}; segmentation ascent shapes "
          f"{[s for s, _ in seg_updates] or 'not run'}")


def run_classify_cli(mode, flags, batches, tag):
    """One run of the classification CLI at full width on synthetic
    CIFAR-10, ``batches`` steps, one validation and one test pass; checks
    its losses and outputs. Returns (kernel launches in the run, losses,
    save_dir)."""
    save_dir = os.path.join("checkpoints", f"chip_smoke_classify_{tag}")
    shutil.rmtree(save_dir, ignore_errors=True)
    losses = []
    real = train_classify.build_step

    def recording(*a, **kw):
        step = real(*a, **kw)

        def run(*args):
            out = step(*args)
            losses.append(float(out["loss"]))
            return out
        return run

    train_classify.build_step = recording
    kpgd.launches = 0
    t0 = time.time()
    try:
        best = train_classify.main(
            ["--mode", mode, "--epochs", "1", "--limit_batches", str(batches),
             "--batch_size", str(CLS_BATCH), "--seed", "0", "--print_freq",
             "1", "--data", os.path.join(ROOT, "no_cifar_here"),
             "--save_dir", save_dir] + flags)
        torch.cuda.synchronize()
    finally:
        train_classify.build_step = real
    launches = kpgd.launches
    secs = time.time() - t0
    require(len(losses) == batches and np.isfinite(losses).all(),
            f"{tag}: losses {losses}")
    for f in ("checkpoint.pt", "best_model.pt", "result.pkl",
              "result_norm.pkl"):
        require(os.path.isfile(os.path.join(save_dir, f)), f"{tag}: no {f}")
    saved = torch.load(os.path.join(save_dir, "checkpoint.pt"),
                       map_location="cpu", weights_only=True)
    require(saved["epoch"] == 1 and saved["step"] == batches
            and all(bool(torch.isfinite(v).all())
                    for v in saved["state_dict"].values()
                    if v.is_floating_point()),
            f"{tag}: checkpoint is not the finished run's")
    with open(os.path.join(save_dir, "result.pkl"), "rb") as f:
        result = pickle.load(f)
    with open(os.path.join(save_dir, "result_norm.pkl"), "rb") as f:
        norms = pickle.load(f)
    require([len(v) for v in result.values()] == [1, 1, 1]
            and 0.0 <= result["test_ta"][0] <= 100.0,
            f"{tag}: result.pkl {result}")
    require(mode == "base" or norms["l2"][1] > 0,
            f"{tag}: result_norm.pkl {norms}")
    print(f"    {tag}: {batches} steps + validation + test in {secs:.1f} s; "
          f"losses {[round(v, 4) for v in losses]}; val {result['ta'][0]:.2f} "
          f"test {result['test_ta'][0]:.2f} (best {best:.2f}); perturbation "
          f"L2 {norms['l2'].get(1)}; PGD-update launches {launches}")
    return launches, losses, save_dir, result


def train_classify_full_width():
    """Phase 12; returns the ALFA run's kernel launches."""
    print(f"[12] train: ALFA ResNet-56, CIFAR-10 (synthetic), batch "
          f"{CLS_BATCH}, tap {ALFA_TAP}, {ALFA_STEPS} PGD steps")
    t0 = time.time()
    cifar.synthetic_arrays(seed=0)
    print(f"    synthetic CIFAR-10 (50k + 10k images) made on the host in "
          f"{time.time() - t0:.1f} s; each CLI run below makes it again")
    n = CLS_ALFA_BATCHES
    alfa, _, alfa_dir, result = run_classify_cli("alfa", [], n, "alfa")
    require(alfa == ALFA_STEPS * n,
            f"ALFA: {alfa} PGD-update launches in {n} steps (expected "
            f"{ALFA_STEPS} per step)")
    n = CLS_SHORT_BATCHES
    # the learnable recipe (`afan/train/loop.py:LearnableConfig`): 3 steps
    # of 1/255; the CLI's defaults are ALFA's
    learn, *_ = run_classify_cli(
        "learnable", ["--steps", str(LEARNABLE_STEPS), "--gamma", "1.0"], n,
        "learnable")
    per = LEARNABLE_STEPS * len(LEARNABLE_TAPS)
    require(learn == per * n,
            f"learnable: {learn} launches in {n} steps (expected {per})")
    clip, *_ = run_classify_cli(
        "alfa", ["--clip", "--randinit", "--device_data"], n,
        "alfa_clip_randinit_device_data")
    require(clip == ALFA_STEPS * n,
            f"ALFA with clip: {clip} launches in {n} steps")
    acc = infer_classify.main(
        ["--pretrained", os.path.join(alfa_dir, "best_model.pt"),
         "--batch_size", str(CLS_BATCH), "--data",
         os.path.join(ROOT, "no_cifar_here")])
    # the same weights on the same test set as the run's own test pass;
    # a logit tie broken the other way may move an image or two
    require(abs(acc - result["test_ta"][0]) <= 0.05,
            f"infer_classify read {acc} from best_model.pt, the run's test "
            f"pass {result['test_ta'][0]}")
    print(f"    PGD-update launches: ALFA {alfa} = {ALFA_STEPS} per step, "
          f"learnable {learn} = {per} per step, ALFA with clip {clip}; "
          f"infer_classify on best_model.pt: test {acc:.2f}")
    return alfa


def cls_batch(seed):
    x, y, _, _ = cifar.synthetic_arrays(CLS_BATCH, 1, 10, seed)
    return cuda(x.astype(np.float32) / 255.0), cuda(y)


def cls_step(mode, schedule=None, seed=0):
    """A fresh seeded ResNet-56 on the card and a ``mode`` step with the
    CLI's optimizer (lr 0.1, momentum 0.9, wd 5e-4; by default the CLI's
    warmup + multistep schedule at 351 steps per epoch)."""
    spe = 45000 // CLS_BATCH
    if schedule is None:
        schedule = multistep_warmup_schedule(0.1, [50 * spe, 150 * spe],
                                             warmup_steps=spe)
    init = 1.0 / 9 if mode == "learnable" else 1.0
    model = resnet56(init_weight_eta=init,
                     generator=torch.Generator().manual_seed(seed)).cuda()
    if mode == "learnable":
        opt, sched = learnable_sgd(model, schedule, 0.1, 0.01, 0.9, 5e-4)
        return model, cls_loop.make_learnable_step(
            model, opt, sched, cls_loop.LearnableConfig())
    opt, sched = sgd([{"params": list(model.parameters())}], schedule, 0.1,
                     0.9, 5e-4)
    if mode == "base":
        return model, cls_loop.make_base_step(model, opt, sched)
    return model, cls_loop.make_alfa_step(model, opt, sched,
                                          cls_loop.AlfaConfig())


def alfa_step_kernel_vs_plain():
    """Phase 13: the same step, from the same weights and batch, with the
    kernel and with the plain update, in full f32 with deterministic
    cuDNN."""
    print("[13] ALFA step with the kernel vs with the plain update")
    x, y = cls_batch(0)
    flags = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark, torch.backends.cudnn.allow_tf32)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.allow_tf32 = False
    real_pgd = cls_loop.pgd
    runs = []
    try:
        for update in (tpgd.pgd_update, tpgd.pgd_update_plain):
            # a constant lr: the CLI's schedule starts at lr 0
            model, step = cls_step("alfa", schedule=lambda count: 0.1)
            advs = []

            def recording_pgd(*a, **kw):
                advs.append(real_pgd(*a, **kw))
                return advs[-1]

            cls_loop.pgd = recording_pgd
            kpgd.launches = 0
            with patched_update(update):
                out = step(x, y)
            torch.cuda.synchronize()
            runs.append(({k: float(v) for k, v in out.items()}, advs[0],
                         {k: v.detach().clone()
                          for k, v in model.state_dict().items()
                          if v.is_floating_point()}, kpgd.launches))
    finally:
        cls_loop.pgd = real_pgd
        (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark,
         torch.backends.cudnn.allow_tf32) = flags
    (mk, ak, pk, lk), (mp, ap, pp, lp) = runs
    metric_err = max(abs(mk[k] - mp[k]) / max(abs(mp[k]), 1e-30) for k in mk)
    param_err = max(float((pk[k] - pp[k]).abs().max())
                    / max(float(pp[k].abs().max()), 1e-30) for k in pk)
    print(f"    metrics kernel {mk}")
    print(f"    metrics plain  {mp}")
    print(f"    PGD-update launches {lk} (kernel) and {lp} (plain); "
          f"adversarial feature {tuple(ak.shape)} bit-equal "
          f"{bits_equal(ak, ap)}; largest metric rel err {metric_err:.3e}; "
          f"largest parameter / running-statistic rel err {param_err:.3e}")
    require(lk == ALFA_STEPS and lp == 0,
            f"launches {lk} with the kernel, {lp} with the plain update")
    require(bits_equal(ak, ap), "adversarial features differ")
    require(metric_err <= 1e-6, f"metrics differ by {metric_err}")
    require(param_err <= 1e-6, f"updated parameters differ by {param_err}")


def queued_ms(fn, reps=100):
    """Device ms per call of ``fn``: a sleep kernel holds the card while the
    host queues every call, so the events time the calls back to back on
    the card and not the host's launch rate."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(200_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def back_to_back_us(fn, reps=200):
    """Wall microseconds per call of ``fn`` called back to back and then
    synchronised: the host's cost per call where it exceeds the card's."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e6


def time_pgd_update(card, shape):
    """The kernel, its plain version and the bound at ``shape``, with and
    without the clip: per-call device ms, inputs cycled through 8 sets
    (192 MB, above the 50 MB L2) so each call reads them from HBM; and the
    wall time per call back to back."""
    n = int(np.prod(shape))
    sets = itertools.cycle([pgd_inputs(shape, 100 + i) for i in range(8)])
    out = {}
    for clip in (False, True):
        kw = dict(gamma=ALFA_GAMMA, eps=ALFA_EPS if clip else None,
                  clip=clip)

        def call(fn):
            x, g, c = next(sets)
            return fn(x, g, c if clip else None, **kw)

        k_ms = queued_ms(lambda: call(kpgd.pgd_update))
        p_ms = queued_ms(lambda: call(tpgd.pgd_update_plain))
        k_us = back_to_back_us(lambda: call(tpgd.pgd_update))
        p_us = back_to_back_us(lambda: call(tpgd.pgd_update_plain))
        byte_ms = (3 + clip) * 4 * n / HBM_BYTES_PER_S * 1e3
        op_ms = (PGD_CLIP_OPS if clip else PGD_OPS) * n / F32_OPS_PER_S * 1e3
        out[clip] = (k_ms, p_ms, byte_ms, op_ms)
        print(f"    pgd_update {shape} clip={clip}: kernel {k_ms:.5f} ms, "
              f"plain {p_ms:.5f} ms, bound max(bytes {byte_ms:.5f}, "
              f"operations {op_ms:.6f}) ms; kernel at "
              f"{k_ms / max(byte_ms, op_ms):.2f}x its bound; back to back, "
              f"through ops.pgd_step: {k_us:.1f} us per call with the "
              f"kernel, {p_us:.1f} us plain ({card})")
    return out


def time_classify(card):
    """Phase 14; returns the kernel's per-ALFA-step times and bound."""
    print(f"[14] timing on {card}")
    x, y = cls_batch(1)
    medians = {}
    for mode in ("alfa", "base", "learnable"):
        _, step = cls_step(mode)
        t = cuda_samples(lambda: step(x, y), 20)
        torch.cuda.reset_peak_memory_stats()
        step(x, y)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() / 2**30
        medians[mode] = float(np.median(t))
        print(f"    {mode} step, ResNet-56, batch {CLS_BATCH}: median "
              f"{np.median(t):.3f} ms, p90 {np.percentile(t, 90):.3f} ms over "
              f"{len(t)} steps, {CLS_BATCH * 1e3 / np.median(t):.1f} imgs/s, "
              f"peak memory {peak:.3f} GiB ({card})")
        if mode == "alfa":
            alfa_step = step
    # the same step with the plain update, in turns with the kernel:
    # kernel, plain, plain, kernel, three times, 20 steps each
    turns = {tpgd.pgd_update: [], tpgd.pgd_update_plain: []}
    for update in (tpgd.pgd_update, tpgd.pgd_update_plain,
                   tpgd.pgd_update_plain, tpgd.pgd_update) * 3:
        with patched_update(update):
            t = cuda_samples(lambda: alfa_step(x, y), 20)
        turns[update].append(float(np.median(t)))
    for update, meds in turns.items():
        print(f"    ALFA step with {update.__name__}: medians of 6 turns of "
              f"20 steps {[round(m, 3) for m in meds]} ms, their median "
              f"{np.median(meds):.3f} ms ({card})")
    profile_step(lambda: alfa_step(x, y), n=5, label="ALFA")
    k_ms, p_ms, byte_ms, op_ms = time_pgd_update(
        card, (CLS_BATCH, 16, 32, 32))[False]
    print(f"    pgd_update per ALFA step ({ALFA_STEPS} launches): kernel "
          f"{ALFA_STEPS * k_ms:.5f} ms = "
          f"{100 * ALFA_STEPS * k_ms / medians['alfa']:.3f}% of the step, "
          f"plain {ALFA_STEPS * p_ms:.5f} ms, bound "
          f"{ALFA_STEPS * max(byte_ms, op_ms):.5f} ms ({card})")
    return {"ms": ALFA_STEPS * k_ms, "plain_ms": ALFA_STEPS * p_ms,
            "bound_ms": ALFA_STEPS * max(byte_ms, op_ms),
            "bound_by": "bytes" if byte_ms >= op_ms else "operations"}


def classification_phases(card, seg_updates):
    """Phases 11-14; returns the PGD-update kernel's entry."""
    errs = []
    pgd_kernel_vs_plain(seg_updates, errs)
    launches = train_classify_full_width()
    gc.collect()
    torch.cuda.empty_cache()
    alfa_step_kernel_vs_plain()
    times = time_classify(card)
    return {"name": "pgd_update", "route": "cuda",
            "source": "afan_torch/csrc/pgd_step.cu",
            "replaces": "afan/ops/kernels/pgd_step.py:40",
            "launches": launches, "max_abs_err": max(errs), **times,
            "library_ms": None}


# recipes/detect_voc07_final_setting1.sh's flags but --bf16 (not ported),
# its output directory and its length; the data is the synthetic VOC
DET_BATCH, DET_STEPS = 8, 2
DET_FLAGS = ["--variant", "afan", "-s", "voc2007", "-b", "resnet50",
             "--batch_size", str(DET_BATCH), "--learning_rate", "0.008",
             "--step_lr_sizes", "[6250, 8750]", "--mix_layer", "0011",
             "--pertub_idx_se", "2", "--gamma_se", "1.0", "--gamma_sd", "0.1",
             "--sd_adv_loss_weight", "0.3", "--only_roi_sd"]
DET_OUT = os.path.join("checkpoints", "chip_smoke_detect")
DET_BACKBONE = os.path.join(DET_OUT, "resnet50_calibrated.pth")
# proposal NMS and PGD-update launches per step with share_proposals
DET_NMS_PER_STEP = {"afan": 2, "baseline": 1}
DET_PGD_PER_STEP = {"afan": 2, "baseline": 0}
DET_EVAL_IMAGES = 16


def det_recipe():
    args = train_detect.get_parser().parse_args(DET_FLAGS)
    return train_detect.afan_config_for(args)


def calibrated_backbone(seed=0):
    """Write a seeded random ResNet-50 torso, in torchvision's keys, to
    ``DET_BACKBONE``, for ``--pretrained_backbone``. The recipe starts from
    an ImageNet backbone whose frozen BatchNorms fit their inputs; with
    identity statistics the random torso's activations grow block by block
    and the recipe's SGD diverges within a few steps. So each frozen
    BatchNorm takes its input's per-channel mean and variance on a
    synthetic VOC batch, in one forward in which each one is set before it
    runs."""
    torso = det_model(seed, backbone=None).features

    def fit(bn, inputs):
        var, mean = torch.var_mean(inputs[0], dim=(0, 2, 3), correction=0)
        bn.running_mean.copy_(mean)
        bn.running_var.copy_(var)

    hooks = [m.register_forward_pre_hook(fit) for m in torso.modules()
             if isinstance(m, FrozenBatchNorm)]
    try:
        with torch.no_grad():
            torso(det_batch(seed + 1)[0].permute(0, 3, 1, 2), 0, 4)
    finally:
        for h in hooks:
            h.remove()
    os.makedirs(DET_OUT, exist_ok=True)
    torch.save(torso.state_dict(), DET_BACKBONE)
    return DET_BACKBONE


def run_detect_cli(variant, steps, tag, extra=()):
    """One run of the detection CLI at full width with the recipe's flags,
    until step ``steps``, and its final mAP. Returns (per-step (NMS,
    PGD-update) launches, losses, NMS launches of the final eval, mAP,
    output directory)."""
    out = os.path.join(DET_OUT, tag)
    if not extra:
        shutil.rmtree(out, ignore_errors=True)
    per_step, losses = [], []
    factory = ("make_afan_det_step" if variant == "afan"
               else "make_baseline_det_step")
    real = getattr(train_detect, factory)

    def recording(*a, **kw):
        step = real(*a, **kw)

        def run(*args):
            before = (knms.launches, kpgd.launches)
            res = step(*args)
            per_step.append((knms.launches - before[0],
                             kpgd.launches - before[1]))
            losses.append({k: float(v) for k, v in res.items()})
            return res
        return run

    setattr(train_detect, factory, recording)
    knms.launches = kpgd.launches = 0
    t0 = time.time()
    try:
        mean_ap = train_detect.main(
            DET_FLAGS + ["--variant", variant, "-o", out, "--data_dir",
                         os.path.join(ROOT, "no_voc_here"),
                         "--num_steps_to_finish", str(steps),
                         "--num_steps_to_snapshot", str(steps),
                         "--num_steps_to_display", "1",
                         "--pretrained_backbone", DET_BACKBONE]
            + list(extra))
        torch.cuda.synchronize()
    finally:
        setattr(train_detect, factory, real)
    secs = time.time() - t0
    eval_nms = knms.launches - sum(n for n, _ in per_step)
    require(all(np.isfinite(v) for rec in losses for v in rec.values()),
            f"{tag}: non-finite loss in {losses}")
    require(per_step == [(DET_NMS_PER_STEP[variant],
                          DET_PGD_PER_STEP[variant])] * len(per_step),
            f"{tag}: (NMS, PGD-update) launches per step {per_step}")
    require(eval_nms == 2 * DET_EVAL_IMAGES,
            f"{tag}: {eval_nms} NMS launches in the final eval (expected 2 "
            f"per image)")
    saved = torch.load(os.path.join(out, f"model-{steps}.pt"),
                       map_location="cpu", weights_only=True)
    require(saved["step"] == steps
            and saved["scheduler_state_dict"]["last_epoch"] == steps
            and len(saved["optimizer_state_dict"]["state"]) > 0
            and all(bool(torch.isfinite(v).all())
                    for v in saved["state_dict"].values()
                    if v.is_floating_point()),
            f"{tag}: model-{steps}.pt is not the finished run's")
    require(0.0 <= mean_ap <= 1.0, f"{tag}: mAP {mean_ap}")
    print(f"    {tag}: {len(per_step)} steps + the final mAP of "
          f"{DET_EVAL_IMAGES} images in {secs:.1f} s (the first step "
          f"includes cuDNN set-up); losses "
          f"{[round(r['loss'], 4) for r in losses]}; (NMS, PGD-update) "
          f"launches per step {per_step[0] if per_step else None}, NMS in "
          f"the eval {eval_nms}; mAP {mean_ap:.4f}; model-{steps}.pt")
    return per_step, losses, eval_nms, mean_ap, out


def train_detect_full_width():
    """Phase 15; returns the (NMS, PGD-update) kernel launches of the
    training path (steps and final evals) and the A-FAN steps' losses."""
    print(f"[15] train: A-FAN Faster R-CNN ResNet-50, VOC final setting 1, "
          f"batch {DET_BATCH}, synthetic VOC")
    print(f"    backbone: seeded random weights, frozen-BatchNorm statistics "
          f"fitted on a synthetic VOC batch: {calibrated_backbone()}")
    afan, afan_losses, ev1, _, out = run_detect_cli("afan", DET_STEPS,
                                                    "afan")
    resumed, _, ev2, _, _ = run_detect_cli(
        "afan", DET_STEPS + 1, "afan",
        ["--resume_checkpoint", os.path.join(out, f"model-{DET_STEPS}.pt")])
    require(len(resumed) == 1, f"the resumed run took {len(resumed)} steps")
    base, _, ev3, _, _ = run_detect_cli("baseline", 2, "baseline")
    steps = afan + resumed + base
    nms = sum(n for n, _ in steps) + ev1 + ev2 + ev3
    pgd = sum(p for _, p in steps)
    print(f"    NMS launches {nms} ({len(afan) + len(resumed)} A-FAN steps x "
          f"2 + {len(base)} baseline steps x 1 + 3 evals x "
          f"{2 * DET_EVAL_IMAGES}); PGD-update launches {pgd}")
    return nms, pgd, afan_losses


def det_batch(seed=0):
    loader, _, _ = voc_detection_loaders(None, DET_BATCH, MIN_SIDE, MAX_SIDE,
                                         seed)
    b = next(iter(loader))
    return (cuda(b.images), cuda(b.boxes), cuda(b.labels.astype(np.int64)),
            cuda(b.valid))


def det_model(seed=0, backbone=DET_BACKBONE):
    """The recipe's ResNet-50 Faster R-CNN (21 classes) on the card, from
    seeded weights, its torso from ``backbone`` where given."""
    model = FasterRCNN(FRCNNConfig())
    model.reset_parameters(torch.Generator().manual_seed(seed))
    if backbone:
        overlap_restore(model.features, load_checkpoint(backbone))
    return model.cuda()


def det_step(model, afan=True):
    opt, sched = sgd(detect_loop.detection_param_groups(model),
                     warmup_multistep_schedule(0.008, [6250, 8750]), 0.008,
                     0.9, 5e-4)
    if afan:
        return detect_loop.make_afan_det_step(model, opt, sched,
                                              det_recipe())
    return detect_loop.make_baseline_det_step(model, opt, sched)


def recording_nms(fn, calls):
    """NMS keep-mask function that runs ``fn`` and appends its inputs and
    keep mask to ``calls``."""
    def run(boxes, valid, thr, plus_one=True):
        keep = fn(boxes, valid, thr, plus_one)
        calls.append((boxes.clone(), valid.clone(), thr, plus_one,
                      keep.clone()))
        return keep
    return run


def det_step_kernel_vs_plain(model, batch):
    """Phase 16: one A-FAN step with the NMS and PGD-update kernels and one
    with their plain versions, from the same weights and batch and the same
    seeded generator (so the same draws), in full f32. Returns the recorded
    NMS calls of the kernel step and the PGD updates' inputs."""
    print("[16] A-FAN detection step with the kernels vs with the plain "
          "NMS and PGD update")
    state = copy.deepcopy(model.state_dict())
    flags = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark, torch.backends.cudnn.allow_tf32)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.allow_tf32 = False
    runs, updates = [], []

    def update_recorder(fn):
        def update(x, g, center=None, **kw):
            updates.append((x.contiguous().clone(), g.contiguous().clone()))
            return fn(x, g, center, **kw)
        return update

    try:
        for nms_fn, update in ((knms.nms_sorted_mask, tpgd.pgd_update),
                               (tnms.nms_sorted_mask_plain,
                                tpgd.pgd_update_plain)):
            model.load_state_dict(state)
            step = det_step(model)
            calls = []
            with patched_nms(recording_nms(nms_fn, calls)), \
                    patched_update(update_recorder(update)):
                out = step(*batch, torch.Generator("cuda").manual_seed(0))
            params = {n: p.detach().clone()
                      for n, p in model.named_parameters() if p.requires_grad}
            runs.append(({k: float(v) for k, v in out.items()}, calls,
                         params))
        torch.cuda.synchronize()
    finally:
        (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark,
         torch.backends.cudnn.allow_tf32) = flags
        model.load_state_dict(state)
    (lk, ck, pk), (lp, cp, pp) = runs
    require(len(ck) == len(cp) == 2, f"{len(ck)}, {len(cp)} NMS calls")
    for (bk, vk, _, _, kk), (bp, vp, _, _, kp) in zip(ck, cp):
        require(torch.equal(bk, bp) and torch.equal(vk, vp),
                "the NMS inputs differ between the kernel and plain steps")
        require(torch.equal(kk, kp), "keep masks differ")
    loss_err = max(abs(lk[k] - lp[k]) / max(abs(lp[k]), 1e-30) for k in lk)
    param_err = max(float(torch.linalg.vector_norm(pk[n] - pp[n])
                          / torch.linalg.vector_norm(pp[n]).clamp_min(1e-30))
                    for n in pk)
    kept = [c[4].sum(1).tolist() for c in ck]
    print(f"    proposal NMS G={ck[0][0].shape[0]} N={ck[0][0].shape[1]}: "
          f"keep masks identical, kept per image {kept}")
    print(f"    losses kernel {lk}")
    print(f"    losses plain  {lp}")
    print(f"    largest loss rel err {loss_err:.3e}; updated parameters "
          f"{len(pk)} tensors, largest L2 rel err {param_err:.3e}")
    require(loss_err <= 1e-4, f"step losses differ by {loss_err}")
    require(param_err <= 1e-4, f"updated parameters differ by {param_err}")
    return ck, updates[:len(updates) // 2]


def time_det_steps(card, model, batch):
    """Phase 17, the steps: the A-FAN and baseline steps' times and peak
    memory, and where the A-FAN step's device time goes."""
    gen = torch.Generator("cuda").manual_seed(1)
    medians = {}
    for afan, name, n in ((True, "A-FAN", 8), (False, "baseline", 10)):
        step = det_step(model, afan)
        t = cuda_samples(lambda: step(*batch, gen), n, warmup=2)
        torch.cuda.reset_peak_memory_stats()
        step(*batch, gen)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() / 2**30
        medians[name] = float(np.median(t))
        print(f"    {name} detection step, batch {DET_BATCH}, canvas "
              f"{tuple(batch[0].shape[1:3])}: median {np.median(t):.3f} ms, "
              f"p90 {np.percentile(t, 90):.3f} ms over {len(t)} steps, "
              f"{DET_BATCH * 1e3 / np.median(t):.2f} imgs/s, peak memory "
              f"{peak:.2f} GiB ({card})")
    step = det_step(model)
    # the A-FAN step with each image's ROIs pooled from its own rows (the
    # path) in turns with the concatenated contraction over all images'
    # rows: per-image, concatenated, concatenated, per-image, twice
    turns = {"per-image": [], "concatenated": []}
    for how in ("per-image", "concatenated") * 2:
        for name in (how, "per-image" if how == "concatenated"
                     else "concatenated"):
            with patched_pooler(name == "concatenated"):
                t = cuda_samples(lambda: step(*batch, gen), 4, warmup=1)
            turns[name].append(float(np.median(t)))
    for name, meds in turns.items():
        print(f"    A-FAN step with the {name} ROIAlign contraction: medians "
              f"of 4 turns of 4 steps {[round(m, 3) for m in meds]} ms, "
              f"their median {np.median(meds):.3f} ms ({card})")
    profile_step(lambda: step(*batch, gen), n=3, label="A-FAN detection")
    return medians


@contextlib.contextmanager
def patched_pooler(concatenated):
    """With ``concatenated``, pool each image's boxes through the contraction
    over all images' rows (``roi_align_einsum`` with batch indices) instead
    of the per-image one, for the duration of the block."""
    saved = roi_head.pool_rois
    if concatenated:
        def pool(feat, boxes, batch_indices=None, mode="align"):
            bidx = torch.arange(boxes.shape[0], device=boxes.device)
            return saved(feat, boxes.reshape(-1, 4),
                         bidx.repeat_interleave(boxes.shape[1]), mode)
        roi_head.pool_rois = pool
    try:
        yield
    finally:
        roi_head.pool_rois = saved


def time_det_kernels(card, nms_calls, updates, afan_ms):
    """Phase 17, the kernels at the A-FAN step's own shapes: the proposal
    NMS on the step's real proposals (G=8, N=12000; both of the step's
    launches take the same proposals) and the two PGD updates (the layer-2
    feature and the pooled ROI vector). Returns their per-step entries."""
    boxes, valid, thr, plus_one, _ = nms_calls[0]
    require(all(torch.equal(boxes, c[0]) for c in nms_calls),
            "the step's two proposal NMS took different proposals")
    k, p, b, o = time_nms_shape(card, "training proposals", boxes, valid,
                                thr, plus_one)
    n = DET_NMS_PER_STEP["afan"]
    print(f"    nms per A-FAN step ({n} launches): kernel {n * k:.4f} ms = "
          f"{100 * n * k / afan_ms:.3f}% of the step, plain {n * p:.3f} ms, "
          f"bound {n * max(b, o):.6f} ms ({card})")
    nms = {"ms": n * k, "plain_ms": n * p, "bound_ms": n * max(b, o),
           "bound_by": "bytes" if b >= o else "operations"}
    pgd = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0}
    parts = []
    for x, _ in updates:
        k_ms, p_ms, byte_ms, op_ms = time_pgd_update(card,
                                                     tuple(x.shape))[False]
        pgd["ms"] += k_ms
        pgd["plain_ms"] += p_ms
        pgd["bound_ms"] += max(byte_ms, op_ms)
        parts.append("bytes" if byte_ms >= op_ms else "operations")
    pgd["bound_by"] = max(set(parts), key=parts.count)
    print(f"    pgd_update per A-FAN step ({len(updates)} launches, shapes "
          f"{[tuple(x.shape) for x, _ in updates]}): kernel {pgd['ms']:.5f} "
          f"ms = {100 * pgd['ms'] / afan_ms:.4f}% of the step, plain "
          f"{pgd['plain_ms']:.5f} ms, bound {pgd['bound_ms']:.5f} ms "
          f"({card})")
    return nms, pgd


def detection_training_phases(card):
    """Phases 15-17; returns the NMS and PGD-update kernels' entries for
    the detection training path."""
    nms_launches, pgd_launches, _ = train_detect_full_width()
    gc.collect()
    torch.cuda.empty_cache()
    model, batch = det_model(), det_batch()
    nms_calls, updates = det_step_kernel_vs_plain(model, batch)
    nms_err = [0.0]
    for boxes, valid, thr, plus_one, _ in nms_calls:
        kernel_vs_plain("training proposals", boxes, valid, thr, plus_one,
                        nms_err)
    pgd_err = []
    for x, g in updates:
        for clip in (False, True):
            pgd_case(f"detection ascent {tuple(x.shape)}", x, g, x, clip,
                     pgd_err)
    print(f"[17] timing on {card}")
    medians = time_det_steps(card, model, batch)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    nms, pgd = time_det_kernels(card, nms_calls, updates, medians["A-FAN"])
    return (
        {"name": "nms", "route": "cuda", "source": "afan_torch/csrc/nms.cu",
         "replaces": "afan/ops/kernels/nms_kernel.py:65",
         "launches": nms_launches, "max_abs_err": max(nms_err), **nms,
         "library_ms": None},
        {"name": "pgd_update", "route": "cuda",
         "source": "afan_torch/csrc/pgd_step.cu",
         "replaces": "afan/ops/kernels/pgd_step.py:40",
         "launches": pgd_launches, "max_abs_err": max(pgd_err), **pgd,
         "library_ms": None})


def merge_entry(entries, extra):
    """Add the detection training path's part to a kernel's entry: the
    launches, times and bounds of both paths summed, the larger error."""
    for e in entries:
        if e["name"] != extra["name"]:
            continue
        if e["bound_ms"] < extra["bound_ms"]:
            e["bound_by"] = extra["bound_by"]
        for key in ("ms", "plain_ms", "bound_ms"):
            e[key] += extra[key]
        e["launches"] = (e["launches"] or 0) + extra["launches"]
        e["max_abs_err"] = max(e["max_abs_err"], extra["max_abs_err"])
        return
    entries.append(extra)


GROUPS = ("nms", "ce", "seg", "det", "cls", "dettrain")


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--only", choices=GROUPS,
                        help="run only this group's phases (see above)")
    args = parser.parse_args(argv)
    only = args.only
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        sys.exit(1)

    # 1. device
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    card = f"{name}, power limit {smi.split(',')[-1].strip()}"
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"[1] device: {name} (x{torch.cuda.device_count()}), torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}")
    print(smi)
    print(f"    cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
          f"cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}")

    # 2. build
    t0 = time.time()
    seconds = kbuild.build_all()
    knms.load_library()
    krce.load_library()
    kpgd.load_library()
    print(f"[2] built {', '.join(f'{s} in {t:.1f} s' for s, t in seconds.items())}"
          f" (one nvcc each, together {time.time() - t0:.1f} s) into "
          f"{os.path.relpath(kbuild.BUILD_DIR, ROOT)}")

    entries, seg_updates = [], []
    if only in (None, "det", "nms"):
        entries.append(detection_phases(card, only == "nms"))
        gc.collect()
        torch.cuda.empty_cache()
    if only in (None, "seg", "ce"):
        seg_entries, seg_updates = segmentation_phases(card, only == "ce")
        entries += seg_entries
        gc.collect()
        torch.cuda.empty_cache()
    if only in (None, "cls"):
        entries.append(classification_phases(card, seg_updates))
        gc.collect()
        torch.cuda.empty_cache()
    if only in (None, "dettrain"):
        for extra in detection_training_phases(card):
            merge_entry(entries, extra)

    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
