"""Back-to-back A-FAN detection training steps: the step function of
``afan_torch/train/detect_loop.make_afan_det_step`` as ``train_detect``
builds it from the configuration's recipe flags, fed VOC-like batches made
on the device from the seed (cycling through a pool) and one sampling
generator seeded from it, as the CLI passes one.

Set-up makes the weights, fits each frozen BatchNorm of the torso to a
pool batch (``chip_smoke.calibrated_backbone``'s rule, on the reference's
torso, in memory), builds the model, optimizer and step once and drives the
first ``check_steps`` steps through the window's own call. After the
window the program is freed and the reference, a frozen copy of the port's
step with the kernels' plain forms (``benchmark/reference/det/``), follows
the first steps from the same weights, batches and generator seed;
:mod:`benchmark.lib.compare` decides ``correct``.
"""
from __future__ import annotations

import ast
from types import SimpleNamespace
from typing import Dict, List, Tuple

import torch

from benchmark.lib import (bounds, compare, detection, harness, trace,
                           traffic, training, weights, work)
from benchmark.reference.det import attack as ref_attack
from benchmark.reference.det import detect_loop as ref_loop
from benchmark.reference.det import resnet as ref_resnet
from benchmark.reference.det import roi_align as ref_roi_align
from benchmark.reference.det.frcnn import model as ref_model

GIB = 2 ** 30


def _frcnn_config(cfg: Dict) -> ref_model.FRCNNConfig:
    return ref_model.FRCNNConfig(
        backbone=cfg["backbone"], num_classes=cfg["num_classes"],
        anchor_ratios=tuple(tuple(r) for r in cfg["anchor_ratios"]),
        anchor_sizes=tuple(cfg["anchor_sizes"]),
        train_pre_nms_top_n=cfg["train_pre_nms_top_n"],
        train_post_nms_top_n=cfg["train_post_nms_top_n"])


def afan_config(cfg: Dict) -> ref_loop.DetAfanConfig:
    """The recipe's A-FAN settings (step sizes in 1/255 units, the
    spectrum's AFN mask from ``mix_layer``)."""
    a = cfg["train"]["afan"]
    mask = [0] * a["spectrum"]
    for i, ch in enumerate(a["mix_layer"][:a["spectrum"] - 1]):
        mask[i + 1] = int(ch == "1")
    return ref_loop.DetAfanConfig(
        taps_se=(a["pertub_idx_se"],), gammas_se=(a["gamma_se"] / 255,),
        spectrum=a["spectrum"], mix_mask=tuple(mask), sd=a["sd"],
        gamma_sd=a["gamma_sd"] / 255, only_roi_sd=a["only_roi_sd"],
        mix_sd=a["mix_sd"], sd_weight=a["sd_adv_loss_weight"],
        share_proposals=a["share_proposals"])


def program(cell: harness.Cell, state: Dict, device):
    """The port's model, optimizer and step, as ``train_detect`` builds
    them from the recipe's flags."""
    from afan_torch.cli import train_detect
    from afan_torch.models.frcnn import FasterRCNN
    from afan_torch.train.detect_loop import (detection_param_groups,
                                              make_afan_det_step)
    from afan_torch.train.optim import sgd, warmup_multistep_schedule
    args = train_detect.get_parser().parse_args(
        cell.config["train"]["recipe_flags"])
    with torch.device(device):
        model = FasterRCNN(
            train_detect.frcnn_config(args, cell.config["num_classes"]),
            torch.bfloat16 if args.bf16 else torch.float32)
    model.load_state_dict(state)
    schedule = warmup_multistep_schedule(
        args.learning_rate, ast.literal_eval(args.step_lr_sizes),
        args.step_lr_gamma, args.warm_up_factor, args.warm_up_num_iters)
    opt, sched = sgd(
        detection_param_groups(model, freeze=not args.unfreeze_backbone),
        schedule, args.learning_rate, args.momentum, args.weight_decay)
    step = make_afan_det_step(model, opt, sched,
                              train_detect.afan_config_for(args))
    return model, opt, lambda batch, gen: step(*batch, gen)["loss"]


def _schedule(t: Dict):
    """Detection's warm-up multi-step lr as a factor of the base lr."""
    def factor(count: int) -> float:
        f = 1.0
        for m in sorted(t["step_lr_sizes"]):
            if count >= m:
                f *= t["step_lr_gamma"]
        alpha = min(count / max(t["warm_up_num_iters"], 1), 1.0)
        return f * (t["warm_up_factor"] + (1.0 - t["warm_up_factor"])
                    * alpha)
    return factor


def reference(cell: harness.Cell, state: Dict, device, fp8: bool = False):
    """The frozen copy's model, optimizer and step in the configuration's
    precision (``fp8``: every convolution and linear through float8 e4m3,
    the control)."""
    cfg, t = cell.config, cell.config["train"]
    with torch.device(device):
        model = ref_model.FasterRCNN(
            _frcnn_config(cfg), getattr(torch, t["precision"]))
    for m in model.modules():
        if isinstance(m, (ref_resnet.Conv2d, ref_resnet.Linear)):
            m.fp8 = fp8
    model.load_state_dict(state)
    groups = ref_loop.detection_param_groups(model, freeze=True)
    opt = torch.optim.SGD([dict(g, lr=t["learning_rate"]) for g in groups],
                          lr=t["learning_rate"], momentum=t["momentum"],
                          weight_decay=t["weight_decay"])
    sched = torch.optim.lr_scheduler.LambdaLR(opt, _schedule(t))
    step = ref_loop.make_afan_det_step(model, opt, sched, afan_config(cfg))
    return model, opt, lambda batch, gen: step(*batch, gen)["loss"]


def shapes(cell: harness.Cell):
    with torch.device("meta"):
        return weights.state_shapes(ref_model.FasterRCNN(
            _frcnn_config(cell.config)))


def batches(cell: harness.Cell, seed: int, device):
    cfg = cell.config
    return traffic.det_batches(seed, cell.traffic, cfg["batch_size"],
                               detection.canvas_hw(cfg), device)


def state_for(cell: harness.Cell, seed: int, pool, device) -> Dict:
    """Seeded weights, the frozen BatchNorms fitted to the pool's first
    batch, layer4's alias tied."""
    state = detection.seeded_state(shapes(cell), seed, device)
    return detection.calibrated(cell.config["backbone"], state,
                                pool[0][0], device)


def _batch(pool, k: int):
    i = k % pool[0].shape[0]
    return tuple(t[i] for t in pool)


def readings(build, cell: harness.Cell, seed: int, device, pool, **kw):
    state = state_for(cell, seed, pool, device)
    model, opt, step = build(cell, state, device, **kw)
    params = {n: p for n, p in model.named_parameters() if p.requires_grad}
    gen = traffic.generator(seed, device, 4)
    got = compare.first_steps(
        lambda k: step(_batch(pool, k), gen), params, opt, state,
        cell.config["train"]["weight_decay"], cell.traffic["check_steps"])
    return got, (step, gen)


class _BilinearTaps(torch.autograd.Function):
    """ROIAlign on meta, counted as the algorithm's work: each output
    element averages ``s * s`` samples of 4 bilinear taps, a multiply and
    an add each, in the forward and again in the backward to the feature.
    (The reference computes it as dense contractions over every row and
    column of the feature, which the FLOP counter would count whole.)"""

    @staticmethod
    def forward(ctx, feat, out_shape, sampling_ratio, rec):
        ctx.feat_shape, ctx.rec = feat.shape, rec
        out = feat.new_zeros(out_shape)
        ctx.flops = 8.0 * sampling_ratio ** 2 * out.numel()
        rec.extra_flops += ctx.flops
        return out

    @staticmethod
    def backward(ctx, grad):
        ctx.rec.extra_flops += ctx.flops
        return grad.new_zeros(ctx.feat_shape), None, None, None


def _counted_roi_align(rec):
    """Stand-ins for the reference's two ROIAlign forms that count taps."""
    def per_image(feat, boxes, output_size=(14, 14), spatial_scale=1 / 16,
                  sampling_ratio=2):
        shape = (boxes.shape[0] * boxes.shape[1], feat.shape[1]) + tuple(
            output_size)
        return _BilinearTaps.apply(feat, shape, sampling_ratio, rec)

    def einsum(feat, boxes, batch_indices, output_size=(14, 14),
               spatial_scale=1 / 16, sampling_ratio=2):
        shape = (boxes.shape[0], feat.shape[1]) + tuple(output_size)
        return _BilinearTaps.apply(feat, shape, sampling_ratio, rec)

    return {"roi_align_per_image": per_image, "roi_align_einsum": einsum}


def count_work(cell: harness.Cell):
    """(FLOPs, PGD-update calls) of one step: the frozen copy on meta, its
    ROIAlign counted by bilinear taps."""
    cfg = cell.config
    b, g = cfg["batch_size"], cell.traffic["max_boxes"]
    hw = detection.canvas_hw(cfg)
    real = ref_attack.pgd_update

    def run(rec):
        def recorded(x, *a, **kw):
            rec("pgd_step", x, 1)
            return real(x, *a, **kw)
        stand_ins = _counted_roi_align(rec)
        saved = {n: getattr(ref_roi_align, n) for n in stand_ins}
        ref_attack.pgd_update = recorded
        for n, fn in stand_ins.items():
            setattr(ref_roi_align, n, fn)
        try:
            with torch.device("meta"):
                model = ref_model.FasterRCNN(
                    _frcnn_config(cfg), getattr(torch,
                                                cfg["train"]["precision"]))
            groups = ref_loop.detection_param_groups(model, freeze=True)
            opt = torch.optim.SGD(groups, lr=0.01, momentum=0.9)
            sched = torch.optim.lr_scheduler.LambdaLR(opt, lambda c: 1.0)
            step = ref_loop.make_afan_det_step(model, opt, sched,
                                               afan_config(cfg))
            meta = dict(device="meta")
            step(torch.empty((b,) + hw + (3,), **meta),
                 torch.zeros((b, g, 4), **meta),
                 torch.ones((b, g), dtype=torch.int32, **meta),
                 torch.ones((b, g), dtype=torch.bool, **meta))
        finally:
            ref_attack.pgd_update = real
            for n, fn in saved.items():
                setattr(ref_roi_align, n, fn)

    return work.count(run)


class NmsRecorder:
    """Wraps the port's NMS keep-mask entry to count, per call, the IoU
    tests its boxes needed (from the valid flags and the keep mask)."""

    def __init__(self):
        self.calls: List[Tuple[torch.Tensor, torch.Tensor]] = []

    def wrap(self, fn):
        def recorded(boxes, valid, threshold, plus_one=True):
            keep = fn(boxes, valid, threshold, plus_one)
            self.calls.append((valid, keep))
            return keep
        return recorded

    def least_seconds(self) -> float:
        total = 0.0
        for valid, keep in self.calls:
            g, n = valid.shape
            tests = bounds.nms_iou_tests(keep.cpu(), valid.cpu())
            total += bounds.least_seconds(*bounds.nms_parts(g, n, tests))[0]
        return total


def run(cell: harness.Cell, seed: int, seconds: float, traced: bool,
        clock: harness.Clock, device="cuda") -> Tuple[Dict, List]:
    pool = batches(cell, seed, device)
    got, (step, gen) = readings(program, cell, seed, device, pool)

    def step_at(k):
        return step(_batch(pool, k), gen)

    if device != "cpu":
        torch.cuda.synchronize()
    setup_s = clock.now()
    k = cell.traffic["check_steps"]
    n, window_s, peak = training.measure(step_at, k, seconds, clock, device)
    k += n
    metrics = {"train_imgs_per_s.det": (
                   n * cell.config["batch_size"] / window_s, "images/s"),
               "train_peak_gib": (peak / GIB, "GiB"),
               "setup_s": (setup_s, "s")}

    layer = None
    if traced:
        from afan_torch.ops import nms as port_nms
        first, nms = k + 1, NmsRecorder()

        def traced_steps():
            real = port_nms.nms_sorted_mask
            port_nms.nms_sorted_mask = nms.wrap(real)
            try:
                for i in range(cell.traffic["trace_steps"]):
                    step_at(first + i)
            finally:
                port_nms.nms_sorted_mask = real
            return cell.traffic["trace_steps"]

        tr = trace.traced(traced_steps, lambda: step_at(k))
        k = first + tr.units
        layer = SimpleNamespace(
            trace=tr, window={"steps": n, "seconds": window_s},
            traced_batches=list(range(tr.units)), valid=[],
            config=cell.config, traffic=cell.traffic,
            nms_least_s=nms.least_seconds(),
            precision=cell.config["train"]["precision"])
    last_loss = float(step_at(k))
    del step, gen, step_at
    training.free(device)

    ref, _ = readings(reference, cell, seed, device, pool)
    checks = training.checks(cell, got, ref, last_loss)
    if layer is not None:
        layer.flops_per_step, layer.calls = count_work(cell)
    return {"attempted": n, "failed": 0, "metrics": metrics,
            "peak_bytes": peak, "layer": layer}, checks


def calibration_readings(cell: harness.Cell, seed: int, device,
                         control: bool, faults):
    """(side, numbers) of the program, the control (the frozen copy with
    float8 e4m3 operands) and the fault ``half_batch`` (the copy fed half
    of each batch), each against the frozen copy; ``again``: each side
    twice."""
    pool = batches(cell, seed, device)
    half = tuple(t[:, :cell.config["batch_size"] // 2] for t in pool)
    wanted = [("program", program, {}, pool)]
    if "again" in faults:
        wanted += [("program_again", program, {}, pool),
                   ("reference_again", reference, {}, pool)]
    if control:
        wanted.append(("control", reference, {"fp8": True}, pool))
    if "half_batch" in faults:
        wanted.append(("half_batch", reference, {}, half))

    def read(build, inputs, **kw):
        return readings(build, cell, seed, device, inputs, **kw)[0]

    return training.sides(cell, read, read(reference, pool), wanted, device)
