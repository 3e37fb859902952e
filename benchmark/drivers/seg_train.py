"""Back-to-back segmentation training steps: the step function of
``afan_torch/train/segment_loop.py`` as ``train_segment`` builds it from
the configuration's recipe flags and the traffic file's ``--variant``, fed
batches made on the device from the seed, cycling through a pool.

Set-up builds the model, its optimizer and the step once, loads the seeded
weights and drives the first ``check_steps`` steps (on batches that all
differ) through the same call and feed as the window; those steps warm up
every shape. The window runs steps until ``--seconds`` have passed on the
host clock, then waits for the device. After it (and after the traced
steps of ``--trace 1``) the program's state is freed and the plain
reference (``benchmark/reference/seg_step.py``) follows the first steps
from the same weights on the same batches; :mod:`benchmark.lib.compare`
decides ``correct``.
"""
from __future__ import annotations

from types import SimpleNamespace
from typing import Dict, List, Tuple

import torch

from benchmark.lib import (compare, harness, trace, traffic, training,
                           weights, work)
from benchmark.reference import seg_model, seg_step

GIB = 2 ** 30


def program(cell: harness.Cell, state0: Dict, device):
    """The port's model, optimizer and step for the cell."""
    from afan_torch.cli import train_segment
    from afan_torch.models.deeplab import build_model
    from afan_torch.models.deeplab.modeling import segmentation_param_groups
    from afan_torch.train.optim import sgd
    cfg = cell.config
    flags = list(cfg["recipe_flags"]) + ["--variant", cell.traffic["variant"]]
    if cfg["precision"] == "bfloat16":
        flags.append("--bf16")
    args = train_segment.get_parser().parse_args(flags)
    with torch.device(device):
        model = build_model(args.model, cfg["num_classes"],
                            args.output_stride,
                            torch.bfloat16 if args.bf16 else torch.float32)
    model.load_state_dict(state0)
    opt, sched = sgd(segmentation_param_groups(model),
                     train_segment.lr_schedule(args), args.lr, 0.9,
                     args.weight_decay)
    step = train_segment.build_step(args, model, opt, sched)
    return model, opt, lambda img, lab: step(img, lab)["loss"]


def reference(cell: harness.Cell, state0: Dict, device, fp8: bool = False,
              record=None, fixed_order: bool = True):
    """The plain reference's model, optimizer and step for the cell (in
    the configuration's precision; ``fp8``: its convolutions through float8
    e4m3, the control; ``fixed_order`` off: its upsample's backward summed
    by the library's atomic adds, a perturbation of rounding size)."""
    cfg = cell.config
    with torch.device(device):
        model = seg_model.DeepLabV3Plus(cfg["num_classes"])
    model.set_precision(getattr(torch, cfg["precision"]), fp8)
    model.load_state_dict(state0)
    step = seg_step.make_step(model, cell.traffic["variant"], cfg["afan"],
                              cfg["optimizer"], record, fixed_order)
    return model, step.optimizer, step


def shapes(cell: harness.Cell):
    with torch.device("meta"):
        return weights.state_shapes(
            seg_model.DeepLabV3Plus(cell.config["num_classes"]))


def batches(cell: harness.Cell, seed: int, device):
    cfg = cell.config
    return traffic.seg_batches(seed, cell.traffic, cfg["batch_size"],
                               cfg["crop_size"], cfg["num_classes"], device)


def readings(build, cell: harness.Cell, seed: int, device, images, labels,
             **kw) -> Tuple[compare.Readings, object]:
    """Build a side with ``build`` from the seeded weights and read its
    first ``check_steps`` steps; returns the readings and the side's step
    (which the window continues)."""
    state0 = weights.seeded_state(shapes(cell), seed, device)
    model, opt, step = build(cell, state0, device, **kw)
    params = dict(model.named_parameters())
    torch.manual_seed(seed % 2 ** 63)          # the dropout masks
    got = compare.first_steps(
        lambda k: step(images[k], labels[k]), params, opt, state0,
        cell.config["optimizer"]["weight_decay"],
        cell.traffic["check_steps"])
    return got, step


def count_work(cell: harness.Cell):
    """(FLOPs, kernel calls) of one step, by the reference on meta."""
    cfg = cell.config
    b, s = cfg["batch_size"], cfg["crop_size"]

    def run(rec):
        with torch.device("meta"):
            model = seg_model.DeepLabV3Plus(cfg["num_classes"])
        model.set_precision(getattr(torch, cfg["precision"]))
        step = seg_step.make_step(model, cell.traffic["variant"],
                                  cfg["afan"], cfg["optimizer"], rec)
        step(torch.empty((b, s, s, 3), device="meta"),
             torch.empty((b, s, s), dtype=torch.int32, device="meta"))

    return work.count(run)


def run(cell: harness.Cell, seed: int, seconds: float, traced: bool,
        clock: harness.Clock, device="cuda") -> Tuple[Dict, List]:
    images, labels = batches(cell, seed, device)
    pool = images.shape[0]
    got, step = readings(program, cell, seed, device, images, labels)

    def step_at(k):
        return step(images[k % pool], labels[k % pool])

    if device != "cpu":
        torch.cuda.synchronize()
    setup_s = clock.now()
    k = cell.traffic["check_steps"]
    n, window_s, peak = training.measure(step_at, k, seconds, clock, device)
    k += n
    metrics = {"train_imgs_per_s": (n * cell.config["batch_size"] / window_s,
                                    "images/s"),
               "train_peak_gib": (peak / GIB, "GiB"),
               "setup_s": (setup_s, "s")}

    layer = None
    if traced:
        first = k + 1       # step k runs while the profiler warms up

        def traced_steps():
            for i in range(cell.traffic["trace_steps"]):
                step_at(first + i)
            return cell.traffic["trace_steps"]

        tr = trace.traced(traced_steps, lambda: step_at(k))
        k = first + tr.units
        valid = (labels != traffic.IGNORE).flatten(1).sum(1).tolist()
        layer = SimpleNamespace(
            trace=tr, window={"steps": n, "seconds": window_s},
            traced_batches=[(first + i) % pool for i in range(tr.units)],
            valid=valid, config=cell.config, traffic=cell.traffic,
            precision=cell.config["precision"])
    last_loss = float(step_at(k))
    del step, step_at
    training.free(device)

    ref, _ = readings(reference, cell, seed, device, images, labels)
    checks = training.checks(cell, got, ref, last_loss)
    if layer is not None:
        layer.flops_per_step, layer.calls = count_work(cell)
    return {"attempted": n, "failed": 0, "metrics": metrics,
            "peak_bytes": peak, "layer": layer}, checks


def calibration_readings(cell: harness.Cell, seed: int, device,
                         control: bool, faults):
    """(side, numbers) of the program, the control (the reference with its
    convolutions through float8 e4m3, the precision below bfloat16) and
    the fault ``half_batch`` (the reference fed half of each batch, the
    mean taken over the rest), each against the reference; ``again``: each
    side twice; ``reorder``: the reference with its upsample's backward
    summed in the library's order, the witness of how far rounding alone
    carries the later steps. A state left unchanged reads 1 by the
    worst-leaf measure and needs no run."""
    images, labels = batches(cell, seed, device)
    half = cell.config["batch_size"] // 2
    whole, halved = (images, labels), (images[:, :half], labels[:, :half])
    wanted = [("program", program, {}, whole)]
    if "again" in faults:
        wanted += [("program_again", program, {}, whole),
                   ("reference_again", reference, {}, whole)]
    if control:
        wanted.append(("control", reference, {"fp8": True}, whole))
    if "half_batch" in faults:
        wanted.append(("half_batch", reference, {}, halved))
    if "reorder" in faults:
        wanted.append(("reorder", reference, {"fixed_order": False}, whole))

    def read(build, inputs, **kw):
        return readings(build, cell, seed, device, *inputs, **kw)[0]

    return training.sides(cell, read, read(reference, whole), wanted, device)
