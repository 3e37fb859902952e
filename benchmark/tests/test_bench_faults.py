"""``correct`` comes out false when the timed path is broken underneath
(the look for a card skipped, the rest of a run driven at a size the CPU
holds): a step that leaves the state unchanged, and a step that leaves out
half of each batch and takes the mean over the rest. And the control, the
reference with its convolutions through float8, fails the cell's
limits."""
from __future__ import annotations

import pytest
import torch

from benchmark.lib import compare, harness
from benchmark.tests.cells import tiny_det_train_cell, tiny_seg_cell

VARIANTS = ("afan", "baseline")


@pytest.fixture(autouse=True)
def few_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def _broken_run(variant, monkeypatch, fault):
    from afan_torch.cli import train_segment
    real = train_segment.build_step

    def build_step(args, model, optimizer, scheduler):
        step = real(args, model, optimizer, scheduler)
        if fault == "unchanged":
            def still(images, labels):
                saved = [p.detach().clone() for p in model.parameters()]
                out = step(images, labels)
                with torch.no_grad():
                    for p, s in zip(model.parameters(), saved):
                        p.copy_(s)
                return out
            return still
        half = lambda t: t[: t.shape[0] // 2]     # noqa: E731
        return lambda images, labels: step(half(images), half(labels))

    monkeypatch.setattr(train_segment, "build_step", build_step)
    cell = tiny_seg_cell(variant=variant)
    _, checks = cell.driver().run(cell, 99, 0.2, False, harness.Clock(),
                                  device="cpu")
    return checks


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("fault", ["unchanged", "half_batch"])
def test_broken_step_is_not_correct(variant, fault, monkeypatch):
    checks = _broken_run(variant, monkeypatch, fault)
    assert not harness.passes(checks), checks


@pytest.mark.parametrize("variant", VARIANTS)
def test_control_fails_the_limits(variant):
    cell = tiny_seg_cell(variant=variant)
    drv = cell.driver()
    images, labels = drv.batches(cell, 5, "cpu")
    ref, _ = drv.readings(drv.reference, cell, 5, "cpu", images, labels)
    got, _ = drv.readings(drv.reference, cell, 5, "cpu", images, labels,
                          fp8=True)
    numbers = compare.gaps(got, ref, cell.traffic["compare"])
    limits = cell.traffic["limits"]
    assert any(numbers[k] > limits[k] for k in limits), numbers


@pytest.mark.parametrize("fault", ["unchanged", "half_batch"])
def test_broken_det_step_is_not_correct(fault, monkeypatch):
    """The detection step broken underneath: its parameters restored after
    every step, or half of each batch left out."""
    from afan_torch.train import detect_loop
    real = detect_loop.make_afan_det_step

    def make_afan_det_step(model, optimizer, scheduler, cfg):
        step = real(model, optimizer, scheduler, cfg)

        def broken(images, boxes, classes, valid, generator=None):
            if fault == "half_batch":
                n = images.shape[0] // 2
                return step(images[:n], boxes[:n], classes[:n], valid[:n],
                            generator)
            saved = [p.detach().clone() for p in model.parameters()]
            out = step(images, boxes, classes, valid, generator)
            with torch.no_grad():
                for p, s in zip(model.parameters(), saved):
                    p.copy_(s)
            return out
        return broken

    monkeypatch.setattr(detect_loop, "make_afan_det_step",
                        make_afan_det_step)
    cell = tiny_det_train_cell()
    _, checks = cell.driver().run(cell, 23, 0.1, False, harness.Clock(),
                                  device="cpu")
    assert not harness.passes(checks), checks


def test_det_control_fails_the_limits():
    cell = tiny_det_train_cell()
    got = dict(cell.driver().calibration_readings(cell, 7, "cpu", True, ()))
    limits = cell.traffic["limits"]
    assert all(got["program"][k] <= lim for k, lim in limits.items())
    assert any(got["control"][k] > lim for k, lim in limits.items()), got
