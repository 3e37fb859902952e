"""The plain reference against the port's plain paths (the CPU's), at a
size the CPU holds: the training cells' whole run, the program's first
steps against the reference's, and the work the reference counts."""
from __future__ import annotations

import pytest
import torch

from benchmark.lib import harness
from benchmark.tests.cells import tiny_det_train_cell, tiny_seg_cell


@pytest.fixture(autouse=True)
def few_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


@pytest.mark.parametrize("precision,variant", [
    ("float32", None), (None, None), (None, "baseline")])
def test_seg_run_agrees_with_reference(precision, variant):
    cell = tiny_seg_cell(precision=precision, variant=variant)
    out, checks = cell.driver().run(cell, 2 ** 33 + 7, 0.5, False,
                                    harness.Clock(), device="cpu")
    assert out["attempted"] >= 1
    for check, value, limit in checks:
        assert value <= 1e-6, (check, value)
    assert harness.passes(checks)


@pytest.mark.parametrize("variant", ["afan", "baseline"])
def test_seg_three_steps_agree_on_the_cpu(variant):
    """All three checked steps, not only the first that the cell compares:
    on the port's plain paths the state a step carries into the next (the
    momentum buffers, the poly schedule, the param groups) is the
    reference's, to float32 rounding."""
    from benchmark.lib import compare
    cell = tiny_seg_cell(precision="float32", variant=variant)
    drv = cell.driver()
    images, labels = drv.batches(cell, 2 ** 32 + 1, "cpu")
    got, _ = drv.readings(drv.program, cell, 2 ** 32 + 1, "cpu", images,
                          labels)
    ref, _ = drv.readings(drv.reference, cell, 2 ** 32 + 1, "cpu", images,
                          labels)
    gaps = compare.gaps(got, ref, "all_steps")
    assert max(gaps.values()) <= 1e-5, gaps


def test_seg_work_count():
    """12.1 TFLOP and 5 upsample + CE and 2 PGD calls per A-FAN step at the
    cell's shapes; 3.2 TFLOP and 1 site per baseline step."""
    afan = harness.load_cell("seg-city-afan-bf16")
    flops, calls = afan.driver().count_work(afan)
    assert flops == pytest.approx(12.111e12, rel=1e-3)
    ops = [c.op for c in calls]
    assert ops.count("resize_ce") == 5 and ops.count("pgd_step") == 2
    assert sorted(c.shape for c in calls if c.op == "pgd_step") == [
        (4, 304, 192, 192), (4, 512, 96, 96)]
    base = harness.load_cell("seg-city-afan-bf16")
    base.traffic = dict(base.traffic, variant="baseline")
    flops, calls = base.driver().count_work(base)
    assert flops == pytest.approx(3.2137e12, rel=1e-3)
    assert [c.op for c in calls] == ["resize_ce"]


def test_det_train_run_agrees_with_reference():
    """The A-FAN detection step on the port's plain paths against the
    frozen copy: the checked step equal, and the window ran."""
    cell = tiny_det_train_cell()
    out, checks = cell.driver().run(cell, 2 ** 33 + 9, 0.1, False,
                                    harness.Clock(), device="cpu")
    assert out["attempted"] >= 1
    assert dict((n, v) for n, v, _ in checks) == {
        "loss_gap": 0.0, "grad_gap": 0.0, "change_gap": 0.0}


def test_det_train_work_count():
    """The A-FAN detection step's FLOPs (20.06 TFLOP, ROIAlign by its
    bilinear taps) and its two PGD updates (SE at layer 2, SD on the pooled
    ROIs) at the cell's shapes."""
    cell = harness.load_cell("det-voc-afan-bf16")
    flops, calls = cell.driver().count_work(cell)
    assert flops == pytest.approx(20.0558e12, rel=1e-3)
    assert [c.op for c in calls] == ["pgd_step", "pgd_step"]
