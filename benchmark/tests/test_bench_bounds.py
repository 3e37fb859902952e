"""The benchmark's bound arithmetic equals ``chip_smoke.py``'s, and gives
the bounds ``PERF.md`` §6 lists at the main paths' shapes."""
from __future__ import annotations

import pytest
import torch

from benchmark.lib import bounds

chip_smoke = pytest.importorskip("chip_smoke")


def test_constants_are_chip_smokes():
    for name in ("HBM_BYTES_PER_S", "F32_OPS_PER_S", "OPS_PER_IOU",
                 "CE_LERP_OPS", "CE_LSE_OPS", "CE_SOFTMAX_GRAD_OPS",
                 "CE_PIXEL_OPS", "PGD_OPS", "PGD_CLIP_OPS"):
        assert getattr(bounds, name) == getattr(chip_smoke, name), name


@pytest.mark.parametrize("seed,g,n,thr", [(0, 8, 2000, 0.7),
                                          (1, 1, 6000, 0.7),
                                          (2, 20, 300, 0.3)])
def test_nms_bound_equals_chip_smokes(seed, g, n, thr):
    gen = torch.Generator().manual_seed(seed)
    xy = torch.rand((g, n, 2), generator=gen) * 500
    wh = torch.rand((g, n, 2), generator=gen) * 80 + 4
    boxes = torch.cat([xy, xy + wh], dim=2)
    valid = torch.rand((g, n), generator=gen) < 0.9
    from afan_torch.ops.nms import nms_sorted_mask_plain
    keep = nms_sorted_mask_plain(boxes, valid, thr)
    want = chip_smoke.nms_bound_parts(boxes, valid, keep)
    nbytes, ops = bounds.nms_parts(g, n, bounds.nms_iou_tests(keep, valid))
    assert nbytes / bounds.HBM_BYTES_PER_S * 1e3 == pytest.approx(want[0])
    assert ops / bounds.F32_OPS_PER_S * 1e3 == pytest.approx(want[1])


def test_resize_ce_bounds_of_perf_table():
    """The f32 A-FAN Cityscapes step (4 sites at B=4, 1 at B=8, 192 →
    768, 19 classes, every pixel valid): forward 0.03697 ms (bytes),
    backward 0.05884 ms (operations), PERF.md §6."""
    fwd = bwd = 0.0
    for b, count in ((4, 4), (8, 1)):
        parts = bounds.resize_ce_parts(b, 19, 192, 192, 768, 768,
                                       b * 768 * 768, 4)
        t_f, by_f = bounds.least_seconds(*parts["fwd"])
        t_b, by_b = bounds.least_seconds(*parts["bwd"])
        assert (by_f, by_b) == ("bytes", "operations")
        fwd, bwd = fwd + count * t_f, bwd + count * t_b
    assert fwd * 1e3 == pytest.approx(0.03697, abs=5e-5)
    assert bwd * 1e3 == pytest.approx(0.05884, abs=5e-5)


def test_pgd_bound_of_perf_table():
    """The bf16 seg A-FAN step's two updates: SD (4, 304, 192, 192) and SE
    (4, 512, 96, 96), 0.11409 ms per step (bytes), PERF.md §6."""
    total = sum(bounds.least_seconds(*bounds.pgd_parts(n, 2, False))[0]
                for n in (4 * 304 * 192 * 192, 4 * 512 * 96 * 96))
    assert total * 1e3 == pytest.approx(0.11409, abs=5e-5)
