"""Tests of afan_torch that need a CUDA card: the hand-written kernels
against their plain PyTorch versions. They skip without a card.

This file imports neither jax nor afan, so it also runs where only the port
is installed: ``python -m pytest --noconftest -m cuda
tests/test_torch_cuda.py`` (``--noconftest`` skips tests/conftest.py, which
imports jax).
"""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from afan_torch.ops import nms as tnms
from afan_torch.ops import pgd_step as tpgd
from afan_torch.ops import resize_ce as trce
from afan_torch.ops.kernels import nms as knms
from afan_torch.ops.kernels import pgd_step as kpgd
from afan_torch.ops.kernels import resize_ce as krce
from chip_smoke import NMS_EDGE_CASES, sorted_boxes


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _sorted_boxes(n, seed, clustered=False):
    rng = np.random.RandomState(seed)
    if clustered:
        centers = rng.rand(8, 2) * 300
        xy = centers[rng.randint(0, 8, n)] + rng.randn(n, 2) * 12
        wh = rng.rand(n, 2) * 120 + 60
    else:
        xy = rng.rand(n, 2) * 400
        wh = rng.rand(n, 2) * 80 + 4
    boxes = np.concatenate([xy, xy + wh], 1).astype(np.float32)
    return boxes[np.argsort(-rng.rand(n), kind="stable")]


@pytest.mark.cuda
@pytest.mark.parametrize("n,clustered,plus_one", [
    (6000, False, True), (2600, True, True), (1000, False, False), (1, False,
                                                                     True)])
def test_nms_kernel_matches_plain(card, n, clustered, plus_one):
    b = torch.from_numpy(_sorted_boxes(n, n, clustered)).to(card)[None]
    v = torch.rand(b.shape[:2], generator=torch.Generator().manual_seed(0)
                   ).to(card) < 0.9
    before = knms.launches
    got = knms.nms_sorted_mask(b.contiguous(), v.contiguous(), 0.5, plus_one)
    want = tnms.nms_sorted_mask_plain(b, v, 0.5, plus_one)
    torch.cuda.synchronize()
    assert knms.launches == before + 1
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_nms_kernel_batched(card):
    b = torch.from_numpy(np.stack([_sorted_boxes(300, i, True)
                                   for i in range(80)])).to(card)
    v = torch.ones(b.shape[:2], dtype=torch.bool, device=card)
    got = knms.nms_sorted_mask(b, v, 0.3)
    want = tnms.nms_sorted_mask_plain(b, v, 0.3)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("plus_one", [True, False])
@pytest.mark.parametrize("case", sorted(NMS_EDGE_CASES))
def test_nms_kernel_scan_edges(card, case, plus_one):
    """The per-word scan's edges (ragged last words, chains across words,
    thresholds 0 and 1.01, degenerate boxes, invalid slots in a word)."""
    boxes, valid, thr = NMS_EDGE_CASES[case]()
    b = torch.from_numpy(boxes).to(card)[None]
    v = torch.from_numpy(valid).to(card)[None]
    got = knms.nms_sorted_mask(b, v, thr, plus_one)
    want = tnms.nms_sorted_mask_plain(b, v, thr, plus_one)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("clustered", [False, True])
def test_nms_kernel_training_size(card, clustered):
    """G = 1, N = 12000 at 0.7: the training proposal NMS."""
    b = torch.from_numpy(sorted_boxes(12000, 10, clustered)).to(card)[None]
    v = torch.ones(b.shape[:2], dtype=torch.bool, device=card)
    got = knms.nms_sorted_mask(b, v, 0.7)
    want = tnms.nms_sorted_mask_plain(b, v, 0.7)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_nms_kernel_rejects_non_contiguous(card):
    b = torch.zeros(4, 2, 10, device=card)[..., :4]
    with pytest.raises(ValueError):
        knms.nms_sorted_mask(b, torch.ones(4, 2, dtype=torch.bool,
                                           device=card), 0.5)


def _ce_inputs(card, B, hw, HW, C, seed=0, all_ignored=False):
    rng = np.random.RandomState(seed)
    lo = torch.from_numpy(rng.randn(B, C, *hw).astype(np.float32)).to(card)
    lab = rng.randint(0, C, (B, *HW)).astype(np.int32)
    lab[:, :3, :3] = 255
    if all_ignored:
        lab[-1] = 255
    g = torch.from_numpy(np.linspace(0.5, 1.5, B).astype(np.float32))
    return lo, torch.from_numpy(lab).to(card), g.to(card)


def _rel(got, want):
    return float((got - want).abs().max() / want.abs().max())


# (B, (h, w), (H, W), C, focal, all_ignored): the segmentation step's
# geometries, its B=8 spectrum site, and the band plan's edges
# (tests/test_torch_resize_ce.py:PLAN_CASES); all_ignored gives the last
# entry only 255 labels.
CE_CASES = [
    (2, (192, 192), (768, 768), 19, None, False),
    (2, (192, 192), (768, 768), 19, (1.0, 2.0), False),
    (2, (129, 129), (513, 513), 21, None, False),
    (1, (129, 129), (513, 513), 21, (1.0, 2.0), False),
    (8, (192, 192), (768, 768), 19, None, False),
    (2, (9, 7), (33, 28), 5, None, False),
    (2, (1, 1), (4, 4), 4, None, False),
    (2, (6, 5), (24, 20), 3, (1.0, 2.0), False),
    (2, (128, 128), (512, 512), 19, None, True),
]


# Tolerances as in chip_smoke.py phase 7: max abs error over max abs value,
# 1e-5 for the sums and 1.1e-5 for the gradient (the float order of the
# sums and of the plain version's atomic gradient accumulation differ).
@pytest.mark.cuda
@pytest.mark.parametrize("B,hw,HW,C,focal,all_ignored", CE_CASES)
def test_resize_ce_kernels_match_plain(card, B, hw, HW, C, focal,
                                       all_ignored):
    lo, lab, g = _ce_inputs(card, B, hw, HW, C, all_ignored=all_ignored)
    before = (krce.fwd_launches, krce.bwd_launches)
    sums = krce.resize_ce_forward(lo, lab, focal)
    dlo = krce.resize_ce_backward(lo, lab, g, focal)
    want_s = trce.fused_resize_nll_sums_plain(lo, lab, HW, focal)
    want_d = trce.resize_ce_grad_plain(lo, lab, g, focal)
    torch.cuda.synchronize()
    assert (krce.fwd_launches, krce.bwd_launches) == (before[0] + 1,
                                                      before[1] + 1)
    assert _rel(sums, want_s) <= 1e-5
    assert _rel(dlo, want_d) <= 1.1e-5
    assert torch.equal(sums, krce.resize_ce_forward(lo, lab, focal))
    assert torch.equal(dlo, krce.resize_ce_backward(lo, lab, g, focal))
    if all_ignored:
        assert float(sums[-1]) == 0.0 and not dlo[-1].any()


def _library_sums(lo, lab, focal):
    """The library composition: F.interpolate, then F.cross_entropy with
    ignore_index=255 (and the focal term on its per-pixel loss), summed per
    entry."""
    hi = F.interpolate(lo, size=tuple(lab.shape[1:]), mode="bilinear",
                       align_corners=False)
    ce = F.cross_entropy(hi, lab.long(), reduction="none", ignore_index=255)
    if focal is not None:
        alpha, gamma = focal
        ce = alpha * (1 - torch.exp(-ce)) ** gamma * ce
    return ce.sum(dim=(1, 2))


@pytest.mark.cuda
@pytest.mark.parametrize("B,hw,HW,C,focal,all_ignored", CE_CASES[:4])
def test_resize_ce_kernels_match_library_composition(card, B, hw, HW, C,
                                                     focal, all_ignored):
    lo, lab, g = _ce_inputs(card, B, hw, HW, C, all_ignored=all_ignored)
    x = lo.clone().requires_grad_(True)
    want_s = _library_sums(x, lab, focal)
    (want_d,) = torch.autograd.grad(want_s, x, g)
    sums = krce.resize_ce_forward(lo, lab, focal)
    dlo = krce.resize_ce_backward(lo, lab, g, focal)
    torch.cuda.synchronize()
    assert _rel(sums, want_s.detach()) <= 1e-5
    assert _rel(dlo, want_d) <= 1.1e-5


@pytest.mark.cuda
def test_resize_ce_function_runs_the_kernels(card):
    lo, lab, g = _ce_inputs(card, 2, (16, 16), (64, 64), 5, seed=1)
    x = lo.clone().requires_grad_(True)
    before = (krce.fwd_launches, krce.bwd_launches)
    sums = trce.fused_resize_nll_sums(x, lab.long(), (64, 64))
    (grad,) = torch.autograd.grad(sums, x, g)
    assert (krce.fwd_launches, krce.bwd_launches) == (before[0] + 1,
                                                      before[1] + 1)
    assert torch.equal(grad, krce.resize_ce_backward(lo, lab, g))


@pytest.mark.cuda
def test_resize_ce_kernel_rejects_what_it_does_not_take(card):
    lo, lab, g = _ce_inputs(card, 2, (16, 16), (64, 64), 5)
    with pytest.raises(TypeError):
        krce.resize_ce_forward(lo.double(), lab)
    with pytest.raises(TypeError):
        krce.resize_ce_forward(lo, lab.long())
    with pytest.raises(ValueError):
        krce.resize_ce_forward(lo.transpose(2, 3), lab)
    # a low-res row of 19 classes wider than the block's shared memory
    wide = torch.zeros(1, 19, 1, krce.SMEM_LIMIT // (19 * 4) + 1, device=card)
    with pytest.raises(ValueError, match="shared memory"):
        krce.resize_ce_forward(wide, torch.zeros(1, 4, 4 * wide.shape[3],
                                                 dtype=torch.int32,
                                                 device=card))


def _bits_equal(a, b):
    """Bit-equal, so that NaN compares equal to NaN of the same bits."""
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


def _pgd_inputs(card, n, seed):
    """x, g, c of n floats; g holds zeros, -0, denormals, NaN and infinities
    among normal values."""
    gen = torch.Generator().manual_seed(seed)
    x, g, c = (torch.randn(n, generator=gen) for _ in range(3))
    special = torch.tensor([0.0, -0.0, 1e-40, -1e-40, 1e-45, float("nan"),
                            float("inf"), -float("inf")])
    pos = torch.randperm(n, generator=gen)[:min(n, 64)]
    g[pos] = special[torch.arange(len(pos)) % len(special)]
    return x.to(card), g.to(card), c.to(card)


# The PGD update kernel must equal the plain version bit for bit: both round
# x + f32(gamma) * sign(g) once and clamp to [c - f32(eps), c + f32(eps)].
@pytest.mark.cuda
@pytest.mark.parametrize("shape,clip", [
    ((128,), False), ((4, 33, 7), False), ((2, 16, 16, 16), False),
    ((3, 50), True), ((128, 16, 32, 32), False), ((128, 16, 32, 32), True),
    ((1001,), True), ((3,), False)])
def test_pgd_step_kernel_bit_equal_to_plain(card, shape, clip):
    n = int(np.prod(shape))
    x, g, c = (t.reshape(shape) for t in _pgd_inputs(card, n, n))
    kw = dict(gamma=1.5 / 255, eps=2.0 / 255 if clip else None, clip=clip)
    before = kpgd.launches
    got = kpgd.pgd_update(x, g, c if clip else None, **kw)
    want = tpgd.pgd_update_plain(x, g, c if clip else None, **kw)
    torch.cuda.synchronize()
    assert kpgd.launches == before + 1
    assert _bits_equal(got, want)
    assert _bits_equal(tpgd.pgd_update(x, g, c, **kw), got)


@pytest.mark.cuda
def test_pgd_step_kernel_on_misaligned_views(card):
    x, g, c = _pgd_inputs(card, 4097, 5)
    for view in ((x[1:], g[1:], c[1:]), (x[1:], g[:-1], c[:-1])):
        got = kpgd.pgd_update(*view, gamma=0.01, eps=0.02, clip=True)
        want = tpgd.pgd_update_plain(*view, gamma=0.01, eps=0.02, clip=True)
        torch.cuda.synchronize()
        assert _bits_equal(got, want)


@pytest.mark.cuda
def test_pgd_step_kernel_refuses_what_it_does_not_take(card):
    x = torch.zeros(8, device=card)
    with pytest.raises(TypeError):
        kpgd.pgd_update(x.bfloat16(), x.bfloat16(), gamma=0.1)
    with pytest.raises(ValueError):
        kpgd.pgd_update(x.view(2, 4).t(), x.view(2, 4).t(), gamma=0.1)
    with pytest.raises(ValueError):
        kpgd.pgd_update(x, x[:4], gamma=0.1)
    with pytest.raises(ValueError):
        kpgd.pgd_update(x, x, gamma=0.1, clip=True)


@pytest.mark.cuda
def test_afan_detection_step_kernels_match_plain(card):
    """One tiny A-FAN detection step (ResNet-18, 64x96 canvas, 128 → 32
    proposals) with the NMS and PGD-update kernels and one with their plain
    versions, from the same weights, batch and seeded draws: the proposal
    keep masks identical, losses within 1e-4; 2 NMS and 2 PGD-update
    launches per step."""
    from afan_torch.core import attack
    from afan_torch.data.voc_det import voc_detection_loaders
    from afan_torch.models.frcnn import FasterRCNN, FRCNNConfig
    from afan_torch.train import detect_loop
    from afan_torch.train.optim import sgd

    cfg = FRCNNConfig(backbone="resnet18", num_classes=21,
                      anchor_sizes=(32, 64), train_pre_nms_top_n=128,
                      train_post_nms_top_n=32, roi_samples=8, roi_fg_cap=2,
                      rpn_samples=16, rpn_fg_cap=8)
    model = FasterRCNN(cfg)
    model.reset_parameters(torch.Generator().manual_seed(0))
    model.to(card)
    batch = next(iter(voc_detection_loaders(None, 2, 64, 96)[0]))
    args = [torch.from_numpy(a).to(card) for a in
            (batch.images, batch.boxes, batch.labels.astype(np.int64),
             batch.valid)]
    state = {k: v.clone() for k, v in model.state_dict().items()}
    runs = []
    saved = (tnms.nms_sorted_mask, attack.pgd_update)
    try:
        for nms_fn, update in ((knms.nms_sorted_mask, tpgd.pgd_update),
                               (tnms.nms_sorted_mask_plain,
                                tpgd.pgd_update_plain)):
            model.load_state_dict(state)
            opt, sched = sgd(detect_loop.detection_param_groups(model),
                             lambda c: 0.01, 0.01, 0.9, 5e-4)
            step = detect_loop.make_afan_det_step(
                model, opt, sched, detect_loop.DetAfanConfig(
                    spectrum=3, mix_mask=(0, 1, 0), mix_sd=True))
            keeps = []

            def nms(*a, fn=nms_fn):
                keeps.append(fn(*a))
                return keeps[-1]
            tnms.nms_sorted_mask, attack.pgd_update = nms, update
            before = (knms.launches, kpgd.launches)
            out = step(*args, torch.Generator(card).manual_seed(0))
            launched = (knms.launches - before[0], kpgd.launches - before[1])
            runs.append(({k: float(v) for k, v in out.items()}, keeps,
                         launched))
    finally:
        tnms.nms_sorted_mask, attack.pgd_update = saved
    (lk, kk, nk), (lp, kp, np_) = runs
    assert nk == (2, 2) and np_ == (0, 0)
    assert len(kk) == len(kp) == 2
    assert all(torch.equal(a, b) for a, b in zip(kk, kp))
    for k in lk:
        assert abs(lk[k] - lp[k]) <= 1e-4 * max(abs(lp[k]), 1e-6), k
