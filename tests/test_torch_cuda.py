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
from chip_smoke import NMS_EDGE_CASES, NMS_NAN_CASES, sorted_boxes


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
        kpgd.pgd_update(x.half(), x.half(), gamma=0.1)
    with pytest.raises(TypeError):
        kpgd.pgd_update(x.bfloat16(), x, gamma=0.1)
    with pytest.raises(ValueError):
        kpgd.pgd_update(x.view(2, 4).t(), x.view(2, 4).t(), gamma=0.1)
    with pytest.raises(ValueError):
        kpgd.pgd_update(x, x[:4], gamma=0.1)
    with pytest.raises(ValueError):
        kpgd.pgd_update(x, x, gamma=0.1, clip=True)


@pytest.mark.cuda
@pytest.mark.parametrize("n,clip", [(4 * 512 * 9 * 9, False), (1001, True),
                                    (7, True), (4097, False)])
def test_pgd_step_kernel_bf16_bit_equal_to_plain(card, n, clip):
    """The bf16 path (8 elements per 16-byte load, a scalar tail, the
    scalar loop on misaligned views) against the plain bf16 ops, with a
    step below half a bf16 ulp of most entries."""
    gen = torch.Generator(device=card).manual_seed(n)
    x, g, c = (torch.randn(n + 1, generator=gen, device=card).bfloat16()
               for _ in range(3))
    for view in ((x[:n], g[:n], c[:n]), (x[1:], g[1:], c[1:])):
        kw = dict(gamma=0.02 / 255, eps=2.0 / 255 if clip else None,
                  clip=clip)
        got = kpgd.pgd_update(view[0], view[1], view[2] if clip else None,
                              **kw)
        want = tpgd.pgd_update_plain(view[0], view[1],
                                     view[2] if clip else None, **kw)
        torch.cuda.synchronize()
        assert got.dtype == torch.bfloat16
        assert torch.equal(got.view(torch.int16), want.view(torch.int16))


@pytest.mark.cuda
@pytest.mark.parametrize("B,hw,HW,C,focal,all_ignored", CE_CASES[:4])
def test_resize_ce_kernels_on_bf16_logits(card, B, hw, HW, C, focal,
                                          all_ignored):
    """bf16 logits: the sums equal the f32 kernel's on the widened logits,
    and the gradient is the f32 kernel's rounded to bf16, bit for bit."""
    lo, lab, g = _ce_inputs(card, B, hw, HW, C, all_ignored=all_ignored)
    lo16 = lo.bfloat16()
    sums = krce.resize_ce_forward(lo16, lab, focal)
    dlo = krce.resize_ce_backward(lo16, lab, g, focal)
    want_s = krce.resize_ce_forward(lo16.float(), lab, focal)
    want_d = krce.resize_ce_backward(lo16.float(), lab, g, focal)
    torch.cuda.synchronize()
    assert sums.dtype == torch.float32 and dlo.dtype == torch.bfloat16
    assert torch.equal(sums, want_s)
    assert torch.equal(dlo, want_d.bfloat16())


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


# (shape, gamma): the bf16 ascents of the detection recipes (SE at tap 2 of a
# 608x1008 batch of 8, SD on 8 x 128 pooled ROI vectors, gammas 0.05-0.2/255)
# and of ALFA (tap 13) and learnable-eta (its taps' three shapes) at batch 128
BF16_PGD_SHAPES = [((8, 512, 76, 126), 1.0 / 255), ((1024, 2048), 0.05 / 255),
                   ((1024, 2048), 0.2 / 255), ((128, 16, 32, 32), 1.5 / 255),
                   ((128, 32, 16, 16), 1.0 / 255), ((128, 64, 8, 8), 1.0 / 255)]


@pytest.mark.cuda
@pytest.mark.parametrize("clip", [False, True], ids=["step", "clip"])
@pytest.mark.parametrize("shape,gamma", BF16_PGD_SHAPES)
def test_pgd_step_kernel_bf16_at_the_recipes_shapes(card, shape, gamma, clip):
    gen = torch.Generator(device=card).manual_seed(len(shape))
    x, g, c = (torch.randn(shape, generator=gen, device=card).bfloat16()
               for _ in range(3))
    kw = dict(gamma=gamma, eps=2.0 / 255 if clip else None, clip=clip)
    got = kpgd.pgd_update(x, g, c if clip else None, **kw)
    want = tpgd.pgd_update_plain(x, g, c if clip else None, **kw)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))


@pytest.mark.cuda
def test_bf16_afan_detection_step_on_the_card(card):
    """One tiny A-FAN detection step (ResNet-18, 64x96 canvas) with the
    model in bf16: finite losses, float32 parameters, 2 proposal NMS
    launches on float32 boxes and 2 bf16 PGD-update launches."""
    from afan_torch.data.voc_det import voc_detection_loaders
    from afan_torch.models.frcnn import FasterRCNN, FRCNNConfig
    from afan_torch.train import detect_loop
    from afan_torch.train.optim import sgd

    cfg = FRCNNConfig(backbone="resnet18", num_classes=21,
                      anchor_sizes=(32, 64), train_pre_nms_top_n=128,
                      train_post_nms_top_n=32, roi_samples=8, roi_fg_cap=2,
                      rpn_samples=16, rpn_fg_cap=8)
    model = FasterRCNN(cfg, torch.bfloat16)
    model.reset_parameters(torch.Generator().manual_seed(0))
    model.to(card)
    batch = next(iter(voc_detection_loaders(None, 2, 64, 96)[0]))
    args = [torch.from_numpy(a).to(card) for a in
            (batch.images, batch.boxes, batch.labels.astype(np.int64),
             batch.valid)]
    opt, sched = sgd(detect_loop.detection_param_groups(model),
                     lambda c: 0.01, 0.01, 0.9, 5e-4)
    step = detect_loop.make_afan_det_step(
        model, opt, sched, detect_loop.DetAfanConfig(
            spectrum=3, mix_mask=(0, 1, 0), mix_sd=True))
    boxes = []
    saved = tnms.nms_sorted_mask

    def nms(b, *a):
        boxes.append(b.dtype)
        return saved(b, *a)
    before = (knms.launches, kpgd.bf16_launches)
    try:
        tnms.nms_sorted_mask = nms
        out = step(*args, torch.Generator(card).manual_seed(0))
    finally:
        tnms.nms_sorted_mask = saved
    torch.cuda.synchronize()
    assert (knms.launches - before[0], kpgd.bf16_launches - before[1]) == (
        2, 2)
    assert boxes == [torch.float32] * 2
    assert all(np.isfinite(float(v)) for v in out.values())
    assert {p.dtype for p in model.parameters()} == {torch.float32}


@pytest.fixture
def deterministic():
    """cuDNN deterministic and no TF32, restored after the test."""
    flags = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark, torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark,
     torch.backends.cudnn.allow_tf32,
     torch.backends.cuda.matmul.allow_tf32) = flags


def _tiny_split(card, n=64):
    rng = np.random.RandomState(0)
    y = rng.randint(0, 4, n)
    x = np.clip(rng.rand(n, 32, 32, 3) * 0.1 + y[:, None, None, None] * 0.25,
                0, 1)
    return (torch.from_numpy((x * 255).astype(np.uint8)).to(card),
            torch.from_numpy(y).to(card))


@pytest.mark.cuda
def test_alfa_epoch_scan_graph_matches_eager(card, deterministic):
    """A tiny ALFA epoch scan (ResNet-s (1, 1, 1), 4 classes, batch 16, 5
    PGD steps): three eager steps, then a captured graph replayed for the
    other five steps of two epochs, against eight eager device-data steps
    from the same weights, permutations and generator seed. The draws and
    metrics are bit-equal, the parameters within 1e-5 of each tensor's
    largest value; the wrapper counts 5 PGD-update launches for each eager
    step and 5 for the capture and none at a replay, and a profiler trace of
    the second epoch's four replays holds 20 PGD-update kernels."""
    from torch.profiler import ProfilerActivity, profile

    from afan_torch.models.resnet_s import ResNetS
    from afan_torch.train import loop, optim

    data_x, data_y = _tiny_split(card)
    cfg = loop.AlfaConfig(tap=5, steps=5)
    sched = optim.multistep_warmup_schedule_tensor(0.1, [6], 0.1, 3)
    runs = []
    for graphed in (True, False):
        model = ResNetS((1, 1, 1), 4,
                        generator=torch.Generator().manual_seed(0)).to(card)
        opt, count = optim.capturable_sgd(list(model.parameters()), sched,
                                          0.1, 0.9, 5e-4)
        gen = torch.Generator(card).manual_seed(7)
        if graphed:
            scan = loop.make_epoch_scan_alfa(model, opt, cfg, 16, 4,
                                             record_augment=True)
            before = kpgd.launches
            ms = [scan(data_x, data_y, torch.randperm(64, generator=gen,
                                                      device=card), gen)]
            wrapper = kpgd.launches - before
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                ms.append(scan(data_x, data_y,
                               torch.randperm(64, generator=gen,
                                              device=card), gen))
                torch.cuda.synchronize()
            at_replays = kpgd.launches - before - wrapper
            traced = sum(e.count for e in prof.key_averages()
                         if "pgd_step" in e.key)
        else:
            step = loop.make_device_data_alfa_step(model, opt, count, cfg, 16,
                                                   record_augment=True)
            ms = []
            for _ in range(2):
                perm = torch.randperm(64, generator=gen, device=card)
                out = [step(data_x, data_y, perm, i, gen) for i in range(4)]
                ms.append({k: torch.stack([o[k] for o in out])
                           for k in out[0]})
        torch.cuda.synchronize()
        runs.append((ms, {k: v.detach().clone()
                          for k, v in model.state_dict().items()},
                     int(opt.count)))
    (mg, sg, cg), (me, se, ce) = runs
    assert loop.GRAPH_WARMUP_STEPS == 3
    assert scan.eager_steps == 3 and scan.replays == 5
    assert wrapper == 5 * (3 + 1) and at_replays == 0
    assert traced == 5 * 4
    assert cg == ce == 8
    for a, b in zip(mg, me):
        for k in a:
            assert torch.equal(a[k], b[k]), k
        assert not torch.equal(a["crop"][1], a["crop"][2])
    for k, v in se.items():
        if v.is_floating_point():
            err = float((sg[k] - v).abs().max())
            assert err <= 1e-5 * max(float(v.abs().max()), 1e-30), (k, err)
        else:
            assert torch.equal(sg[k], v), k


@pytest.mark.cuda
def test_robust_eval_kernel_matches_plain(card, deterministic):
    """A tiny robust-eval batch (batch 8, 32x32, PGD-3 from a seeded random
    start) with the PGD-update kernel and with the plain update: the
    adversarial images bit-equal, the same correct count, 3 launches."""
    from afan_torch.core import attack
    from afan_torch.eval import robustness
    from afan_torch.models.resnet_s import ResNetS

    model = ResNetS((1, 1, 1), 4,
                    generator=torch.Generator().manual_seed(0)).to(card)
    data_x, data_y = _tiny_split(card, 8)
    x = data_x.float() / 255
    runs = []
    saved = (attack.pgd_update, robustness.pgd)
    try:
        for update in (tpgd.pgd_update, tpgd.pgd_update_plain):
            advs = []

            def recording(*a, **kw):
                advs.append(saved[1](*a, **kw))
                return advs[-1]
            attack.pgd_update, robustness.pgd = update, recording
            step = robustness.make_robust_eval_step(
                model, 4, generator=torch.Generator(card).manual_seed(1))
            before = kpgd.launches
            out = step(x, data_y)
            torch.cuda.synchronize()
            runs.append((advs[0], int(out["correct"]),
                         kpgd.launches - before))
    finally:
        attack.pgd_update, robustness.pgd = saved
    (ak, ck, lk), (ap, cp, lp) = runs
    assert (lk, lp) == (3, 0)
    assert _bits_equal(ak, ap) and ck == cp


# The evaluation paths' shapes: the PGD update on the VOC detection canvas,
# at the SE tap feature (layer 2, stride 8) and on the VOC segmentation crop,
# at batch 1, with eval_detect's and eval_segment's gamma and eps.
EVAL_PGD_SHAPES = [(1, 608, 1008, 3), (1, 512, 76, 126), (1, 513, 513, 3)]


@pytest.mark.cuda
@pytest.mark.parametrize("clip", [False, True], ids=["step", "clip"])
@pytest.mark.parametrize("shape", EVAL_PGD_SHAPES)
def test_pgd_step_kernel_at_the_eval_shapes(card, shape, clip):
    n = int(np.prod(shape))
    x, g, c = (t.reshape(shape) for t in _pgd_inputs(card, n, len(shape)))
    kw = dict(gamma=2.0 / 255, eps=8.0 / 255 if clip else None, clip=clip)
    got = kpgd.pgd_update(x, g, c if clip else None, **kw)
    want = tpgd.pgd_update_plain(x, g, c if clip else None, **kw)
    torch.cuda.synchronize()
    assert _bits_equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(NMS_NAN_CASES))
def test_nms_kernel_on_nan_boxes(card, name):
    """A NaN image sends NaN boxes into the proposal NMS: the kernel keeps
    what the plain version keeps (a pair with a NaN coordinate never
    suppresses), and returns."""
    boxes, valid, thr = NMS_NAN_CASES[name]()
    b = torch.from_numpy(boxes).to(card)[None]
    v = torch.from_numpy(valid).to(card)[None]
    got = knms.nms_sorted_mask(b, v, thr)
    want = tnms.nms_sorted_mask_plain(b, v, thr)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


# This slice's shapes: the MobileNetV2 SE tap (tap 2, stride 8) at the
# Cityscapes (crop 768) and VOC (crop 513) recipes' batch of 4, f32 and bf16;
# COCO's bf16 SE tap at 800x1344 and the RPN trunk feature at COCO's and
# VOC's canvases (stride 16), batch 8.
SLICE_PGD_SHAPES = [((4, 32, 96, 96), torch.float32),
                    ((4, 32, 96, 96), torch.bfloat16),
                    ((4, 32, 65, 65), torch.bfloat16),
                    ((8, 512, 100, 168), torch.bfloat16),
                    ((8, 512, 50, 84), torch.bfloat16),
                    ((8, 512, 38, 63), torch.float32),
                    ((8, 512, 38, 63), torch.bfloat16)]


@pytest.mark.cuda
@pytest.mark.parametrize("clip", [False, True], ids=["step", "clip"])
@pytest.mark.parametrize("shape,dtype", SLICE_PGD_SHAPES)
def test_pgd_step_kernel_at_the_mobilenet_and_coco_shapes(card, shape, dtype,
                                                          clip):
    n = int(np.prod(shape))
    x, g, c = (t.reshape(shape).to(dtype)
               for t in _pgd_inputs(card, n, len(shape) + n % 7))
    kw = dict(gamma=0.1 / 255, eps=2.0 / 255 if clip else None, clip=clip)
    got = kpgd.pgd_update(x, g, c if clip else None, **kw)
    want = tpgd.pgd_update_plain(x, g, c if clip else None, **kw)
    torch.cuda.synchronize()
    bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
    assert got.dtype == dtype
    assert torch.equal(got.view(bits), want.view(bits))


@pytest.mark.cuda
@pytest.mark.parametrize("groups,n,thr", [(91, 300, 0.3), (8, 12000, 0.7)],
                         ids=["coco_per_class", "coco_proposals"])
def test_nms_kernel_at_the_coco_shapes(card, groups, n, thr):
    """COCO's eval per-class NMS (91 classes x 300 detections) and its
    training proposal NMS (12000 of 50400 anchors per image, batch 8)."""
    b = torch.from_numpy(np.stack([_sorted_boxes(n, 100 + i, i % 2 == 0)
                                   for i in range(groups)])).to(card)
    v = torch.rand(b.shape[:2], generator=torch.Generator().manual_seed(1)
                   ).to(card) < 0.95
    got = knms.nms_sorted_mask(b, v, thr)
    want = tnms.nms_sorted_mask_plain(b, v, thr)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
