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

from afan_torch.ops import nms as tnms
from afan_torch.ops import pgd_step as tpgd
from afan_torch.ops import resize_ce as trce
from afan_torch.ops.kernels import nms as knms
from afan_torch.ops.kernels import pgd_step as kpgd
from afan_torch.ops.kernels import resize_ce as krce


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
def test_nms_kernel_rejects_non_contiguous(card):
    b = torch.zeros(4, 2, 10, device=card)[..., :4]
    with pytest.raises(ValueError):
        knms.nms_sorted_mask(b, torch.ones(4, 2, dtype=torch.bool,
                                           device=card), 0.5)


def _ce_inputs(card, B, H, h, C, seed=0):
    rng = np.random.RandomState(seed)
    lo = torch.from_numpy(rng.randn(B, C, h, h).astype(np.float32)).to(card)
    lab = rng.randint(0, C, (B, H, H)).astype(np.int32)
    lab[:, :3, :3] = 255
    g = torch.from_numpy(np.linspace(0.5, 1.5, B).astype(np.float32))
    return lo, torch.from_numpy(lab).to(card), g.to(card)


def _rel(got, want):
    return float((got - want).abs().max() / want.abs().max())


# Tolerances as in chip_smoke.py phase 7: max abs error over max abs value,
# 1e-5 for the sums and 1.1e-5 for the gradient (the float order of the
# sums and of the plain version's atomic gradient accumulation differ).
@pytest.mark.cuda
@pytest.mark.parametrize("B,H,h,C,focal", [
    (2, 768, 192, 19, None), (2, 768, 192, 19, (1.0, 2.0)),
    (2, 513, 129, 21, None), (1, 513, 129, 21, (1.0, 2.0))])
def test_resize_ce_kernels_match_plain(card, B, H, h, C, focal):
    lo, lab, g = _ce_inputs(card, B, H, h, C)
    before = (krce.fwd_launches, krce.bwd_launches)
    sums = krce.resize_ce_forward(lo, lab, focal)
    dlo = krce.resize_ce_backward(lo, lab, g, focal)
    want_s = trce.fused_resize_nll_sums_plain(lo, lab, (H, H), focal)
    want_d = trce.resize_ce_grad_plain(lo, lab, g, focal)
    torch.cuda.synchronize()
    assert (krce.fwd_launches, krce.bwd_launches) == (before[0] + 1,
                                                      before[1] + 1)
    assert _rel(sums, want_s) <= 1e-5
    assert _rel(dlo, want_d) <= 1.1e-5
    assert torch.equal(sums, krce.resize_ce_forward(lo, lab, focal))


@pytest.mark.cuda
def test_resize_ce_function_runs_the_kernels(card):
    lo, lab, g = _ce_inputs(card, 2, 64, 16, 5, seed=1)
    x = lo.clone().requires_grad_(True)
    before = (krce.fwd_launches, krce.bwd_launches)
    sums = trce.fused_resize_nll_sums(x, lab.long(), (64, 64))
    (grad,) = torch.autograd.grad(sums, x, g)
    assert (krce.fwd_launches, krce.bwd_launches) == (before[0] + 1,
                                                      before[1] + 1)
    assert torch.equal(grad, krce.resize_ce_backward(lo, lab, g))


@pytest.mark.cuda
def test_resize_ce_kernel_rejects_what_it_does_not_take(card):
    lo, lab, g = _ce_inputs(card, 2, 64, 16, 5)
    with pytest.raises(TypeError):
        krce.resize_ce_forward(lo.double(), lab)
    with pytest.raises(TypeError):
        krce.resize_ce_forward(lo, lab.long())
    with pytest.raises(ValueError):
        krce.resize_ce_forward(lo.transpose(2, 3), lab)


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
