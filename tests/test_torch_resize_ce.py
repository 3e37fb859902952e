"""afan_torch's fused upsample + CE (``afan_torch.ops.resize_ce``) against
``afan``'s: the Pallas kernel run in interpret mode on the CPU, and the XLA
``resize_bilinear`` + ``_per_entry_loss_sums`` path.

On the CPU the port's op is its plain version (the upsample and the loss in
PyTorch, differentiated by autograd); the CUDA kernels are held against the
same plain version on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``).

Tolerance: float32 sums over thousands of pixels and gradients gathered
through the interpolation weights are taken in another order in XLA and in
PyTorch, so outputs agree within ``1e-5 * max|want|`` of the compared
tensor.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from afan.models.deeplab.heads import resize_bilinear as j_resize
from afan.ops.kernels.resize_ce_kernel import \
    fused_resize_nll_sums as j_fused
from afan.train.segment_loop import _per_entry_loss_sums as j_sums
from afan_torch.models.deeplab.heads import resize_bilinear
from afan_torch.ops import resize_ce as rce
from afan_torch.ops.kernels import resize_ce as krce
from torch_threads import one_torch_thread  # noqa: F401

REL = 1e-5

# (name, B, h, w, C, H, W, focal): small geometries, then the edges that
# the card's kernels are held to (chip_smoke.py:CE_CASES): eight entries, a
# single low-res pixel, and h, w, C all odd or small with focal loss
CASES = [
    ("tiny", 2, 8, 8, 4, 32, 32, None),
    ("odd_h", 2, 9, 7, 5, 33, 28, None),
    ("focal", 2, 8, 8, 4, 32, 32, (1.0, 2.0)),
    ("odd_h_focal", 1, 9, 9, 21, 33, 33, (1.0, 2.0)),
    ("b8", 8, 8, 8, 4, 32, 32, None),
    ("one_pixel", 2, 1, 1, 4, 4, 4, None),
    ("h6_w5_focal", 2, 6, 5, 3, 24, 20, (1.0, 2.0)),
]


def close(got, want, rel=REL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * max(np.abs(want).max(), 1e-6))


def inputs(B, h, w, C, H, W, seed=0, all_ignored=False):
    rng = np.random.RandomState(seed)
    lo = rng.randn(B, h, w, C).astype(np.float32)
    lab = rng.randint(0, C, (B, H, W)).astype(np.int32)
    lab[0, :3, :3] = 255
    if all_ignored:
        lab[-1] = 255
    g = np.linspace(0.5, 1.5, B).astype(np.float32)
    return lo, lab, g


def port_sums_and_grad(lo, lab, g, focal):
    """The port's op on CPU tensors: its plain version, with no kernel
    launch."""
    x = torch.from_numpy(lo).permute(0, 3, 1, 2).contiguous()
    x.requires_grad_(True)
    before = (krce.fwd_launches, krce.bwd_launches)
    sums = rce.fused_resize_nll_sums(x, torch.from_numpy(lab),
                                     lab.shape[1:], focal)
    (grad,) = torch.autograd.grad(sums, x, torch.from_numpy(g))
    assert (krce.fwd_launches, krce.bwd_launches) == before
    return sums.detach().numpy(), grad.permute(0, 2, 3, 1).numpy()


def jax_sums_and_grad(fn, lo, g):
    sums, vjp = jax.vjp(fn, jnp.asarray(lo))
    return np.asarray(sums), np.asarray(vjp(jnp.asarray(g))[0])


@pytest.mark.parametrize("case", CASES + [
    ("all_ignored_entry", 2, 8, 8, 4, 32, 32, None)], ids=lambda c: c[0])
def test_plain_matches_interpret_kernel(case):
    name, B, h, w, C, H, W, focal = case
    lo, lab, g = inputs(B, h, w, C, H, W,
                        all_ignored=name == "all_ignored_entry")
    want_s, want_g = jax_sums_and_grad(
        lambda x: j_fused(x, jnp.asarray(lab), (H, W), True, focal), lo, g)
    got_s, got_g = port_sums_and_grad(lo, lab, g, focal)
    close(got_s, want_s)
    close(got_g, want_g)
    if name == "all_ignored_entry":
        assert got_s[-1] == 0.0 and not got_g[-1].any()


@pytest.mark.parametrize("case", CASES, ids=lambda c: c[0])
def test_plain_matches_xla_resize_and_sums(case):
    _, B, h, w, C, H, W, focal = case
    lo, lab, g = inputs(B, h, w, C, H, W, seed=1)

    def ref(x):
        return j_sums(j_resize(x, (H, W)), jnp.asarray(lab),
                      focal is not None)
    want_s, want_g = jax_sums_and_grad(ref, lo, g)
    got_s, got_g = port_sums_and_grad(lo, lab, g, focal)
    close(got_s, want_s)
    close(got_g, want_g)


@pytest.mark.parametrize("hw,HW", [((8, 8), (32, 32)), ((9, 7), (33, 28)),
                                   ((5, 13), (20, 40)), ((1, 3), (4, 12))])
def test_resize_bilinear_matches_jax_when_upsampling(hw, HW):
    """``jax.image.resize`` antialiases only when it shrinks; every resize
    on the segmentation path grows, where it and ``F.interpolate`` agree."""
    x = np.random.RandomState(2).randn(2, hw[0], hw[1], 3).astype(np.float32)
    want = np.asarray(j_resize(jnp.asarray(x), HW))
    got = resize_bilinear(torch.from_numpy(x).permute(0, 3, 1, 2), HW)
    close(got.permute(0, 2, 3, 1).numpy(), want, rel=1e-6)


# (h, w, H, W): the segmentation step's geometries (192 -> 768, 128 -> 512,
# 129 -> 513), odd sizes, a single low-res pixel, h not a multiple of the
# band's rows with odd w, and both at once
PLAN_CASES = [(192, 192, 768, 768), (128, 128, 512, 512),
              (129, 129, 513, 513), (9, 7, 33, 28), (1, 1, 4, 4),
              (6, 5, 24, 20), (10, 13, 40, 52)]


def axis_weights(n_out, n_in):
    """The ``(n_out, n_in)`` bilinear weights of ``resize_bilinear`` along
    one axis, read off an identity."""
    eye = torch.eye(n_in).reshape(n_in, 1, n_in, 1)
    return resize_bilinear(eye, (n_out, 1))[:, 0, :, 0].T.numpy()


@pytest.mark.parametrize("h,w,H,W", PLAN_CASES)
def test_band_plan_covers_every_tap(h, w, H, W):
    """Every (output, low-res) pair with a non-zero weight lies in the
    visited range of the band block that owns the low-res index, the owned
    ranges tile [0, h) x [0, w) once, and the kernels' tap rule gives
    ``resize_bilinear``'s weights exactly."""
    wy, wx = axis_weights(H, h), axis_weights(W, w)
    for n_out, n_in, want in ((H, h, wy), (W, w, wx)):
        i0, i1, l0, l1 = krce.source_taps(n_out, n_in)
        got = np.zeros((n_out, n_in), np.float32)
        np.add.at(got, (np.arange(n_out), i0), l0)
        np.add.at(got, (np.arange(n_out), i1), l1)
        np.testing.assert_array_equal(got, want)
    plan = krce.band_plan(h, w, H, W)
    assert plan.dtype == np.int32 and plan.shape[1] == 8
    owners = np.zeros((h, w), np.int64)
    for ya, yb, i_lo, i_hi, xa, xb, j_lo, j_hi in plan:
        assert 0 < yb - ya <= krce.BAND_ROWS and xb > xa
        assert 0 <= i_lo <= i_hi <= H and 0 <= j_lo <= j_hi <= W
        owners[ya:yb, xa:xb] += 1
        rows = np.nonzero(wy[:, ya:yb].any(axis=1))[0]
        cols = np.nonzero(wx[:, xa:xb].any(axis=1))[0]
        assert i_lo <= rows.min() and rows.max() < i_hi
        assert j_lo <= cols.min() and cols.max() < j_hi
    assert (owners == 1).all()
    assert len(plan) == -(-h // krce.BAND_ROWS) * min(w, krce.COL_SPLITS)


def test_kernel_wrappers_refuse_cpu_tensors():
    lo, lab, g = inputs(2, 8, 8, 4, 32, 32, seed=3)
    x = torch.from_numpy(lo).permute(0, 3, 1, 2).contiguous()
    labels = torch.from_numpy(lab)
    before = (krce.fwd_launches, krce.bwd_launches)
    with pytest.raises(ValueError, match="no resize\\+CE kernel"):
        krce.resize_ce_forward(x, labels)
    with pytest.raises(ValueError, match="no resize\\+CE kernel"):
        krce.resize_ce_backward(x, labels, torch.from_numpy(g))
    assert (krce.fwd_launches, krce.bwd_launches) == before


def test_wrong_shapes_raise():
    x = torch.zeros(2, 4, 8, 8)
    with pytest.raises(ValueError):
        krce.resize_ce_forward(x[0], torch.zeros(2, 32, 32, dtype=torch.int32))
    with pytest.raises(ValueError):
        krce.resize_ce_forward(x, torch.zeros(3, 32, 32, dtype=torch.int32))
    with pytest.raises(ValueError):
        rce.fused_resize_nll_sums(x, torch.zeros(2, 32, 32), (32, 30))
