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

REL = 1e-5

# (name, B, h, w, C, H, W, focal)
CASES = [
    ("tiny", 2, 8, 8, 4, 32, 32, None),
    ("odd_h", 2, 9, 7, 5, 33, 28, None),
    ("focal", 2, 8, 8, 4, 32, 32, (1.0, 2.0)),
    ("odd_h_focal", 1, 9, 9, 21, 33, 33, (1.0, 2.0)),
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
