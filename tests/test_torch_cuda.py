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
from afan_torch.ops.kernels import nms as knms


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the NMS kernel has no CPU mode")
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
