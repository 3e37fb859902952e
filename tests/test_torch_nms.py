"""afan_torch.ops.nms against afan.ops.nms, the Pallas kernel (interpret
mode), the native C++ oracle and the reference's golden fixture.

On the CPU every port function runs the plain PyTorch version of the NMS
kernel; keep masks must agree exactly (the IoU arithmetic is the same
float32 sequence on both sides). The CUDA kernel itself is compared with
the plain version on the card by ``chip_smoke.py`` and by
``tests/test_torch_cuda.py``.
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from afan.ops import nms as jnms
from afan.ops.kernels.nms_kernel import nms_sorted_mask_pallas
from afan.ops.native import nms_cpu
from afan_torch.ops import nms as tnms
from afan_torch.ops.kernels import nms as knms

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")


def uniform_boxes(n, seed, size=400.0, wmax=80.0):
    rng = np.random.RandomState(seed)
    xy = rng.rand(n, 2) * size
    wh = rng.rand(n, 2) * wmax + 4
    boxes = np.concatenate([xy, xy + wh], 1).astype(np.float32)
    return boxes, rng.rand(n).astype(np.float32)


def clustered_boxes(n, seed):
    """Big boxes around few centres: deep suppression chains across
    blocks (the dense-overlap case of tests/test_kernels.py)."""
    rng = np.random.RandomState(seed)
    centers = rng.rand(8, 2) * 300
    which = rng.randint(0, 8, n)
    xy = centers[which] + rng.randn(n, 2) * 12
    wh = rng.rand(n, 2) * 120 + 60
    boxes = np.concatenate([xy, xy + wh], 1).astype(np.float32)
    return boxes, rng.rand(n).astype(np.float32)


CASES = {
    "uniform": lambda: uniform_boxes(700, 1) + (None,),
    "clustered": lambda: clustered_boxes(600, 2) + (None,),
    "all_invalid": lambda: uniform_boxes(200, 3) + (np.zeros(200, bool),),
    "valid_mask": lambda: uniform_boxes(300, 4) + (np.arange(300) < 170,),
}


def _t(a):
    return None if a is None else torch.from_numpy(np.asarray(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


@pytest.mark.parametrize("plus_one", [True, False])
@pytest.mark.parametrize("case", sorted(CASES))
class TestMatchesAfan:
    def test_nms_mask(self, case, plus_one):
        boxes, scores, valid = CASES[case]()
        want = np.asarray(jnms.nms_mask(_j(boxes), _j(scores), 0.5,
                                        valid=_j(valid), plus_one=plus_one))
        got = tnms.nms_mask(_t(boxes), _t(scores), 0.5, valid=_t(valid),
                            plus_one=plus_one).numpy()
        np.testing.assert_array_equal(got, want)
        if valid is not None and not valid.any():
            assert not got.any()

    def test_nms_mask_presorted(self, case, plus_one):
        boxes, scores, valid = CASES[case]()
        order = np.argsort(-scores, kind="stable")
        b = boxes[order]
        v = None if valid is None else valid[order]
        want = np.asarray(jnms.nms_mask_presorted(
            _j(b), 0.6, valid_sorted=_j(v), plus_one=plus_one))
        got = tnms.nms_mask_presorted(_t(b), 0.6, valid_sorted=_t(v),
                                      plus_one=plus_one).numpy()
        np.testing.assert_array_equal(got, want)

    def test_nms_select_presorted(self, case, plus_one):
        boxes, scores, valid = CASES[case]()
        order = np.argsort(-scores, kind="stable")
        b = boxes[order]
        v = None if valid is None else valid[order]
        wb, wv = jnms.nms_select_presorted(_j(b), 0.7, 50, plus_one=plus_one,
                                           valid_sorted=_j(v))
        gb, gv = tnms.nms_select_presorted(_t(b), 0.7, 50, plus_one=plus_one,
                                           valid_sorted=_t(v))
        np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
        np.testing.assert_array_equal(gb.numpy(), np.asarray(wb))

    def test_nms_padded(self, case, plus_one):
        boxes, scores, valid = CASES[case]()
        wi, wm = jnms.nms_padded(_j(boxes), _j(scores), 0.5, 1000,
                                 valid=_j(valid), plus_one=plus_one)
        gi, gm = tnms.nms_padded(_t(boxes), _t(scores), 0.5, 1000,
                                 valid=_t(valid), plus_one=plus_one)
        np.testing.assert_array_equal(gm.numpy(), np.asarray(wm))
        np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))


@pytest.mark.parametrize("n", [300, 3000])
def test_matches_pallas_kernel(n):
    boxes, scores = uniform_boxes(n, n)
    order = np.argsort(-scores, kind="stable")
    b = boxes[order]
    want = np.asarray(nms_sorted_mask_pallas(
        jnp.asarray(b), jnp.ones(n, bool), 0.6, interpret=True))
    got = tnms.nms_mask_presorted(torch.from_numpy(b), 0.6).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n,seed,plus_one", [(1, 0, True), (37, 1, True),
                                             (513, 3, True), (400, 5, False)])
def test_matches_native_oracle(n, seed, plus_one):
    boxes, scores = uniform_boxes(n, seed, size=200.0, wmax=60.0)
    want = set(nms_cpu(boxes, scores, 0.5, plus_one=plus_one).tolist())
    keep = tnms.nms_mask(torch.from_numpy(boxes), torch.from_numpy(scores),
                         0.5, plus_one=plus_one).numpy()
    assert set(np.nonzero(keep)[0].tolist()) == want


def test_golden_large():
    det = np.load(os.path.join(FIXTURES, "nms-large-input.npy"))
    keep = tnms.nms_mask(torch.from_numpy(det[:, :4].astype(np.float32)),
                         torch.from_numpy(det[:, 4].astype(np.float32)),
                         0.7).numpy()
    kept = np.nonzero(keep)[0]
    assert len(kept) == 1934
    expect = np.load(os.path.join(FIXTURES, "nms-large-output.npy"))
    assert sorted(kept.tolist()) == sorted(expect.tolist())


def test_batched_equals_separate_calls():
    g, n = 6, 150
    boxes = np.stack([clustered_boxes(n, 10 + i)[0] for i in range(g)])
    valid = np.random.RandomState(0).rand(g, n) < 0.8
    batched = tnms.nms_mask_presorted(torch.from_numpy(boxes), 0.3,
                                      valid_sorted=torch.from_numpy(valid))
    for i in range(g):
        one = tnms.nms_mask_presorted(torch.from_numpy(boxes[i]), 0.3,
                                      valid_sorted=torch.from_numpy(valid[i]))
        np.testing.assert_array_equal(batched[i].numpy(), one.numpy())
    assert batched.shape == (g, n)


def test_wrapper_rejects_bad_input():
    b = torch.zeros(2, 5, 4)
    with pytest.raises(ValueError):
        knms.nms_sorted_mask(b[0], torch.ones(2, 5, dtype=torch.bool), 0.5)
    with pytest.raises(TypeError):
        knms.nms_sorted_mask(b.double(), torch.ones(2, 5, dtype=torch.bool),
                             0.5)
    with pytest.raises(TypeError):
        knms.nms_sorted_mask(b, torch.ones(2, 5), 0.5)


def test_cpu_takes_plain_version_without_launch():
    before = knms.launches
    boxes, _ = uniform_boxes(64, 0)
    keep = knms.nms_sorted_mask(torch.from_numpy(boxes)[None],
                                torch.ones(1, 64, dtype=torch.bool), 0.5)
    assert keep.shape == (1, 64) and keep.dtype == torch.bool
    assert knms.launches == before

