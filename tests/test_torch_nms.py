"""afan_torch.ops.nms against afan.ops.nms, the Pallas kernel (interpret
mode), the native C++ oracle and the reference's golden fixture.

On the CPU every port function runs the plain PyTorch version of the NMS
kernel; keep masks must agree exactly (the IoU arithmetic is the same
float32 sequence on both sides). The CUDA kernel itself is compared with
the plain version on the card by ``chip_smoke.py`` and by
``tests/test_torch_cuda.py``.

The edge cases of the kernel's scan (``chip_smoke.NMS_EDGE_CASES``, which
the card runs too: ragged last words, suppression chains across word
boundaries, thresholds that suppress everything or nothing, degenerate
boxes, invalid slots inside a word) run here through the plain version,
the Pallas kernel in interpret mode, the native oracle and a numpy model
of the kernel's per-word scan (:func:`word_scan`).
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
from chip_smoke import NMS_EDGE_CASES, sorted_boxes
from torch_threads import one_torch_thread  # noqa: F401

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


# --- the per-word scan of csrc/nms.cu, rehearsed in numpy -----------------

def iou_words(boxes, thr, plus_one):
    """The kernel's mask pass: row i's bit j (j > i) of IoU >= thr, packed
    64 columns per uint64 word, (N, ceil(N/64)). The IoU is float32 in
    ``pairwise_iou``'s order, taken a block of rows at a time."""
    n = len(boxes)
    words = -(-n // 64)
    off = np.float32(1.0 if plus_one else 0.0)
    x1, y1, x2, y2 = (boxes[:, c] for c in range(4))
    area = (x2 - x1 + off) * (y2 - y1 + off)
    out = np.zeros((n, words), np.uint64)
    cols = np.arange(n)
    for s in range(0, n, 512):
        e = min(s + 512, n)
        w = np.maximum(np.minimum(x2[s:e, None], x2) -
                       np.maximum(x1[s:e, None], x1) + off, np.float32(0))
        h = np.maximum(np.minimum(y2[s:e, None], y2) -
                       np.maximum(y1[s:e, None], y1) + off, np.float32(0))
        inter = w * h
        union = area[s:e, None] + area - inter
        iou = inter / np.maximum(union, np.float32(1e-12))
        over = (iou >= np.float32(thr)) & (cols > np.arange(s, e)[:, None])
        over = np.pad(over, ((0, 0), (0, 64 * words - n)))
        packed = np.packbits(over, axis=1, bitorder="little")
        out[s:e] = packed.view("<u8")
    return out


def word_scan(mask, valid, pick=4):
    """The kernel's scan pass over ``mask`` (:func:`iou_words`): word w's
    64 boxes resolve at once from its diagonal words, ``pick`` candidates
    (the lowest boxes not removed) per trip, each kept unless a kept one
    before it removes it; the kept rows' columns w+1 and w+2 go into two
    running words (warp 0's registers), and columns w+3 onwards into the
    removed words in one OR per word (the other warps)."""
    n, words = mask.shape
    bits = np.pad(~valid, (0, 64 * words - n), constant_values=True)
    removed = np.packbits(bits, bitorder="little").view("<u8").copy()
    keep = np.zeros(64 * words, bool)
    pending = pending2 = 0
    for w in range(words):
        lim_mask = (1 << min(n - 64 * w, 64)) - 1
        cur = int(removed[w]) | pending
        kept = 0
        avail = ~cur & lim_mask
        while avail:
            ks = [k for k in range(64) if avail >> k & 1][:pick]
            for k in ks:
                if not cur >> k & 1:
                    kept |= 1 << k
                    cur |= int(mask[64 * w + k, w])
            avail = ~cur & lim_mask & ~((2 << ks[-1]) - 1)
        rows = 64 * w + np.array([k for k in range(64) if kept >> k & 1],
                                 dtype=np.int64)
        keep[rows] = True
        later = np.zeros(2, np.uint64)
        if len(rows) and w + 1 < words:
            later = np.bitwise_or.reduce(mask[rows, w + 1:], axis=0)
            removed[w + 3:] |= later[2:]
        pending = pending2 | int(later[0])
        pending2 = int(later[1]) if len(later) > 1 else 0
    return keep[:n]


def plain_keep(boxes, valid, thr, plus_one):
    return tnms.nms_sorted_mask_plain(
        torch.from_numpy(boxes)[None], torch.from_numpy(valid)[None], thr,
        plus_one)[0].numpy()


def oracle_keep(boxes, valid, thr, plus_one):
    """The native oracle on the valid boxes alone, in their order."""
    idx = np.nonzero(valid)[0]
    scores = np.arange(len(idx), 0, -1).astype(np.float32)
    kept = nms_cpu(boxes[idx], scores, thr, plus_one=plus_one)
    keep = np.zeros(len(boxes), bool)
    keep[idx[kept]] = True
    return keep


@pytest.mark.parametrize("plus_one", [True, False])
@pytest.mark.parametrize("case", sorted(NMS_EDGE_CASES))
class TestScanEdges:
    def test_plain_matches_pallas_kernel(self, case, plus_one):
        boxes, valid, thr = NMS_EDGE_CASES[case]()
        want = np.asarray(nms_sorted_mask_pallas(
            jnp.asarray(boxes), jnp.asarray(valid), thr, plus_one=plus_one,
            interpret=True))
        got = tnms.nms_mask_presorted(torch.from_numpy(boxes), thr,
                                      valid_sorted=torch.from_numpy(valid),
                                      plus_one=plus_one).numpy()
        np.testing.assert_array_equal(got, want)

    def test_plain_matches_native_oracle(self, case, plus_one):
        boxes, valid, thr = NMS_EDGE_CASES[case]()
        np.testing.assert_array_equal(plain_keep(boxes, valid, thr, plus_one),
                                      oracle_keep(boxes, valid, thr,
                                                  plus_one))

    def test_word_scan_matches_plain(self, case, plus_one):
        boxes, valid, thr = NMS_EDGE_CASES[case]()
        want = plain_keep(boxes, valid, thr, plus_one)
        mask = iou_words(boxes, thr, plus_one)
        for pick in (1, 4):
            np.testing.assert_array_equal(word_scan(mask, valid, pick), want)


def test_edge_cases_cover_the_scan():
    """The cases reach what they are named for."""
    keep = plain_keep(*NMS_EDGE_CASES["chain"](), True)
    assert keep[0::2].all() and not keep[1::2].any()
    keep = plain_keep(*NMS_EDGE_CASES["chain_shifted"](), True)
    assert keep[63] and not keep[64] and keep[65]
    for name, want in (("identical", 1), ("thr_zero", 1),
                       ("thr_above_one", 150)):
        assert plain_keep(*NMS_EDGE_CASES[name](), True).sum() == want
    b = NMS_EDGE_CASES["degenerate"]()[0]
    assert (b[:, 2] < b[:, 0]).any() and (b[:, 3] < b[:, 1]).any()
    assert (b[:, 2] == b[:, 0]).any()


@pytest.mark.parametrize("clustered", [False, True])
def test_word_scan_at_training_size(clustered):
    """G = 1, N = 12000 at 0.7, the training proposal NMS, on the card's
    boxes (``chip_smoke.sorted_boxes``): the numpy scan against the native
    oracle and the Pallas kernel (the plain version's N x N tensors would
    take gigabytes here)."""
    b = sorted_boxes(12000, 10, clustered)
    valid = np.ones(12000, bool)
    got = word_scan(iou_words(b, 0.7, True), valid)
    np.testing.assert_array_equal(got, oracle_keep(b, valid, 0.7, True))
    want = np.asarray(nms_sorted_mask_pallas(
        jnp.asarray(b), jnp.asarray(valid), 0.7, interpret=True))
    np.testing.assert_array_equal(got, want)
