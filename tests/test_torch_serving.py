"""afan_torch's serving layer: the websocket micro-batcher and the batched
detect post-processing (with a fake detect function, as tests/
test_serving.py does for afan), the preprocessing against afan's PIL path,
the port's import boundary, and its refusal to fall back to the CPU."""
import argparse
import asyncio
import os
import re

import numpy as np
import pytest
import torch

from afan.cli.infer_detect import preprocess_frame as j_preprocess_frame
from afan.data.voc_det import resize_image as pil_resize_image
from afan_torch.cli.infer_detect import (build_state, detect_batch,
                                         preprocess_frame)
from afan_torch.cli.serve_websocket import FrameBatcher
from afan_torch.data.voc_det import resize_image
from torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# The port's resize is PIL's fixed-point resample: it must agree exactly.
RESIZE_ATOL = 0.0


class FakeDetectFn:
    """Stands in for the detect path: (B,P,C) outputs where each frame's
    top-left pixel value selects the 'detection' probability — proves
    per-frame routing through the batch."""

    def __init__(self, P=5, C=3):
        self.P, self.C = P, C
        self.batch_sizes = []

    def __call__(self, images):
        b = images.shape[0]
        self.batch_sizes.append(b)
        boxes = torch.tensor([10.0, 10.0, 20.0, 20.0]).repeat(b, self.P,
                                                              self.C, 1)
        probs = torch.zeros((b, self.P, self.C))
        probs[:, 0, 1] = images[:, 0, 0, 0]  # frame-identifying prob
        keep = torch.zeros((b, self.P, self.C), dtype=torch.bool)
        keep[:, 0, 1] = True
        return boxes, probs, keep


class TestDetectBatch:
    def test_per_frame_rescale_and_threshold(self):
        fn = FakeDetectFn()
        canvases = np.zeros((2, 8, 8, 3), np.float32)
        canvases[0, 0, 0, 0] = 0.9
        canvases[1, 0, 0, 0] = 0.3   # below threshold
        res = detect_batch(fn, canvases, [2.0, 1.0], 0.5)
        assert len(res) == 2
        assert len(res[0]) == 1 and len(res[1]) == 0
        box, c, p = res[0][0]
        np.testing.assert_allclose(box, [5.0, 5.0, 10.0, 10.0])  # /scale
        assert c == 1 and abs(p - 0.9) < 1e-6


class TestFrameBatcher:
    def _mk(self, fn, max_batch=4):
        return FrameBatcher(fn, (8, 8), 8.0, 8.0, 0.5, max_batch=max_batch)

    def test_single_frame_uses_batch_one(self):
        fn = FakeDetectFn()
        b = self._mk(fn)

        async def go():
            worker = asyncio.create_task(b.worker())
            img = np.zeros((8, 8, 3), np.float32)
            img[0, 0, 0] = 0.8
            dets = await b.submit(img)
            worker.cancel()
            return dets

        dets = asyncio.run(go())
        assert len(dets) == 1
        assert fn.batch_sizes == [1]

    def test_concurrent_frames_are_batched_and_padded(self):
        fn = FakeDetectFn()
        b = self._mk(fn, max_batch=4)

        async def go():
            imgs = []
            for i in range(3):
                img = np.zeros((8, 8, 3), np.float32)
                img[0, 0, 0] = 0.6 + 0.1 * i
                imgs.append(img)
            # enqueue all before the worker starts draining
            subs = [asyncio.create_task(b.submit(im)) for im in imgs]
            await asyncio.sleep(0)          # let submits enqueue
            worker = asyncio.create_task(b.worker())
            out = await asyncio.gather(*subs)
            worker.cancel()
            return out

        out = asyncio.run(go())
        # 3 pending frames → one padded batch of max_batch
        assert fn.batch_sizes == [4]
        probs = [dets[0][2] for dets in out]
        # resize round-trips through uint8 → ~1/255 quantization
        np.testing.assert_allclose(probs, [0.6, 0.7, 0.8], atol=0.005)

    def test_device_error_propagates(self):
        def boom(images):
            raise RuntimeError("device on fire")

        b = self._mk(boom)

        async def go():
            worker = asyncio.create_task(b.worker())
            try:
                await b.submit(np.zeros((8, 8, 3), np.float32))
            except RuntimeError as e:
                return str(e)
            finally:
                worker.cancel()
            return None

        assert asyncio.run(go()) == "device on fire"


@pytest.mark.parametrize("hw,scale", [((480, 640), 1.25), ((375, 500), 1.6),
                                      ((800, 1200), 0.75), ((37, 53), 2.3)])
def test_resize_matches_pil(hw, scale):
    _resize_matches_pil(hw, scale, seed=hw[0])


# the smallest input on which the earlier antialiased F.interpolate resize
# missed PIL by one uint8 level (7 of 48 values), and an odd downscale,
# where PIL's filter support widens
@pytest.mark.parametrize("hw,scale,seed", [((2, 2), 2.0, 0),
                                           ((37, 53), 0.6, 37)])
def test_resize_matches_pil_exactly_at_the_edges(hw, scale, seed):
    _resize_matches_pil(hw, scale, seed)


def _resize_matches_pil(hw, scale, seed):
    img = np.random.RandomState(seed).rand(*hw, 3).astype(np.float32)
    want = pil_resize_image(img, scale)
    got = resize_image(img, scale)
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=RESIZE_ATOL)


def test_preprocess_frame_matches_afan():
    img = np.random.RandomState(7).rand(480, 640, 3).astype(np.float32)
    got, s_got = preprocess_frame(img, (608, 1008), 600.0, 1000.0)
    want, s_want = j_preprocess_frame(img, (608, 1008), 600.0, 1000.0)
    assert s_got == s_want
    np.testing.assert_allclose(got, want, rtol=0, atol=RESIZE_ATOL)
    assert not got[600:].any() and not got[:, 800:].any()


def _port_sources():
    for d, _, files in os.walk(os.path.join(ROOT, "afan_torch")):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)
    yield os.path.join(ROOT, "chip_smoke.py")


def test_port_imports_neither_jax_nor_afan():
    pat = re.compile(r"^\s*(from|import)\s+(jax|afan)(\.|\s|$)", re.M)
    sources = list(_port_sources())
    assert len(sources) > 10
    for path in sources:
        with open(path) as f:
            hit = pat.search(f.read())
        assert hit is None, f"{path}: {hit.group(0)!r}"


def test_entry_point_refuses_cpu_fallback():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")
    args = argparse.Namespace(backbone="resnet18", checkpoint=None,
                              image_min_side=64.0, image_max_side=64.0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_state(args, num_classes=4)
    model, canvas_hw = build_state(args, num_classes=4, device="cpu")
    assert canvas_hw == (64, 64)
    assert next(model.parameters()).device.type == "cpu"
