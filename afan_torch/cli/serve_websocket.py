"""Websocket detection server — the PyTorch counterpart of
``afan/cli/serve_websocket.py`` (port of `Detection/infer_websocket.py`): an
asyncio websockets server consuming raw HxWx3 RGB frames and returning JSON
detections ``[{"bbox": [x1,y1,x2,y2], "label": c, "prob": p}, ...]``. The
browser client lives in ``webapp/``.

Frames from concurrent clients are drained from a queue and run as one
batched detect call, padded to a batch of 1 or ``max_batch``; answers fan
back out per frame. The device call runs in a thread executor so the event
loop stays responsive while the card works. ``websockets`` is imported in
:func:`main` only.
"""
from __future__ import annotations

import argparse
import asyncio
import json

import numpy as np

from ..train.detect_loop import make_detect_fn
from ..utils.logging import Log
from .infer_detect import build_state, detect_batch, preprocess_frame


class FrameBatcher:
    """Queue frames, drain up to ``max_batch`` per device call, resolve
    each frame's future with its detection list."""

    def __init__(self, detect_fn, canvas_hw, min_side, max_side, prob_thresh,
                 max_batch: int = 4):
        self.detect_fn = detect_fn
        self.canvas_hw = canvas_hw
        self.min_side = min_side
        self.max_side = max_side
        self.prob_thresh = prob_thresh
        self.max_batch = max_batch
        self.queue: asyncio.Queue = asyncio.Queue()

    def batch_size_for(self, n: int) -> int:
        """Pad pending frames to a warmed-up size: 1 or max_batch."""
        return 1 if n == 1 else self.max_batch

    def warmup(self):
        """Run every serving batch size once before the socket opens, so
        the first client frame pays no one-time set-up."""
        ch, cw = self.canvas_hw
        for bs in sorted({1, self.max_batch}):
            Log.i(f"warmup: detect at batch {bs}...")
            detect_batch(self.detect_fn, np.zeros((bs, ch, cw, 3), np.float32),
                         [1.0] * bs, self.prob_thresh)
        Log.i("warmup done")

    async def submit(self, img: np.ndarray):
        fut = asyncio.get_running_loop().create_future()
        await self.queue.put((img, fut))
        return await fut

    def _run_batch(self, items):
        canvases, scales = [], []
        for img, _ in items:
            canvas, scale = preprocess_frame(img, self.canvas_hw,
                                             self.min_side, self.max_side)
            canvases.append(canvas)
            scales.append(scale)
        bs = self.batch_size_for(len(items))
        ch, cw = self.canvas_hw
        while len(canvases) < bs:  # pad to a warmed-up batch size
            canvases.append(np.zeros((ch, cw, 3), np.float32))
            scales.append(1.0)
        results = detect_batch(self.detect_fn, np.stack(canvases), scales,
                               self.prob_thresh)
        return results[:len(items)]

    async def worker(self):
        loop = asyncio.get_running_loop()
        while True:
            items = [await self.queue.get()]
            while len(items) < self.max_batch:
                try:
                    items.append(self.queue.get_nowait())
                except asyncio.QueueEmpty:
                    break
            try:
                results = await loop.run_in_executor(
                    None, self._run_batch, items)
                for (_, fut), dets in zip(items, results):
                    if not fut.done():
                        fut.set_result(dets)
            except Exception as e:  # surface device errors to the clients
                for _, fut in items:
                    if not fut.done():
                        fut.set_exception(e)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("-c", "--checkpoint", default=None)
    p.add_argument("-b", "--backbone", default="resnet50")
    p.add_argument("--device", default=None,
                   help="torch device; the card (cuda) unless given")
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=8765)
    p.add_argument("--frame_width", type=int, default=640)
    p.add_argument("--frame_height", type=int, default=480)
    p.add_argument("--image_min_side", type=float, default=600.0)
    p.add_argument("--image_max_side", type=float, default=1000.0)
    p.add_argument("-p", "--prob_thresh", type=float, default=0.6)
    p.add_argument("--max_batch", type=int, default=4,
                   help="micro-batch cap for concurrent frames")
    p.add_argument("--no_warmup", action="store_true",
                   help="skip the warmup at startup")
    args = p.parse_args(argv)
    Log.initialize()

    import websockets

    model, canvas_hw = build_state(args, device=args.device)
    batcher = FrameBatcher(make_detect_fn(model), canvas_hw,
                           args.image_min_side, args.image_max_side,
                           args.prob_thresh, max_batch=args.max_batch)
    if not args.no_warmup:
        batcher.warmup()
    h, w = args.frame_height, args.frame_width

    async def handler(ws):
        Log.i(f"client connected: {ws.remote_address}")
        async for message in ws:
            if isinstance(message, str):
                continue
            frame = np.frombuffer(message, np.uint8)
            if frame.size != h * w * 3:
                await ws.send(json.dumps(
                    {"error": f"expected {h}x{w}x3 raw RGB bytes"}))
                continue
            img = frame.reshape(h, w, 3).astype(np.float32) / 255.0
            dets = await batcher.submit(img)
            await ws.send(json.dumps([
                {"bbox": [float(v) for v in box], "label": int(c),
                 "prob": float(prob)} for box, c, prob in dets]))

    async def serve():
        worker = asyncio.create_task(batcher.worker())
        try:
            async with websockets.serve(handler, args.host, args.port,
                                        max_size=2 * h * w * 3 + 65536):
                Log.i(f"serving on ws://{args.host}:{args.port} "
                      f"(max_batch {args.max_batch})")
                await asyncio.Future()
        finally:
            worker.cancel()

    asyncio.run(serve())


if __name__ == "__main__":
    main()
