"""Detection inference — the PyTorch counterpart of
``afan/cli/infer_detect.py``: single image with box drawing, a directory,
or a cv2 stream with a frame-skip period.

Images are resized with the dataset rule, pasted onto the static canvas, run
through the detect path on the card, and detections above ``--prob_thresh``
are drawn with class/prob labels. ``image`` and ``dir`` need neither PIL
nor OpenCV (the machine with the card has neither): a file is read by
:func:`afan_torch.utils.imread.read_rgb` (PIL's bytes), the boxes and labels
are drawn by :mod:`afan_torch.utils.draw` (OpenCV's pixels) and the result
is written by :func:`afan_torch.utils.png.write_png`. ``afan`` writes
through ``cv2.imwrite``, whose format follows the name; the port writes
PNG, so ``dir`` names each output ``<name>.png``. ``stream`` (a camera and
a window) imports ``cv2`` there, as ``afan``'s does.
"""
from __future__ import annotations

import argparse
import os
import time
from typing import List, Tuple

import numpy as np
import torch

from ..data.voc_det import VOC_CLASSES, compute_scale, resize_image
from ..models.frcnn import FRCNNConfig, FasterRCNN
from ..train.checkpoint import load_checkpoint, overlap_restore
from ..train.detect_loop import make_detect_fn
from ..utils.device import resolve_device
from ..utils.draw import put_text, rectangle
from ..utils.imread import read_rgb
from ..utils.logging import Log
from ..utils.png import write_png


def build_state(args, num_classes: int = 21, device=None):
    """Build the detector on ``device`` (the card unless ``"cpu"``) with
    the init seeded by 0, then restore ``args.checkpoint`` if given
    (reference layout, overlap restore) → (model, canvas_hw)."""
    dev = resolve_device(device)
    cfg = FRCNNConfig(backbone=args.backbone, num_classes=num_classes)
    model = FasterRCNN(cfg)
    model.reset_parameters(torch.Generator().manual_seed(0))
    if args.checkpoint:
        frac = overlap_restore(model, load_checkpoint(args.checkpoint))
        Log.i(f"loaded {frac:.1%} from {args.checkpoint}")
    model = model.to(dev).eval()
    # canonical fat canvas for inference
    h = int(-(-args.image_min_side // 16) * 16)
    w = int(-(-args.image_max_side // 16) * 16)
    return model, (h, w)


def preprocess_frame(img: np.ndarray, canvas_hw, min_side: float,
                     max_side: float) -> Tuple[np.ndarray, float]:
    """Resize rule + paste onto the static canvas → (canvas, scale)."""
    h0, w0 = img.shape[:2]
    scale = compute_scale(w0, h0, min_side, max_side)
    resized = resize_image(img, scale)
    ch, cw = canvas_hw
    canvas = np.zeros((ch, cw, 3), np.float32)
    rh, rw = min(resized.shape[0], ch), min(resized.shape[1], cw)
    canvas[:rh, :rw] = resized[:rh, :rw]
    return canvas, scale


def detect_batch(detect_fn, canvases: np.ndarray, scales: List[float],
                 prob_thresh: float
                 ) -> List[List[Tuple[np.ndarray, int, float]]]:
    """Batched detect on pre-canvased frames → per-frame detection lists
    (boxes rescaled to each frame's original coordinates)."""
    out = detect_fn(torch.from_numpy(np.ascontiguousarray(canvases)))
    boxes, probs, keep = (t.cpu().numpy() for t in out)
    results = []
    for b, scale in enumerate(scales):
        dets = []
        sel = np.nonzero(keep[b] & (probs[b] > prob_thresh))
        for p_idx, c in zip(*sel):
            dets.append((boxes[b, p_idx, c] / scale, int(c),
                         float(probs[b, p_idx, c])))
        results.append(dets)
    return results


def detect_image(detect_fn, canvas_hw, img: np.ndarray, min_side: float,
                 max_side: float, prob_thresh: float
                 ) -> List[Tuple[np.ndarray, int, float]]:
    """img: float32 [0,1] HWC → [(box_xyxy_in_orig_coords, class, prob)]."""
    canvas, scale = preprocess_frame(img, canvas_hw, min_side, max_side)
    return detect_batch(detect_fn, canvas[None], [scale], prob_thresh)[0]


def draw(img: np.ndarray, detections, class_names=VOC_CLASSES) -> np.ndarray:
    """``afan``'s drawing: per detection a box of thickness 2 and its
    ``name prob`` label above it, in the class's colour; the pixels of
    ``cv2.rectangle`` and ``cv2.putText`` (:mod:`afan_torch.utils.draw`)."""
    vis = (img * 255).astype(np.uint8).copy()
    for box, c, p in detections:
        x1, y1, x2, y2 = box.astype(int)
        color = (int((c * 37) % 255), int((c * 91) % 255),
                 int((c * 151) % 255))
        rectangle(vis, (x1, y1), (x2, y2), color)
        name = class_names[c - 1] if 0 < c <= len(class_names) else str(c)
        put_text(vis, f"{name} {p:.2f}", (x1, max(y1 - 4, 10)), color)
    return vis


def main(argv=None):
    p = argparse.ArgumentParser(description="A-FAN detection inference "
                                            "(PyTorch)")
    p.add_argument("mode", choices=["image", "dir", "stream"])
    p.add_argument("input", help="image path / directory / camera index")
    p.add_argument("output", nargs="?", default="out.png")
    p.add_argument("-c", "--checkpoint", default=None)
    p.add_argument("-b", "--backbone", default="resnet50")
    p.add_argument("--device", default=None,
                   help="torch device; the card (cuda) unless given")
    p.add_argument("--image_min_side", type=float, default=600.0)
    p.add_argument("--image_max_side", type=float, default=1000.0)
    p.add_argument("-p", "--prob_thresh", "--probability_threshold",
                   type=float, default=0.6, dest="prob_thresh")
    p.add_argument("--period", type=int, default=3,
                   help="stream frame-skip period (infer_stream.py)")
    args = p.parse_args(argv)
    Log.initialize()

    model, canvas_hw = build_state(args, device=args.device)
    detect_fn = make_detect_fn(model)

    def run_one(path, out_path):
        img = read_rgb(path).astype(np.float32) / 255.0
        t0 = time.time()
        dets = detect_image(detect_fn, canvas_hw, img, args.image_min_side,
                            args.image_max_side, args.prob_thresh)
        Log.i(f"{path}: {len(dets)} detections in {time.time() - t0:.2f}s")
        write_png(out_path, draw(img, dets))
        Log.i(f"wrote {out_path}")

    if args.mode == "image":
        run_one(args.input, args.output)
    elif args.mode == "dir":
        os.makedirs(args.output, exist_ok=True)
        for f in sorted(os.listdir(args.input)):
            if f.lower().endswith((".jpg", ".jpeg", ".png")):
                run_one(os.path.join(args.input, f), os.path.join(
                    args.output, os.path.splitext(f)[0] + ".png"))
    else:  # stream (`infer_stream.py:19-60`)
        import cv2
        cap = cv2.VideoCapture(int(args.input) if args.input.isdigit()
                               else args.input)
        frame_idx = 0
        while cap.isOpened():
            ok, frame = cap.read()
            if not ok:
                break
            if frame_idx % args.period == 0:
                img = cv2.cvtColor(frame, cv2.COLOR_BGR2RGB).astype(
                    np.float32) / 255.0
                dets = detect_image(detect_fn, canvas_hw, img,
                                    args.image_min_side,
                                    args.image_max_side, args.prob_thresh)
                vis = draw(img, dets)
                cv2.imshow("afan", cv2.cvtColor(vis, cv2.COLOR_RGB2BGR))
                if cv2.waitKey(1) & 0xFF == ord("q"):
                    break
            frame_idx += 1
        cap.release()


if __name__ == "__main__":
    main()
