"""Write the image fixtures of ``tests/test_torch_imread.py`` and
``chip_smoke.py --only data`` with PIL, and their manifest: the sha256 of
PIL's decoded bytes (``np.asarray(Image.open(p).convert("RGB"))`` for an
image, ``np.asarray(Image.open(p), np.uint8)`` for a label map).

    python tests/fixtures/torch_images/make_fixtures.py

The content is smooth and synthetic: sines over the image plane, a little
seeded noise, and for the label maps class rectangles with 255 borders.
PIL writes no interlaced and no 16-bit colour PNG, so :func:`encode_png`, a
small numpy encoder, writes those (any colour type and bit depth, Adam7 or
not); the tests use it too.
"""
import hashlib
import io
import json
import os
import struct
import sys
import zlib

import numpy as np
from PIL import Image

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(HERE))))
from chip_smoke import png_filtered_rows  # noqa: E402


def smooth(h, w, seed):
    rng = np.random.RandomState(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.stack([128 + 100 * np.sin(x / 37 + seed) * np.cos(y / 29),
                    128 + 110 * np.sin((x + 2 * y) / 53 + seed),
                    128 + 90 * np.cos((x - y) / 41)], -1)
    img += rng.randn(h, w, 3) * 4
    return np.clip(img, 0, 255).astype(np.uint8)


def label_map(h, w, seed):
    rng = np.random.RandomState(seed)
    lab = np.zeros((h, w), np.uint8)
    for _ in range(4):
        c = rng.randint(1, 21)
        y0, x0 = rng.randint(0, h - 80), rng.randint(0, w - 80)
        y1, x1 = y0 + rng.randint(40, 80), x0 + rng.randint(40, 80)
        lab[y0:y1, x0:x1] = 255          # the object's border: ignored
        lab[y0 + 3:y1 - 3, x0 + 3:x1 - 3] = c
    return lab


def voc_palette():
    pal = np.zeros((256, 3), np.uint8)
    for i in range(256):
        c, r, g, b = i, 0, 0, 0
        for j in range(8):
            r |= ((c >> 0) & 1) << (7 - j)
            g |= ((c >> 1) & 1) << (7 - j)
            b |= ((c >> 2) & 1) << (7 - j)
            c >>= 3
        pal[i] = (r, g, b)
    return pal


# Adam7: (first column, first row, column step, row step) of each pass
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
         (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))
CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}     # PNG colour type -> channels


def packed_rows(samples, depth):
    """(H, W, C) samples as PNG's packed rows (H, ceil(W * C * depth / 8))
    uint8: 16-bit big-endian, sub-byte samples from the high bits on."""
    h, w, c = samples.shape
    flat = np.asarray(samples).reshape(h, w * c)
    if depth == 16:
        return flat.astype(">u2").view(np.uint8).reshape(h, 2 * w * c)
    if depth == 8:
        return flat.astype(np.uint8)
    per = 8 // depth
    flat = np.pad(flat.astype(np.uint8), ((0, 0), (0, -(w * c) % per)))
    shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)
    return (flat.reshape(h, -1, per) << shifts).sum(-1, dtype=np.uint8)


def encode_png(samples, depth=8, ctype=0, interlace=False, palette=None,
               filters=(0, 1, 2, 3, 4)):
    """A PNG file's bytes: ``samples`` (H, W, channels of ``ctype``) at
    ``depth`` bits, with ``palette`` ((N, 3) uint8) for colour type 3;
    interlaced by Adam7, each pass filtered on its own, where asked; the
    rows filtered in turn by the types ``filters`` at byte distance
    ``max(1, channels * depth / 8)``."""
    samples = np.asarray(samples)
    h, w = samples.shape[:2]
    samples = samples.reshape(h, w, CHANNELS[ctype])
    bpp = max(1, CHANNELS[ctype] * depth // 8)
    if interlace:
        passes = [samples[y0::dy, x0::dx] for x0, y0, dx, dy in ADAM7]
        raw = b"".join(
            png_filtered_rows(packed_rows(p, depth), bpp, filters).tobytes()
            for p in passes if p.shape[0] and p.shape[1])
    else:
        raw = png_filtered_rows(packed_rows(samples, depth), bpp,
                                filters).tobytes()

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    out = [b"\x89PNG\r\n\x1a\n",
           chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0,
                                      int(bool(interlace))))]
    if palette is not None:
        out.append(chunk(b"PLTE", np.asarray(palette, np.uint8).tobytes()))
    out += [chunk(b"IDAT", zlib.compress(raw, 9)), chunk(b"IEND", b"")]
    return b"".join(out)


FIXTURES = {
    "voc_500x375.jpg": lambda p: Image.fromarray(smooth(375, 500, 1)).save(
        p, quality=85, subsampling=2),
    "voc_375x500.jpg": lambda p: Image.fromarray(smooth(500, 375, 2)).save(
        p, quality=85, subsampling=2),
    "coco_640x480.jpg": lambda p: Image.fromarray(smooth(480, 640, 3)).save(
        p, quality=90),
    "gray_200x150.jpg": lambda p: Image.fromarray(
        smooth(150, 200, 4)[..., 1]).save(p, quality=80),
    "restart_333x257.jpg": lambda p: Image.fromarray(
        smooth(257, 333, 5)).save(p, quality=75, subsampling=1,
                                  restart_marker_rows=1),
    "progressive_500x375.jpg": lambda p: Image.fromarray(
        smooth(375, 500, 7)).save(p, quality=85, subsampling=2,
                                  progressive=True),
    "cmyk_320x240.jpg": lambda p: Image.fromarray(
        smooth(240, 320, 8)).convert("CMYK").save(p, quality=80),
}


def scan_starts(data):
    """The offsets of the SOS markers of a JPEG's scans, in order."""
    out, i = [], 2
    while i < len(data) and data[i + 1] != 0xD9:
        start = i
        i += 2 + ((data[i + 2] << 8) | data[i + 3])
        if data[start + 1] == 0xDA:
            out.append(start)
            while not (data[i] == 0xFF and data[i + 1] != 0
                       and not 0xD0 <= data[i + 1] <= 0xD7):
                i += 1
    return out


def cut_after_scans(data, n):
    """The first ``n`` scans of a JPEG, then its end-of-image marker: a
    progressive file that ends early, which libjpeg block-smooths."""
    return data[:scan_starts(data)[n]] + b"\xff\xd9"


def early_end(h, w, seed, n):
    def write(p):
        buf = io.BytesIO()
        Image.fromarray(smooth(h, w, seed)).save(buf, "JPEG", quality=85,
                                                 subsampling=2,
                                                 progressive=True)
        with open(p, "wb") as f:
            f.write(cut_after_scans(buf.getvalue(), n))
    return write


def write_bytes(data):
    def write(p):
        with open(p, "wb") as f:
            f.write(data)
    return write


def write_label(p):
    im = Image.fromarray(label_map(375, 500, 6), mode="P")
    im.putpalette(voc_palette().tobytes())
    im.save(p)


FIXTURES["label_500x375.png"] = write_label
# progressive files that end early, which libjpeg block-smooths: after the
# DC scans alone (the DC too is smoothed), and before the last scan (the
# luma AC refinement)
FIXTURES["dc_only_500x375.jpg"] = early_end(375, 500, 11, 1)
FIXTURES["early_end_500x375.jpg"] = early_end(375, 500, 12, 9)
# the VOC label map again, interlaced; a 16-bit gray label map whose high
# byte PIL's uint8 cast drops
FIXTURES["adam7_label_500x375.png"] = write_bytes(encode_png(
    label_map(375, 500, 9), 8, 3, interlace=True, palette=voc_palette()))
FIXTURES["gray16_label_200x150.png"] = write_bytes(encode_png(
    label_map(150, 200, 10).astype(np.uint16) | 0x1200, 16, 0))


def decoded(path):
    if path.endswith(".png"):
        return np.asarray(Image.open(path), np.uint8)
    return np.asarray(Image.open(path).convert("RGB"))


def manifest():
    out = {}
    for name in sorted(FIXTURES):
        a = decoded(os.path.join(HERE, name))
        out[name] = {"shape": list(a.shape),
                     "sha256": hashlib.sha256(a.tobytes()).hexdigest()}
    return out


if __name__ == "__main__":
    for name, write in FIXTURES.items():
        write(os.path.join(HERE, name))
    with open(os.path.join(HERE, "manifest.json"), "w") as f:
        json.dump(manifest(), f, indent=1, sort_keys=True)
        f.write("\n")
