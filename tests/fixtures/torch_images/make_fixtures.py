"""Write the image fixtures of ``tests/test_torch_imread.py`` and
``chip_smoke.py --only data`` with PIL, and their manifest: the sha256 of
PIL's decoded bytes (``np.asarray(Image.open(p).convert("RGB"))`` for an
image, ``np.asarray(Image.open(p), np.uint8)`` for a label map).

    python tests/fixtures/torch_images/make_fixtures.py

The content is smooth and synthetic: sines over the image plane, a little
seeded noise, and for the label maps class rectangles with 255 borders.
PIL writes no interlaced and no 16-bit colour PNG, so :func:`encode_png`, a
small numpy encoder, writes those (any colour type and bit depth, Adam7 or
not); it writes no arithmetic-coded or lossless JPEG either, so
``jpeg_arith_writer.c``, built with the system's ``cc`` against its libjpeg
(:func:`build_arith_writer`, :func:`arith_jpeg`), writes the first and
:func:`encode_lossless_jpeg`, a numpy encoder, the second. The tests use
all three.
"""
import hashlib
import heapq
import io
import json
import os
import struct
import subprocess
import sys
import tempfile
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


ARITH_WRITER = os.path.join(HERE, "jpeg_arith_writer.c")


def jpeglib_missing():
    """Why the arithmetic writer cannot be built here (no C compiler, or no
    ``jpeglib.h``), or None."""
    try:
        done = subprocess.run(["cc", "-E", "-x", "c", "-"], input=(
            "#include <stdio.h>\n#include <jpeglib.h>\n"), text=True,
            capture_output=True, timeout=60)
    except OSError as e:
        return f"no C compiler ({e})"
    if done.returncode != 0:
        return "jpeglib.h is missing: " + done.stderr.strip()[:200]
    return None


def build_arith_writer(out_dir):
    """``jpeg_arith_writer.c`` compiled with ``cc ... -ljpeg`` into
    ``out_dir``; returns the program's path."""
    exe = os.path.join(out_dir, "jpeg_arith_writer")
    subprocess.run(["cc", "-O1", "-o", exe, ARITH_WRITER, "-ljpeg"],
                   check=True, capture_output=True, timeout=120)
    return exe


SPACES = {1: "gray", 3: "ycc", 4: "cmyk"}


def arith_jpeg(writer, samples, space=None, **opts):
    """The bytes of an arithmetic-coded JPEG of ``samples`` ((H, W) gray,
    (H, W, 3) or (H, W, 4)) written by the program ``writer`` (see
    ``jpeg_arith_writer.c`` for ``space`` and the keys of ``opts``)."""
    samples = np.ascontiguousarray(samples, np.uint8)
    h, w = samples.shape[:2]
    channels = 1 if samples.ndim == 2 else samples.shape[2]
    space = space or SPACES[channels]
    with tempfile.TemporaryDirectory() as tmp:
        raw, out = os.path.join(tmp, "in.raw"), os.path.join(tmp, "out.jpg")
        samples.tofile(raw)
        subprocess.run([writer, raw, out, str(w), str(h), space]
                       + [f"{k}={v}" for k, v in opts.items()],
                       check=True, capture_output=True, timeout=60)
        with open(out, "rb") as f:
            return f.read()


# lossless JPEG's seven predictors of a sample from the one to its left
# (a), above (b) and above-left (c)
PREDICTORS = {1: lambda a, b, c: a, 2: lambda a, b, c: b,
              3: lambda a, b, c: c, 4: lambda a, b, c: a + b - c,
              5: lambda a, b, c: a + ((b - c) >> 1),
              6: lambda a, b, c: b + ((a - c) >> 1),
              7: lambda a, b, c: (a + b) >> 1}


def lossless_differences(plane, predictor, pt, first_rows):
    """The differences (int64, -32767..32768) of a plane of samples already
    shifted by ``pt``: the rows where ``first_rows`` is set are predicted
    from the left, their first sample from 1 << (7 - pt); the first column
    of the others from above. Lossless, so every prediction reads the
    samples themselves."""
    p = plane.astype(np.int64)
    a, b, c = np.zeros_like(p), np.zeros_like(p), np.zeros_like(p)
    a[:, 1:] = p[:, :-1]
    b[1:] = p[:-1]
    c[1:, 1:] = p[:-1, :-1]
    pred = PREDICTORS[predictor](a, b, c)
    pred[:, 0] = b[:, 0]
    pred[first_rows, 1:] = a[first_rows, 1:]
    pred[first_rows, 0] = 1 << (8 - pt - 1)
    d = (p - pred) & 0xFFFF
    return np.where(d > 0x8000, d - 0x10000, d)


def _categories(d):
    a = np.abs(d)
    return np.where(a > 0, np.floor(np.log2(np.maximum(a, 1))) + 1,
                    0).astype(np.int64)


def huffman_code(counts):
    """{symbol: (code, length)} of a Huffman code for the symbols of
    nonzero ``counts``, and the DHT body's 16 length counts and values; a
    reserved symbol of the least count takes the all-ones code, which JPEG
    forbids."""
    syms = [s for s in range(len(counts)) if counts[s]] + [-1]
    depth = dict.fromkeys(syms, 0)
    heap = [(int(counts[s]) if s >= 0 else 0, i, [s])
            for i, s in enumerate(syms)]
    heapq.heapify(heap)
    n = len(heap)
    while len(heap) > 1:
        a, b = heapq.heappop(heap), heapq.heappop(heap)
        for s in a[2] + b[2]:
            depth[s] += 1
        heapq.heappush(heap, (a[0] + b[0], n, a[2] + b[2]))
        n += 1
    order = sorted(syms, key=lambda s: (depth[s], s < 0, s))
    codes, code, prev = {}, -1, depth[order[0]]
    bits = [0] * 16
    for s in order:
        code = (code + 1) << (depth[s] - prev)
        prev = depth[s]
        if s >= 0:
            codes[s] = (code, depth[s])
            bits[depth[s] - 1] += 1
    return codes, bits, [s for s in order if s >= 0]


def _entropy_bytes(diffs, tables):
    """Differences (N, K) coded column k with the code ``tables[k]``,
    padded with ones, 0xFF bytes stuffed."""
    s = _categories(diffs)
    code = np.zeros(diffs.shape, np.uint64)
    length = np.zeros(diffs.shape, np.int64)
    for k, codes in enumerate(tables):
        table = np.array([codes.get(i, (0, 0)) for i in range(17)])
        code[:, k] = table[s[:, k], 0].astype(np.uint64)
        length[:, k] = table[s[:, k], 1]
    extra_n = np.where(s == 16, 0, s)
    extra = np.where(diffs >= 0, diffs, diffs - 1) & ((1 << extra_n) - 1)
    word = ((code << extra_n.astype(np.uint64)) | extra.astype(np.uint64))
    n = (length + extra_n).ravel()
    word = (word.ravel() << (64 - n).astype(np.uint64)).astype(">u8")
    bits = np.unpackbits(word.view(np.uint8).reshape(-1, 8), axis=1)
    bits = bits[np.arange(64)[None, :] < n[:, None]]
    bits = np.concatenate([bits, np.ones(-len(bits) % 8, np.uint8)])
    out = np.packbits(bits)
    return np.insert(out, np.flatnonzero(out == 0xFF) + 1, 0).tobytes()


def _segment(marker, body):
    return bytes([0xFF, marker]) + struct.pack(">H", 2 + len(body)) + body


def encode_lossless_jpeg(samples, predictor=1, pt=0, sampling=None,
                         restart_rows=0, jfif=False, adobe=None,
                         one_scan=True):
    """A lossless Huffman JPEG's bytes (SOF3, 8-bit): ``samples`` (H, W) or
    (H, W, C) with component ids 1..C, component c taken every
    ``vmax / v`` rows and ``hmax / h`` columns of ``sampling`` ((h, v) per
    component); ``predictor`` 1-7 (or one per scan) and point transform
    ``pt``; one interleaved scan, or one per component; a restart every
    ``restart_rows`` MCU rows of each scan (a DRI before each); a JFIF
    marker, or an Adobe marker of transform ``adobe``. Component 0 codes
    with Huffman table 0, the others with table 1, each built from its
    differences. Vectorised: a 500x375 file takes well under a second."""
    samples = np.asarray(samples, np.uint8)
    if samples.ndim == 2:
        samples = samples[..., None]
    h, w, nc = samples.shape
    sampling = list(sampling or [(1, 1)] * nc)
    hmax = max(f[0] for f in sampling)
    vmax = max(f[1] for f in sampling)
    planes = [samples[::vmax // v, ::hmax // fh, c] >> pt
              for c, (fh, v) in enumerate(sampling)]
    scans = ([list(range(nc))] if one_scan or nc == 1
             else [[c] for c in range(nc)])
    predictors = (list(predictor) if np.ndim(predictor)
                  else [predictor] * len(scans))
    coded = []                    # (components, predictor, MCUs, per row)
    for comps, psv in zip(scans, predictors):
        inter = len(comps) > 1
        mcu_w = -(-w // hmax) if inter else planes[comps[0]].shape[1]
        mcu_h = -(-h // vmax) if inter else planes[comps[0]].shape[0]
        cols = []
        for c in comps:
            fh, v = sampling[c] if inter else (1, 1)
            p = planes[c]
            p = np.pad(p, ((0, mcu_h * v - p.shape[0]),
                           (0, mcu_w * fh - p.shape[1])), mode="edge")
            rows = np.arange(p.shape[0])
            first = (rows % v == 0) & ((rows // v) % (restart_rows or mcu_h)
                                       == 0)
            d = lossless_differences(p, psv, pt, first)
            cols.append(d.reshape(mcu_h, v, mcu_w, fh).transpose(0, 2, 1, 3)
                        .reshape(mcu_h, mcu_w, v * fh))
        coded.append((comps, psv, np.concatenate(cols, -1), mcu_w))
    counts = np.zeros((2, 17), np.int64)
    table_of = [min(c, 1) for c in range(nc)]
    for comps, _, d, _ in coded:
        at = 0
        for c in comps:
            n = d.shape[-1] if len(comps) == 1 else (
                sampling[c][0] * sampling[c][1])
            counts[table_of[c]] += np.bincount(
                _categories(d[..., at:at + n]).ravel(), minlength=17)
            at += n
    codes, dht = {}, b""
    for t in (0, 1):
        if counts[t].any():
            codes[t], bits, vals = huffman_code(counts[t])
            dht += bytes([t] + bits + vals)
    out = [b"\xff\xd8"]
    if jfif:
        out.append(_segment(0xE0, b"JFIF\0\x01\x01\0\0\x01\0\x01\0\0"))
    if adobe is not None:
        out.append(_segment(0xEE, b"Adobe\0\x64\0\0\0\0" + bytes([adobe])))
    out.append(_segment(0xC4, dht))
    out.append(_segment(0xC3, struct.pack(">BHHB", 8, h, w, nc) + b"".join(
        bytes([c + 1, (sampling[c][0] << 4) | sampling[c][1], 0])
        for c in range(nc))))
    for comps, psv, d, mcu_w in coded:
        if restart_rows:
            out.append(_segment(0xDD, struct.pack(">H",
                                                  restart_rows * mcu_w)))
        out.append(_segment(0xDA, bytes([len(comps)]) + b"".join(
            bytes([c + 1, table_of[c] << 4]) for c in comps)
            + bytes([psv, 0, pt])))
        tables = [codes[table_of[c]] for c in comps
                  for _ in range(d.shape[-1] if len(comps) == 1
                                 else sampling[c][0] * sampling[c][1])]
        step = restart_rows or d.shape[0]
        for k, r in enumerate(range(0, d.shape[0], step)):
            if k:
                out.append(bytes([0xFF, 0xD0 + (k - 1) % 8]))
            out.append(_entropy_bytes(
                d[r:r + step].reshape(-1, d.shape[-1]), tables))
    out.append(b"\xff\xd9")
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


def arith_fixture(h, w, seed, **opts):
    def write(p):
        if not hasattr(arith_fixture, "writer"):
            arith_fixture.writer = build_arith_writer(tempfile.mkdtemp())
        with open(p, "wb") as f:
            f.write(arith_jpeg(arith_fixture.writer, smooth(h, w, seed),
                               **opts))
    return write


# arithmetic-coded JPEGs (SOF9 4:2:0 with a restart every 32 MCUs; SOF10
# with libjpeg's simple progression) and a lossless one (SOF3 4:2:0, a
# scan per component with predictors 1, 4 and 7, Pt 2, restarts), at VOC's
# sizes; PIL reads all three
FIXTURES["arith_500x375.jpg"] = arith_fixture(375, 500, 13, q=85,
                                              s="2x2,1x1,1x1", ri=32)
FIXTURES["arith_progressive_375x500.jpg"] = arith_fixture(
    500, 375, 14, q=85, s="2x2,1x1,1x1", prog=1)
FIXTURES["lossless_500x375.jpg"] = write_bytes(encode_lossless_jpeg(
    smooth(375, 500, 15), predictor=(1, 4, 7), pt=2,
    sampling=[(2, 2), (1, 1), (1, 1)], restart_rows=16, one_scan=False))


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
