"""Image files into arrays without PIL or OpenCV: the counterpart of what
``afan``'s data pipelines call, ``Image.open(p).convert("RGB")`` for images
and ``np.asarray(Image.open(p), np.uint8)`` for label maps, giving the same
bytes (the machine with the card has neither library).

- **PNG**: the chunks are parsed here (each CRC checked), the image data
  inflated with :mod:`zlib`, and the rows unfiltered by the host library
  ``csrc/imdecode.cpp``, each of Adam7's seven passes on its own when the
  file is interlaced. Every colour type at every depth PNG allows is read
  (gray at 1, 2, 4, 8 and 16 bits, palette at 1 to 8, RGB, gray+alpha and
  RGBA at 8 and 16), with Pillow's conversions: for RGB the alpha is
  dropped, the palette looked up, the gray channel repeated; 16-bit colour
  keeps its high byte, 16-bit gray is clipped to 255 (``I;16`` to RGB),
  and 1-, 2- and 4-bit gray scale to 0..255 (1-bit by 255, as mode ``1``).
  A label map is the gray values or palette indices: 16-bit gray keeps its
  low byte (numpy's cast of ``I;16``), 1-bit gray is 0/1 (mode ``1``), 2-
  and 4-bit gray scale by 85 and 17 (mode ``L``).
- **JPEG**: baseline, extended-sequential and progressive, Huffman- or
  arithmetic-coded (SOF0-2, SOF9-10, with the DAC marker's conditioning),
  and lossless Huffman (SOF3: the seven predictors, point transforms,
  interleaved scans or one per component), 8-bit, gray, three components
  or four (CMYK, or YCCK under Adobe's transform 2) at any integral
  sampling, decoded entirely by ``csrc/imdecode.cpp`` with libjpeg-turbo's
  integer IDCT, upsampling (replication in a lossless file) and YCbCr table
  (Pillow's JPEG codec), and Pillow's inverted CMYK and its ``cmyk2rgb``;
  restart intervals, byte stuffing and fill bytes are handled, Adobe's
  transform 0 means RGB (as does a lossless file with neither JFIF nor
  Adobe marker), a gray JPEG repeats its channel, and no EXIF rotation is
  applied. A progressive file that ends after a complete scan, its first
  ten coefficients not all complete, is block-smoothed as libjpeg-turbo
  does (``jdcoefct.c``). An arithmetic-coded file whose scan spans more
  than one of Pillow's 64 KiB reads, which Pillow refuses (libjpeg's
  arithmetic decoder cannot wait for more input), is read whole.

Anything else raises a :class:`ValueError` that names the file and what it
met, and each JPEG kind refused is one Pillow refuses too: hierarchical
JPEG (SOF5-7, SOF13-15), lossless arithmetic coding (SOF11), lossless
YCbCr or YCCK (libjpeg-turbo converts no colours in lossless mode), samples
of other than 8 bits, a height of 0 (DNL), fractional sampling ratios, a
progression that breaks libjpeg's order, a lossless restart interval that
is not a whole number of MCU rows; truncated (inside a scan) or corrupt
data. The library is compiled with ``c++`` into ``build/host/`` at
first use (:func:`afan_torch.ops.kernels.build.build_host`) and bound with
:mod:`ctypes`, which releases the GIL during a call, so a prefetch thread
decodes while the main thread runs the step.
"""
from __future__ import annotations

import ctypes
import struct
import threading
import zlib
from typing import Optional, Tuple

import numpy as np

from ..ops.kernels.build import build_host

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# PNG colour type -> (name, channels, the bit depths PNG allows)
PNG_COLOR_TYPES = {0: ("gray", 1, (1, 2, 4, 8, 16)), 2: ("RGB", 3, (8, 16)),
                   3: ("palette", 1, (1, 2, 4, 8)),
                   4: ("gray+alpha", 2, (8, 16)), 6: ("RGBA", 4, (8, 16))}
# Adam7: (first column, first row, column step, row step) of each pass
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
         (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))
# 1-, 2- and 4-bit gray to 8 bits (mode ``L``): v * 255 / (2^depth - 1)
_GRAY_SCALE = {1: 255, 2: 85, 4: 17}
_ERR_LEN = 256

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()


def load_library() -> ctypes.CDLL:
    """Build (at first use) and bind ``csrc/imdecode.cpp``."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build_host("imdecode.cpp"))
            lib.afan_png_unfilter.restype = ctypes.c_int
            lib.afan_png_unfilter.argtypes = [
                ctypes.c_char_p, ctypes.c_int64, ctypes.c_int32,
                ctypes.c_int32, ctypes.c_int32, ctypes.c_void_p,
                ctypes.c_char_p, ctypes.c_int32]
            lib.afan_jpeg_header.restype = ctypes.c_int
            lib.afan_jpeg_header.argtypes = [
                ctypes.c_char_p, ctypes.c_int64, ctypes.c_void_p,
                ctypes.c_char_p, ctypes.c_int32]
            lib.afan_jpeg_decode_rgb.restype = ctypes.c_int
            lib.afan_jpeg_decode_rgb.argtypes = [
                ctypes.c_char_p, ctypes.c_int64, ctypes.c_void_p,
                ctypes.c_int64, ctypes.c_char_p, ctypes.c_int32]
            _lib = lib
    return _lib


def _read(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def _png_chunks(data: bytes, path: str):
    pos = len(PNG_SIGNATURE)
    while True:
        if pos + 8 > len(data):
            raise ValueError(f"{path}: truncated PNG (no IEND chunk)")
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        end = pos + 12 + length
        if end > len(data):
            raise ValueError(f"{path}: truncated PNG in a {kind!r} chunk")
        body = data[pos + 8:pos + 8 + length]
        (crc,) = struct.unpack(">I", data[end - 4:end])
        if zlib.crc32(kind + body) != crc:
            raise ValueError(f"{path}: broken PNG ({kind!r} checksum)")
        yield kind, body
        if kind == b"IEND":
            return
        pos = end


def _unfilter(raw: bytes, width: int, height: int, depth: int,
              channels: int, path: str) -> np.ndarray:
    """The first ``height`` filtered rows of ``raw``, unfiltered and
    unpacked: (height, width, channels) samples, uint16 at 16 bits, else
    uint8."""
    bits = depth * channels
    stride = (width * bits + 7) // 8
    rows = np.empty((height, stride), np.uint8)
    err = ctypes.create_string_buffer(_ERR_LEN)
    if load_library().afan_png_unfilter(raw, len(raw), width, height, bits,
                                        rows.ctypes.data, err, _ERR_LEN):
        raise ValueError(f"{path}: {err.value.decode()}")
    if depth == 8:
        return rows.reshape(height, width, channels)
    if depth == 16:
        return rows.view(">u2").astype(np.uint16).reshape(height, width,
                                                          channels)
    per_byte = 8 // depth                         # gray or palette samples
    shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)
    samples = (rows[:, :, None] >> shifts) & ((1 << depth) - 1)
    return samples.reshape(height, stride * per_byte)[:, :width, None]


def _png(data: bytes, path: str) -> Tuple[int, int, np.ndarray,
                                          Optional[bytes]]:
    """(colour type, bit depth, samples (H, W, channels), PLTE or None);
    the samples are uint16 at 16 bits, else uint8 (sub-byte ones
    unscaled)."""
    header, palette, idat = None, None, []
    for kind, body in _png_chunks(data, path):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body[:13])
        elif kind == b"PLTE":
            palette = body
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError(f"{path}: PNG without an IHDR chunk")
    width, height, depth, ctype, _, _, interlace = header
    if ctype not in PNG_COLOR_TYPES:
        raise ValueError(f"{path}: unknown PNG colour type {ctype}")
    _, channels, depths = PNG_COLOR_TYPES[ctype]
    if depth not in depths:
        raise ValueError(f"{path}: a bit depth of {depth} is not valid for "
                         f"{PNG_COLOR_TYPES[ctype][0]} PNG")
    if interlace > 1:
        raise ValueError(f"{path}: unknown PNG interlace method {interlace}")
    if ctype == 3 and palette is None:
        raise ValueError(f"{path}: palette PNG without a PLTE chunk")
    inflater = zlib.decompressobj()
    try:
        raw = inflater.decompress(b"".join(idat))
    except zlib.error as e:
        raise ValueError(f"{path}: corrupt PNG image data ({e})") from None
    if not inflater.eof:
        raise ValueError(f"{path}: truncated PNG image data")
    if not interlace:
        px = _unfilter(raw, width, height, depth, channels, path)
        return ctype, depth, px, palette
    # Adam7: each pass unfiltered on its own at its own width (a pass with
    # no column or no row has no bytes), then scattered into the image
    px = np.empty((height, width, channels),
                  np.uint16 if depth == 16 else np.uint8)
    offset = 0
    for x0, y0, dx, dy in ADAM7:
        w, h = -(-(width - x0) // dx), -(-(height - y0) // dy)
        if w <= 0 or h <= 0:
            continue
        size = h * (1 + (w * depth * channels + 7) // 8)
        if offset + size > len(raw):
            raise ValueError(f"{path}: truncated image data: {len(raw)} "
                             f"bytes inflated, more needed by Adam7's "
                             f"passes")
        px[y0::dy, x0::dx] = _unfilter(raw[offset:offset + size], w, h,
                                       depth, channels, path)
        offset += size
    return ctype, depth, px, palette


def _palette_table(palette: bytes) -> np.ndarray:
    """PLTE as a 256-entry RGB table; Pillow reads an index past the
    palette's end as black."""
    table = np.zeros((256, 3), np.uint8)
    entries = np.frombuffer(palette[:len(palette) // 3 * 3], np.uint8)
    entries = entries.reshape(-1, 3)[:256]
    table[:len(entries)] = entries
    return table


def _jpeg_rgb(data: bytes, path: str) -> np.ndarray:
    lib = load_library()
    err = ctypes.create_string_buffer(_ERR_LEN)
    info = np.zeros(3, np.int32)
    if lib.afan_jpeg_header(data, len(data), info.ctypes.data, err, _ERR_LEN):
        raise ValueError(f"{path}: {err.value.decode()}")
    width, height = int(info[0]), int(info[1])
    out = np.empty((height, width, 3), np.uint8)
    if lib.afan_jpeg_decode_rgb(data, len(data), out.ctypes.data, out.size,
                                err, _ERR_LEN):
        raise ValueError(f"{path}: {err.value.decode()}")
    return out


def read_rgb(path: str) -> np.ndarray:
    """``np.asarray(Image.open(path).convert("RGB"))``: (H, W, 3) uint8 of a
    PNG or JPEG file."""
    data = _read(path)
    if data.startswith(PNG_SIGNATURE):
        ctype, depth, px, palette = _png(data, path)
        if ctype == 3:
            return _palette_table(palette)[px[..., 0]]
        if depth == 16:
            if ctype == 0:                              # I;16 -> RGB clips
                px = np.minimum(px, 255)
            else:                                       # RGB;16B, LA;16B...
                px = px >> 8
            px = px.astype(np.uint8)
        elif depth < 8:
            px = px * np.uint8(_GRAY_SCALE[depth])
        if ctype in (0, 4):
            return np.repeat(px[..., :1], 3, axis=2)
        return np.ascontiguousarray(px[..., :3])
    if data.startswith(b"\xff\xd8"):
        return _jpeg_rgb(data, path)
    raise ValueError(f"{path}: neither a PNG nor a JPEG file")


def read_png_size(path: str) -> Tuple[int, int]:
    """(H, W) of a PNG file from its IHDR chunk, the first one (the file is
    not decoded)."""
    with open(path, "rb") as f:
        head = f.read(len(PNG_SIGNATURE) + 16)
    if (len(head) < len(PNG_SIGNATURE) + 16
            or not head.startswith(PNG_SIGNATURE)
            or head[len(PNG_SIGNATURE) + 4:len(PNG_SIGNATURE) + 8] != b"IHDR"):
        raise ValueError(f"{path}: not a PNG file with an IHDR chunk")
    width, height = struct.unpack(">II", head[len(PNG_SIGNATURE) + 8:])
    return height, width


def read_label(path: str) -> np.ndarray:
    """``np.asarray(Image.open(path), np.uint8)`` of a label map: (H, W)
    uint8, the values of a gray PNG (16-bit: the low byte; 1-bit: 0/1; 2-
    and 4-bit: scaled to 0..255) or the indices of a palette PNG (any
    ``tRNS`` chunk ignored)."""
    data = _read(path)
    if not data.startswith(PNG_SIGNATURE):
        raise ValueError(f"{path}: a label map must be a PNG file")
    ctype, depth, px, _ = _png(data, path)
    if ctype not in (0, 3):
        raise ValueError(f"{path}: a label map must be a gray or palette "
                         f"PNG, not {PNG_COLOR_TYPES[ctype][0]}")
    label = px[..., 0]
    if depth == 16:
        return label.astype(np.uint8)                   # numpy wraps
    if ctype == 0 and depth in (2, 4):
        return label * np.uint8(_GRAY_SCALE[depth])
    return label
