"""Image files into arrays without PIL or OpenCV: the counterpart of what
``afan``'s data pipelines call, ``Image.open(p).convert("RGB")`` for images
and ``np.asarray(Image.open(p), np.uint8)`` for label maps, giving the same
bytes (the machine with the card has neither library).

- **PNG**: the chunks are parsed here (each CRC checked), the image data
  inflated with :mod:`zlib`, and the rows unfiltered by the host library
  ``csrc/imdecode.cpp``. 8-bit gray, RGB, palette, gray+alpha and RGBA
  images are read; for RGB the alpha is dropped, the palette looked up and
  the gray channel repeated, as ``convert("RGB")`` does.
- **JPEG**: baseline and extended-sequential Huffman (SOF0, SOF1), 8-bit,
  gray or three components with luma sampling 1x1, 2x1 or 2x2 over chroma
  1x1, decoded entirely by ``csrc/imdecode.cpp`` with libjpeg-turbo's
  integer IDCT, fancy upsampling and YCbCr table (Pillow's JPEG codec);
  restart intervals, byte stuffing and fill bytes are handled, Adobe's
  transform 0 means RGB, a gray JPEG repeats its channel, and no EXIF
  rotation is applied.

Anything else raises a :class:`ValueError` that names the file and what it
met: interlaced, 16-bit or sub-8-bit PNG; progressive, arithmetic-coded,
lossless, 12-bit, CMYK / YCCK or otherwise sampled JPEG; truncated or
corrupt data. The library is compiled with ``c++`` into ``build/host/`` at
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
# PNG colour type -> (name, bytes per pixel at 8 bits)
PNG_COLOR_TYPES = {0: ("gray", 1), 2: ("RGB", 3), 3: ("palette", 1),
                   4: ("gray+alpha", 2), 6: ("RGBA", 4)}
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


def _png(data: bytes, path: str) -> Tuple[int, np.ndarray, Optional[bytes]]:
    """(colour type, unfiltered pixels (H, W, bpp) uint8, PLTE or None)."""
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
    if depth == 16:
        raise ValueError(f"{path}: 16-bit PNG is not decoded")
    if depth != 8:
        raise ValueError(f"{path}: {depth}-bit PNG (below 8 bits) is not "
                         f"decoded")
    if interlace:
        raise ValueError(f"{path}: interlaced (Adam7) PNG is not decoded")
    if ctype == 3 and palette is None:
        raise ValueError(f"{path}: palette PNG without a PLTE chunk")
    inflater = zlib.decompressobj()
    try:
        raw = inflater.decompress(b"".join(idat))
    except zlib.error as e:
        raise ValueError(f"{path}: corrupt PNG image data ({e})") from None
    if not inflater.eof:
        raise ValueError(f"{path}: truncated PNG image data")
    bpp = PNG_COLOR_TYPES[ctype][1]
    out = np.empty((height, width, bpp), np.uint8)
    err = ctypes.create_string_buffer(_ERR_LEN)
    if load_library().afan_png_unfilter(raw, len(raw), width, height, bpp,
                                        out.ctypes.data, err, _ERR_LEN):
        raise ValueError(f"{path}: {err.value.decode()}")
    return ctype, out, palette


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
        ctype, px, palette = _png(data, path)
        if ctype == 3:
            return _palette_table(palette)[px[..., 0]]
        if ctype in (0, 4):
            return np.repeat(px[..., :1], 3, axis=2)
        return np.ascontiguousarray(px[..., :3])
    if data.startswith(b"\xff\xd8"):
        return _jpeg_rgb(data, path)
    raise ValueError(f"{path}: neither a PNG nor a JPEG file")


def read_label(path: str) -> np.ndarray:
    """``np.asarray(Image.open(path), np.uint8)`` of a label map: (H, W)
    uint8, the values of an 8-bit gray PNG or the indices of a palette PNG
    (any ``tRNS`` chunk ignored)."""
    data = _read(path)
    if not data.startswith(PNG_SIGNATURE):
        raise ValueError(f"{path}: a label map must be a PNG file")
    ctype, px, _ = _png(data, path)
    if ctype not in (0, 3):
        raise ValueError(f"{path}: a label map must be an 8-bit gray or "
                         f"palette PNG, not {PNG_COLOR_TYPES[ctype][0]}")
    return px[..., 0]
