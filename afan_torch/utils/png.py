"""8-bit RGB and RGBA PNG files, written with the standard library alone
(``zlib`` and ``struct``), with ``matplotlib.pyplot.imsave``'s rules for
turning an array into bytes — the machine with the card has neither PIL nor
matplotlib, and ``afan`` writes its images through both.

:func:`write_png` writes a ``(H, W, 3)`` or ``(H, W, 4)`` uint8 array as it
is: a PIL ``Image.fromarray(a).save(path)`` of the same array decodes to the
same pixels. :func:`imsave` is ``plt.imsave(path, arr, cmap="viridis")``
for the two cases ``afan`` uses (matplotlib 3.10, ``image.imsave`` →
``Colorizer.to_rgba(arr, bytes=True)``):

* a float RGB image in [0, 1]: alpha 1 appended, multiplied by 255 in its
  own dtype and truncated to uint8, a pixel with a NaN made (0, 0, 0, 0); a
  value outside [0, 1] raises, as in matplotlib;
* a 2-D array through viridis: ``Normalize`` to the array's min and max
  (``x - vmin``, then ``/ (vmax - vmin)``, each in float64 and rounded back
  to the array's float dtype; an array whose min equals its max maps to 0),
  times the colormap's 256 entries, 256 itself taken as 255, truncated to an
  index; below 0 is the first colour, 256 and above the last, NaN
  transparent black.

Both write RGBA, as matplotlib does. Viridis is kept here as its 256 RGB
bytes (``(matplotlib.colormaps["viridis"]._lut * 255).astype(uint8)``).
"""
from __future__ import annotations

import os
import struct
import zlib

import numpy as np

_VIRIDIS_HEX = (
    "44015444025544035745055845065a45085b46095c460b5e460c5f460e61470f62471163"
    "47126547146647156747166947186a48196b481a6c481c6e481d6f481e70482071482172"
    "482273482374472575472676472777472878472a79472b7a472c7b462d7c462f7c46307d"
    "46317e45327f45347f453580453681443781443982433a83433b83433c84423d84423e85"
    "4240854141864142864043874044873f45873f47883e48883e49893d4a893d4b893d4c89"
    "3c4d8a3c4e8a3b508a3b518a3a528b3a538b39548b39558b38568b38578c37588c37598c"
    "365a8c365b8c355c8c355d8c345e8d345f8d33608d33618d32628d32638d31648d31658d"
    "31668d30678d30688d2f698d2f6a8d2e6b8e2e6c8e2e6d8e2d6e8e2d6f8e2c708e2c718e"
    "2c728e2b738e2b748e2a758e2a768e2a778e29788e29798e287a8e287a8e287b8e277c8e"
    "277d8e277e8e267f8e26808e26818e25828e25838d24848d24858d24868d23878d23888d"
    "23898d22898d228a8d228b8d218c8d218d8c218e8c208f8c20908c20918c1f928c1f938b"
    "1f948b1f958b1f968b1e978a1e988a1e998a1e998a1e9a891e9b891e9c891e9d881e9e88"
    "1e9f881ea0871fa1871fa2861fa38620a48520a58521a68521a78422a78423a88323a982"
    "24aa8225ab8126ac8127ad8028ae7f29af7f2ab07e2bb17d2cb17d2eb27c2fb37b30b47a"
    "32b57a33b67935b77836b87738b97639b9763bba753dbb743ebc7340bd7242be7144be70"
    "45bf6f47c06e49c16d4bc26c4dc26b4fc36951c46853c56755c66657c66559c7645bc862"
    "5ec96160c96062ca5f64cb5d67cc5c69cc5b6bcd596dce5870ce5672cf5574d05477d052"
    "79d1517cd24f7ed24e81d34c83d34b86d44988d5478bd5468dd64490d64392d74195d73f"
    "97d83e9ad83c9dd93a9fd938a2da37a5da35a7db33aadb32addc30afdc2eb2dd2cb5dd2b"
    "b7dd29bade27bdde26bfdf24c2df22c5df21c7e01fcae01ecde01dcfe11cd2e11bd4e11a"
    "d7e219dae218dce218dfe318e1e318e4e318e7e419e9e419ece41aeee51bf1e51cf3e51e"
    "f6e61ff8e621fae622fde724"
)
VIRIDIS = np.frombuffer(bytes.fromhex(_VIRIDIS_HEX), np.uint8).reshape(256, 3)


def voc_color_map(n: int = 256) -> np.ndarray:
    """The VOC segmentation palette (bit-shuffled), a copy of ``afan``'s
    `cli/eval_segment.py:voc_color_map`."""
    cmap = np.zeros((n, 3), np.uint8)
    for i in range(n):
        r = g = b = 0
        c = i
        for j in range(8):
            r |= ((c >> 0) & 1) << (7 - j)
            g |= ((c >> 1) & 1) << (7 - j)
            b |= ((c >> 2) & 1) << (7 - j)
            c >>= 3
        cmap[i] = (r, g, b)
    return cmap


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def write_png(path: str, pixels: np.ndarray) -> str:
    """Write ``(H, W, 3)`` (RGB) or ``(H, W, 4)`` (RGBA) uint8 ``pixels`` to
    ``path`` as an 8-bit, non-interlaced PNG; makes the parent directory."""
    a = np.ascontiguousarray(pixels)
    if a.dtype != np.uint8 or a.ndim != 3 or a.shape[2] not in (3, 4):
        raise ValueError(f"write_png takes (H, W, 3|4) uint8, got "
                         f"{a.shape} {a.dtype}")
    h, w, c = a.shape
    header = struct.pack(">IIBBBBB", w, h, 8, 2 if c == 3 else 6, 0, 0, 0)
    rows = np.concatenate([np.zeros((h, 1), np.uint8),   # filter: none
                           a.reshape(h, w * c)], axis=1)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", header)
                + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
                + _chunk(b"IEND", b""))
    return path


def rgb_to_rgba_bytes(image: np.ndarray) -> np.ndarray:
    """``plt.imsave``'s bytes of an ``(H, W, 3)`` float RGB image in
    [0, 1]."""
    x = np.asarray(image)
    if x.ndim != 3 or x.shape[2] != 3 or x.dtype.kind != "f":
        raise ValueError(f"an RGB image is (H, W, 3) float, got {x.shape} "
                         f"{x.dtype}")
    xx = np.empty(x.shape[:2] + (4,), x.dtype)
    xx[..., :3] = x
    xx[..., 3] = 1
    xx[np.isnan(x).any(axis=2)] = 0
    if xx.max() > 1 or xx.min() < 0:
        raise ValueError("Floating point image RGB values must be in the "
                         "0..1 range.")
    return (xx * 255).astype(np.uint8)


def colormap_bytes(values: np.ndarray) -> np.ndarray:
    """``plt.imsave``'s RGBA bytes of a 2-D array through viridis, scaled
    to the array's own min and max."""
    lut = VIRIDIS
    x = np.asarray(values)
    if x.ndim != 2:
        raise ValueError(f"a colormapped image is 2-D, got {x.shape}")
    dtype = x.dtype if x.dtype.kind == "f" else np.float64
    res = x.astype(dtype, copy=True)
    if res.size:
        vmin, vmax = float(x.min()), float(x.max())
        if vmin == vmax:
            res.fill(0)
        else:
            res = (res.astype(np.float64) - vmin).astype(dtype)
            res = (res.astype(np.float64) / (vmax - vmin)).astype(dtype)
    n = len(lut)
    xa = res * n
    xa[xa == n] = n - 1
    under, over, bad = xa < 0, xa >= n, np.isnan(xa)
    with np.errstate(invalid="ignore"):
        idx = xa.astype(int)
    idx[under] = n          # the first colour
    idx[over] = n + 1       # the last colour
    idx[bad] = n + 2        # transparent black
    table = np.concatenate([
        np.concatenate([lut, np.full((n, 1), 255, np.uint8)], axis=1),
        np.concatenate([lut[[0, n - 1]], np.full((2, 1), 255, np.uint8)],
                       axis=1),
        np.zeros((1, 4), np.uint8)])
    return table.take(idx, axis=0, mode="clip")


def imsave(path: str, arr: np.ndarray) -> str:
    """``plt.imsave(path, arr, cmap="viridis")`` for a PNG ``path``: an RGB
    image as it is, a 2-D array through viridis."""
    arr = np.asarray(arr)
    pixels = rgb_to_rgba_bytes(arr) if arr.ndim == 3 else colormap_bytes(arr)
    return write_png(path, pixels)
