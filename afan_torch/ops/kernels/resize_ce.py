"""Fused bilinear upsample + masked cross-entropy on the card: the wrappers
around ``csrc/resize_ce.cu``.

The CUDA source replaces the Pallas TPU kernels
``afan/ops/kernels/resize_ce_kernel.py:_fwd_kernel`` and ``:_bwd_kernel``;
its header says what bounds them and how they are laid out. It is compiled
with ``nvcc`` for ``sm_90a`` at first use (:mod:`.build`) and bound with
``ctypes``.

:func:`resize_ce_forward` returns the per-entry sums ``(B,)`` of the
255-masked CE (or focal) loss of the ``align_corners=False`` bilinear
upsample of logits ``(B, C, h, w)`` to the labels' ``(H, W)``, one block
per (three output rows, entry) holding the rows' H-interpolated logits in
shared memory; :func:`resize_ce_backward` returns ``d(sum_b g[b] * sums[b]) / d
lo`` by the band kernel, one block per (band of ``BAND_ROWS`` low-res rows,
one of ``COL_SPLITS`` column ranges, entry), laid out by
:func:`band_plan`. Each takes CUDA tensors only, and launches its kernel or
raises; the choice of the plain PyTorch version for a CPU tensor is made
once, in :func:`afan_torch.ops.resize_ce.fused_resize_nll_sums`. The logits
may be float32 or bfloat16: the sums are float32 either way, and the
gradient has the logits' dtype.

Both take a row ``window = (hg, Hg, y0, Y0)`` (a row-sharded step): the
logits are the rows [y0, y0 + h) of a map of ``hg`` rows and the labels
the output rows [Y0, Y0 + H) of its upsample to ``Hg`` rows; each output
row takes its global row's taps. The default is the whole map, ``(h, H, 0,
0)``, on which the kernels are what they were without a window, bit for
bit.
"""
from __future__ import annotations

import ctypes
import functools
import threading
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ...models.deeplab.heads import source_taps
from .build import build

SMEM_LIMIT = 232448        # dynamic shared memory one block may use on sm_90
MAX_BATCH = 65535          # grid.y
# The band backward: low-res rows per band, and column ranges per band. Four
# rows make an output row's recompute (m + 1) / m = 1.25x; two column ranges
# put 4 * 48 * 2 = 384 blocks in the one wave of 3 x 132 slots at B = 4,
# 192 -> 768.
BAND_ROWS = 4
COL_SPLITS = 2

# Kernel launches since the last reset, those of them on bfloat16 logits,
# and those on a row window (and on bfloat16 logits); a run sets them to 0
# and reads them after.
fwd_launches = 0
bwd_launches = 0
bf16_fwd_launches = 0
bf16_bwd_launches = 0
window_fwd_launches = 0
window_bwd_launches = 0
bf16_window_fwd_launches = 0
bf16_window_bwd_launches = 0

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()

Focal = Optional[Tuple[float, float]]


def load_library() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build("resize_ce.cu"))
            focal = [ctypes.c_int, ctypes.c_float, ctypes.c_float]
            signatures = {
                "afan_resize_ce_fwd_smem": [ctypes.c_int] * 2,
                "afan_resize_ce_bwd_bands_smem": [ctypes.c_int] * 4,
                "afan_resize_ce_forward": [ctypes.c_void_p] * 2
                + [ctypes.c_int] * 11 + focal + [ctypes.c_void_p] * 3,
                "afan_resize_ce_backward": [ctypes.c_void_p] * 4
                + [ctypes.c_int] * 15 + focal + [ctypes.c_void_p] * 2,
                "afan_resize_ce_kernel_info": [ctypes.c_int] * 4
                + [ctypes.c_void_p],
            }
            for name, argtypes in signatures.items():
                fn = getattr(lib, name)
                fn.restype = ctypes.c_int
                fn.argtypes = argtypes
            _lib = lib
    return _lib


Window = Tuple[int, int, int, int]


def _touching(n_out: int, n_in: int, step: int, window=None):
    """Cut [0, n_in) into ranges of ``step``; for each, the output range
    that holds every output index with a non-zero weight on it, widened by
    one index on each side (the kernel skips exact zero weights). A range
    that no output index touches gets an empty output range. With a
    ``window = (n_in_g, n_out_g, in0, out0)`` the indices are those of a
    window: output ``i`` is the global ``out0 + i`` of a resize from
    ``n_in_g`` to ``n_out_g``, input ``j`` the global ``in0 + j``."""
    n_in_g, n_out_g, in0, out0 = window or (n_in, n_out, 0, 0)
    i0, i1, _, l1 = (a[out0:out0 + n_out]
                     for a in source_taps(n_out_g, n_in_g))
    i0, i1 = i0 - in0, i1 - in0
    out = []
    for a in range(0, n_in, step):
        b = min(a + step, n_in)
        hit = np.nonzero(((i0 >= a) & (i0 < b))
                         | ((i1 >= a) & (i1 < b) & (l1 != 0)))[0]
        lo_, hi_ = ((max(int(hit[0]) - 1, 0), min(int(hit[-1]) + 2, n_out))
                    if hit.size else (0, 0))
        out.append((a, b, lo_, hi_))
    return out


@functools.lru_cache(maxsize=64)
def band_plan(h: int, w: int, H: int, W: int,
              window: Optional[Window] = None) -> np.ndarray:
    """The band backward's blocks for one geometry: an ``(n, 8)`` int32
    array, one row per block, ``(y_a, y_b, i_lo, i_hi, x_a, x_b, j_lo,
    j_hi)``. The block owns low-res rows [y_a, y_b) and columns [x_a, x_b)
    (bands of ``BAND_ROWS`` rows, each cut into ``COL_SPLITS`` column
    ranges: together they tile [0, h) x [0, w) once) and visits the output
    rows [i_lo, i_hi) and columns [j_lo, j_hi), which hold every output
    index with a non-zero bilinear weight on what it owns. Under a row
    ``window`` (the module's) the rows are the window's."""
    bands = _touching(H, h, BAND_ROWS, window)
    cols = _touching(W, w, -(-w // COL_SPLITS))
    plan = np.array([r + c for r in bands for c in cols], dtype=np.int32)
    plan.setflags(write=False)
    return plan


def _plan_sizes(plan: np.ndarray) -> Tuple[int, int, int]:
    """The largest owned row count, owned column count and visited output
    column count of a plan's blocks: they size the shared memory."""
    return (int((plan[:, 1] - plan[:, 0]).max()),
            int((plan[:, 5] - plan[:, 4]).max()),
            int((plan[:, 7] - plan[:, 6]).max()))


_device_plans: Dict[tuple, torch.Tensor] = {}


def _device_plan(h: int, w: int, H: int, W: int, window: Window,
                 device: torch.device) -> torch.Tensor:
    """:func:`band_plan` on ``device``, copied once per geometry."""
    key = (h, w, H, W, window, device)
    if key not in _device_plans:
        _device_plans[key] = torch.from_numpy(
            band_plan(h, w, H, W, window).copy()).to(device)
    return _device_plans[key]


def _check(lo: torch.Tensor, labels: torch.Tensor) -> None:
    if lo.dim() != 4:
        raise ValueError(f"lo must be (B, C, h, w), got {tuple(lo.shape)}")
    if labels.dim() != 3 or labels.shape[0] != lo.shape[0]:
        raise ValueError(f"labels must be (B, H, W) with B={lo.shape[0]}, "
                         f"got {tuple(labels.shape)}")
    if labels.device != lo.device:
        raise ValueError(f"lo on {lo.device} but labels on {labels.device}")


def _check_card(lo: torch.Tensor, labels: torch.Tensor) -> None:
    if lo.device.type != "cuda":
        raise ValueError(f"no resize+CE kernel for device {lo.device}")
    if lo.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"lo must be float32 or bfloat16, got {lo.dtype}")
    if labels.dtype != torch.int32:
        raise TypeError(f"labels must be int32, got {labels.dtype}")
    if not (lo.is_contiguous() and labels.is_contiguous()):
        raise ValueError("lo and labels must be contiguous")
    if lo.shape[0] > MAX_BATCH:
        raise ValueError(f"resize+CE kernel takes B <= {MAX_BATCH}")


def _window(lo: torch.Tensor, labels: torch.Tensor, window) -> Window:
    """The row window ``(hg, Hg, y0, Y0)`` of a call, the whole map when
    None; the taps of the labels' rows must lie in the logits' rows."""
    h, H = lo.shape[2], labels.shape[1]
    if window is None or tuple(window) == (h, H, 0, 0):
        return (h, H, 0, 0)
    hg, Hg, y0, Y0 = (int(v) for v in window)
    if not (0 <= y0 and y0 + h <= hg and 0 <= Y0 and Y0 + H <= Hg):
        raise ValueError(f"window {window} does not hold logits of {h} rows "
                         f"and labels of {H}")
    if H:
        i0, i1, _, _ = source_taps(Hg, hg)
        if i0[Y0] < y0 or i1[Y0 + H - 1] >= y0 + h:
            raise ValueError(f"the rows [{Y0}, {Y0 + H}) of window {window} "
                             f"read logits outside [{y0}, {y0 + h})")
    return (hg, Hg, y0, Y0)


def _is_bf16(lo: torch.Tensor) -> int:
    return int(lo.dtype == torch.bfloat16)


def _focal_args(focal: Focal):
    if focal is None:
        return 0, 1.0, 0.0
    alpha, gamma = focal
    return 1, float(alpha), float(gamma)


def _check_smem(smem: int, what: str) -> None:
    if smem > SMEM_LIMIT:
        raise ValueError(f"resize+CE kernel needs {smem} bytes of shared "
                         f"memory for {what}; the card gives {SMEM_LIMIT}")


def resize_ce_forward(lo: torch.Tensor, labels: torch.Tensor,
                      focal: Focal = None, window=None) -> torch.Tensor:
    """Per-entry loss sums ``(B,)`` float32 of float32 or bfloat16 logits
    (no autograd graph), on the row ``window`` (the whole map by
    default)."""
    global fwd_launches, bf16_fwd_launches, window_fwd_launches
    global bf16_window_fwd_launches
    _check(lo, labels)
    _check_card(lo, labels)
    win = _window(lo, labels, window)
    b, c, h, w = lo.shape
    H, W = labels.shape[1:]
    lib = load_library()
    _check_smem(lib.afan_resize_ce_fwd_smem(c, w), f"C={c}, w={w}")
    if H == 0:
        # no output rows in this window: no loss and no launch
        return torch.zeros((b,), dtype=torch.float32, device=lo.device)
    out = torch.empty((b,), dtype=torch.float32, device=lo.device)
    if b == 0:
        return out
    partial = torch.empty((b, H), dtype=torch.float32, device=lo.device)
    with torch.cuda.device(lo.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.afan_resize_ce_forward(
            lo.data_ptr(), labels.data_ptr(), _is_bf16(lo), b, c, h, w, H,
            W, *win, *_focal_args(focal), partial.data_ptr(),
            out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"resize+CE forward launch failed: CUDA error "
                           f"{err}")
    fwd_launches += 1
    bf16_fwd_launches += _is_bf16(lo)
    if win != (h, H, 0, 0):
        window_fwd_launches += 1
        bf16_window_fwd_launches += _is_bf16(lo)
    return out


def _backward_inputs(lo: torch.Tensor, labels: torch.Tensor,
                     gout: torch.Tensor) -> None:
    _check(lo, labels)
    if tuple(gout.shape) != (lo.shape[0],):
        raise ValueError(f"gout must be ({lo.shape[0]},), got "
                         f"{tuple(gout.shape)}")
    _check_card(lo, labels)
    if gout.dtype != torch.float32 or not gout.is_contiguous():
        raise ValueError("gout must be contiguous float32")


def resize_ce_backward(lo: torch.Tensor, labels: torch.Tensor,
                       gout: torch.Tensor, focal: Focal = None,
                       window=None) -> torch.Tensor:
    """``d(sum_b gout[b] * sums[b]) / d lo``, shaped like ``lo`` and in its
    dtype, by the band kernel, on the row ``window`` (the whole map by
    default)."""
    global bwd_launches, bf16_bwd_launches, window_bwd_launches
    global bf16_window_bwd_launches
    _backward_inputs(lo, labels, gout)
    win = _window(lo, labels, window)
    b, c, h, w = lo.shape
    H, W = labels.shape[1:]
    if H == 0 or h == 0:
        return torch.zeros_like(lo)
    plan_win = None if win == (h, H, 0, 0) else win
    lib = load_library()
    rows, cols, seg = _plan_sizes(band_plan(h, w, H, W, plan_win))
    _check_smem(lib.afan_resize_ce_bwd_bands_smem(c, rows, cols, seg),
                f"C={c}, {rows} rows, {cols} columns, {seg} output columns")
    dlo = torch.empty_like(lo)
    if b == 0:
        return dlo
    plan = _device_plan(h, w, H, W, plan_win, lo.device)
    with torch.cuda.device(lo.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.afan_resize_ce_backward(
            lo.data_ptr(), labels.data_ptr(), gout.data_ptr(),
            plan.data_ptr(), plan.shape[0], _is_bf16(lo), b, c, h, w, H, W,
            *win, rows, cols, seg, *_focal_args(focal), dlo.data_ptr(),
            stream)
    if err != 0:
        raise RuntimeError(f"resize+CE backward launch failed: CUDA error "
                           f"{err}")
    bwd_launches += 1
    bf16_bwd_launches += _is_bf16(lo)
    if plan_win is not None:
        window_bwd_launches += 1
        bf16_window_bwd_launches += _is_bf16(lo)
    return dlo


def kernel_info(kind: str, c: int, h: int, w: int, H: int, W: int,
                dtype: torch.dtype = torch.float32) -> Dict[str, int]:
    """Registers and local (spill) bytes per thread, static and dynamic
    shared bytes per block and resident blocks per SM of the ``"forward"``
    or the ``"backward"`` (band) kernel for ``dtype`` logits at one
    geometry, as the card reports them."""
    lib = load_library()
    if kind == "forward":
        smem = lib.afan_resize_ce_fwd_smem(c, w)
    elif kind == "backward":
        rows, cols, seg = _plan_sizes(band_plan(h, w, H, W))
        smem = lib.afan_resize_ce_bwd_bands_smem(c, rows, cols, seg)
    else:
        raise ValueError(f"kind must be 'forward' or 'backward', got {kind!r}")
    out = (ctypes.c_int * 4)()
    err = lib.afan_resize_ce_kernel_info(int(kind == "backward"), c,
                                         int(dtype == torch.bfloat16), smem,
                                         out)
    if err != 0:
        raise RuntimeError(f"resize+CE {kind} attributes: CUDA error {err}")
    return {"registers": out[0], "local_bytes": out[1],
            "static_smem": out[2], "dynamic_smem": smem,
            "blocks_per_sm": out[3]}
