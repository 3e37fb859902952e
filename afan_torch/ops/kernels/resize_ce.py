"""Fused bilinear upsample + masked cross-entropy on the card: the wrappers
around ``csrc/resize_ce.cu``.

The CUDA source replaces the Pallas TPU kernels
``afan/ops/kernels/resize_ce_kernel.py:_fwd_kernel`` and ``:_bwd_kernel``;
its header says what bounds them and how they are laid out. It is compiled
with ``nvcc`` for ``sm_90a`` at first use (:mod:`.build`) and bound with
``ctypes``.

:func:`resize_ce_forward` returns the per-entry sums ``(B,)`` of the
255-masked CE (or focal) loss of the ``align_corners=False`` bilinear
upsample of logits ``(B, C, h, w)`` to the labels' ``(H, W)``;
:func:`resize_ce_backward` returns ``d(sum_b g[b] * sums[b]) / d lo``. Each
takes CUDA tensors only, and launches its kernel or raises; the choice of
the plain PyTorch version for a CPU tensor is made once, in
:func:`afan_torch.ops.resize_ce.fused_resize_nll_sums`.
"""
from __future__ import annotations

import ctypes
import threading
from typing import Optional, Tuple

import torch

from .build import build

SMEM_LIMIT = 232448        # dynamic shared memory one block may use on sm_90
MAX_BATCH = 65535          # grid.y

# Kernel launches since the last reset; a run sets them to 0 and reads them
# after.
fwd_launches = 0
bwd_launches = 0

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()

Focal = Optional[Tuple[float, float]]


def load_library() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build("resize_ce.cu"))
            lib.afan_resize_ce_bwd_smem.restype = ctypes.c_int
            lib.afan_resize_ce_bwd_smem.argtypes = [ctypes.c_int] * 3
            common = [ctypes.c_int] * 6 + [ctypes.c_int, ctypes.c_float,
                                           ctypes.c_float]
            lib.afan_resize_ce_forward.restype = ctypes.c_int
            lib.afan_resize_ce_forward.argtypes = (
                [ctypes.c_void_p, ctypes.c_void_p] + common
                + [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p])
            lib.afan_resize_ce_backward.restype = ctypes.c_int
            lib.afan_resize_ce_backward.argtypes = (
                [ctypes.c_void_p] * 3 + common
                + [ctypes.c_void_p, ctypes.c_void_p])
            _lib = lib
    return _lib


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
    if lo.dtype != torch.float32:
        raise TypeError(f"lo must be float32, got {lo.dtype}")
    if labels.dtype != torch.int32:
        raise TypeError(f"labels must be int32, got {labels.dtype}")
    if not (lo.is_contiguous() and labels.is_contiguous()):
        raise ValueError("lo and labels must be contiguous")
    if lo.shape[0] > MAX_BATCH:
        raise ValueError(f"resize+CE kernel takes B <= {MAX_BATCH}")


def _focal_args(focal: Focal):
    if focal is None:
        return 0, 1.0, 0.0
    alpha, gamma = focal
    return 1, float(alpha), float(gamma)


def resize_ce_forward(lo: torch.Tensor, labels: torch.Tensor,
                      focal: Focal = None) -> torch.Tensor:
    """Per-entry loss sums ``(B,)`` float32 (no autograd graph)."""
    global fwd_launches
    _check(lo, labels)
    _check_card(lo, labels)
    b, c, h, w = lo.shape
    H, W = labels.shape[1:]
    out = torch.empty((b,), dtype=torch.float32, device=lo.device)
    if b == 0:
        return out
    partial = torch.empty((b, H), dtype=torch.float32, device=lo.device)
    lib = load_library()
    with torch.cuda.device(lo.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.afan_resize_ce_forward(
            lo.data_ptr(), labels.data_ptr(), b, c, h, w, H, W,
            *_focal_args(focal), partial.data_ptr(), out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"resize+CE forward launch failed: CUDA error "
                           f"{err}")
    fwd_launches += 1
    return out


def resize_ce_backward(lo: torch.Tensor, labels: torch.Tensor,
                       gout: torch.Tensor, focal: Focal = None
                       ) -> torch.Tensor:
    """``d(sum_b gout[b] * sums[b]) / d lo``, shaped like ``lo``."""
    global bwd_launches
    _check(lo, labels)
    if tuple(gout.shape) != (lo.shape[0],):
        raise ValueError(f"gout must be ({lo.shape[0]},), got "
                         f"{tuple(gout.shape)}")
    _check_card(lo, labels)
    if gout.dtype != torch.float32 or not gout.is_contiguous():
        raise ValueError("gout must be contiguous float32")
    b, c, h, w = lo.shape
    H, W = labels.shape[1:]
    lib = load_library()
    smem = lib.afan_resize_ce_bwd_smem(c, w, W)
    if smem > SMEM_LIMIT:
        raise ValueError(f"resize+CE backward needs {smem} bytes of shared "
                         f"memory for C={c}, w={w}, W={W}; the card gives "
                         f"{SMEM_LIMIT}")
    dlo = torch.empty_like(lo)
    if b == 0:
        return dlo
    with torch.cuda.device(lo.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.afan_resize_ce_backward(
            lo.data_ptr(), labels.data_ptr(), gout.data_ptr(), b, c, h, w, H,
            W, *_focal_args(focal), dlo.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"resize+CE backward launch failed: CUDA error "
                           f"{err}")
    bwd_launches += 1
    return dlo
