"""Fused PGD sign step on the card: the wrapper around ``csrc/pgd_step.cu``.

The CUDA source replaces the Pallas TPU kernels
``afan/ops/kernels/pgd_step.py:_update_kernel`` and ``:_update_clip_kernel``;
its header says what bounds it and how it is laid out. It is compiled with
``nvcc`` for ``sm_90a`` at first use (:mod:`.build`) and bound with
``ctypes``.

:func:`pgd_update` returns ``x + gamma * sign(g)``, then, with ``clip``, its
clamp into ``[center - eps, center + eps]``, in a new tensor. It takes
contiguous float32 CUDA tensors of one shape only, and launches its kernel
or raises; the choice of the plain PyTorch version for a CPU tensor is made
once, in :func:`afan_torch.ops.pgd_step.pgd_update`.
"""
from __future__ import annotations

import ctypes
import threading
from typing import Optional

import torch

from .build import build

# Kernel launches since the last reset; a run sets it to 0 and reads it after.
launches = 0

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()


def load_library() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build("pgd_step.cu"))
            lib.afan_pgd_step.restype = ctypes.c_int
            lib.afan_pgd_step.argtypes = (
                [ctypes.c_void_p] * 4
                + [ctypes.c_int64, ctypes.c_float, ctypes.c_float,
                   ctypes.c_int, ctypes.c_void_p])
            _lib = lib
    return _lib


def _check(x: torch.Tensor, others) -> None:
    for t in (x, *others):
        if t.device.type != "cuda":
            raise ValueError(f"no PGD-step kernel for device {t.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"the PGD-step kernel takes float32, got "
                            f"{t.dtype}")
        if not t.is_contiguous():
            raise ValueError("the PGD-step kernel takes contiguous tensors")
        if t.shape != x.shape or t.device != x.device:
            raise ValueError(f"shape {tuple(t.shape)} on {t.device} does not "
                             f"match x {tuple(x.shape)} on {x.device}")


def pgd_update(x: torch.Tensor, g: torch.Tensor,
               center: Optional[torch.Tensor] = None, *, gamma: float,
               eps: Optional[float] = None, clip: bool = False
               ) -> torch.Tensor:
    """One launch: ``x + gamma * sign(g)``, clamped to the L-inf ball of
    radius ``eps`` around ``center`` when ``clip``; ``x`` is not changed."""
    global launches
    if clip and (center is None or eps is None):
        raise ValueError("clip=True requires center and eps")
    _check(x, (g, center) if clip else (g,))
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    lib = load_library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.afan_pgd_step(
            x.data_ptr(), g.data_ptr(), center.data_ptr() if clip else None,
            out.data_ptr(), x.numel(), float(gamma),
            float(eps) if clip else 0.0, int(clip), stream)
    if err != 0:
        raise RuntimeError(f"PGD-step launch failed: CUDA error {err}")
    launches += 1
    return out
