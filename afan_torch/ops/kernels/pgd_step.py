"""Fused PGD sign step on the card: the wrapper around ``csrc/pgd_step.cu``.

The CUDA source replaces the Pallas TPU kernels
``afan/ops/kernels/pgd_step.py:_update_kernel`` and ``:_update_clip_kernel``;
its header says what bounds it and how it is laid out. It is compiled with
``nvcc`` for ``sm_90a`` at first use (:mod:`.build`) and bound with
``ctypes``.

:func:`pgd_update` returns ``x + gamma * sign(g)``, then, with ``clip``, its
clamp into ``[center - eps, center + eps]``, in a new tensor. It takes
contiguous float32 or bfloat16 CUDA tensors of one shape and dtype only
(in bfloat16 it rounds ``gamma`` and ``eps`` to bfloat16 first), and
launches its kernel or raises; the choice of the plain PyTorch version for
a CPU tensor is made once, in :func:`afan_torch.ops.pgd_step.pgd_update`.
A ``gamma`` given as a one-element tensor of ``x``'s dtype on ``x``'s card
(a step size drawn on the card) launches the device-step-size entry point,
which reads it there: nothing goes to the host, so a CUDA graph may
capture the call.
"""
from __future__ import annotations

import ctypes
import threading
from typing import Optional, Union

import torch

from ...core.project import weak_scalar
from .build import build

# Kernel launches since the last reset, and those of them on bfloat16
# tensors; a run sets them to 0 and reads them after. ``dev_launches`` and
# ``bf16_dev_launches`` count the device-step-size entry points apart.
launches = 0
bf16_launches = 0
dev_launches = 0
bf16_dev_launches = 0

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()


def load_library() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build("pgd_step.cu"))
            for fn in (lib.afan_pgd_step, lib.afan_pgd_step_bf16):
                fn.restype = ctypes.c_int
                fn.argtypes = ([ctypes.c_void_p] * 4
                               + [ctypes.c_int64, ctypes.c_float,
                                  ctypes.c_float, ctypes.c_int,
                                  ctypes.c_void_p])
            for fn in (lib.afan_pgd_step_dev, lib.afan_pgd_step_bf16_dev):
                fn.restype = ctypes.c_int
                fn.argtypes = ([ctypes.c_void_p] * 4
                               + [ctypes.c_int64, ctypes.c_void_p,
                                  ctypes.c_float, ctypes.c_int,
                                  ctypes.c_void_p])
            _lib = lib
    return _lib


def _check(x: torch.Tensor, others) -> None:
    for t in (x, *others):
        if t.device.type != "cuda":
            raise ValueError(f"no PGD-step kernel for device {t.device}")
        if t.dtype not in (torch.float32, torch.bfloat16) or (
                t.dtype != x.dtype):
            raise TypeError(f"the PGD-step kernel takes float32 or bfloat16 "
                            f"tensors of one dtype, got {t.dtype} with x "
                            f"{x.dtype}")
        if not t.is_contiguous():
            raise ValueError("the PGD-step kernel takes contiguous tensors")
        if t.shape != x.shape or t.device != x.device:
            raise ValueError(f"shape {tuple(t.shape)} on {t.device} does not "
                             f"match x {tuple(x.shape)} on {x.device}")


def _check_gamma(gamma: torch.Tensor, x: torch.Tensor) -> None:
    if (gamma.numel() != 1 or gamma.dtype != x.dtype
            or gamma.device != x.device or not gamma.is_contiguous()):
        raise ValueError(f"a device step size must be one contiguous "
                         f"element of x's dtype {x.dtype} on {x.device}, got "
                         f"{tuple(gamma.shape)} {gamma.dtype} on "
                         f"{gamma.device}")


def pgd_update(x: torch.Tensor, g: torch.Tensor,
               center: Optional[torch.Tensor] = None, *,
               gamma: Union[float, torch.Tensor],
               eps: Optional[float] = None, clip: bool = False
               ) -> torch.Tensor:
    """One launch: ``x + gamma * sign(g)``, clamped to the L-inf ball of
    radius ``eps`` around ``center`` when ``clip``; ``x`` is not changed.
    ``gamma`` is a number, or a one-element tensor of ``x``'s dtype on its
    card, which the kernel reads there."""
    global launches, bf16_launches, dev_launches, bf16_dev_launches
    if clip and (center is None or eps is None):
        raise ValueError("clip=True requires center and eps")
    _check(x, (g, center) if clip else (g,))
    on_card = isinstance(gamma, torch.Tensor)
    if on_card:
        _check_gamma(gamma, x)
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    lib = load_library()
    bf16 = x.dtype == torch.bfloat16
    if on_card:
        fn = lib.afan_pgd_step_bf16_dev if bf16 else lib.afan_pgd_step_dev
        step = gamma.data_ptr()
    else:
        fn = lib.afan_pgd_step_bf16 if bf16 else lib.afan_pgd_step
        step = weak_scalar(float(gamma), x.dtype)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(x.data_ptr(), g.data_ptr(),
                 center.data_ptr() if clip else None, out.data_ptr(),
                 x.numel(), step,
                 weak_scalar(float(eps), x.dtype) if clip else 0.0, int(clip),
                 stream)
    if err != 0:
        raise RuntimeError(f"PGD-step launch failed: CUDA error {err}")
    if on_card:
        dev_launches += 1
        bf16_dev_launches += bf16
    else:
        launches += 1
        bf16_launches += bf16
    return out
