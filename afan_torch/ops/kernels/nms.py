"""Greedy-NMS keep mask on the card: the wrapper around ``csrc/nms.cu``.

The CUDA source replaces the Pallas TPU kernel
``afan/ops/kernels/nms_kernel.py:_nms_kernel``; its header says what bounds
it and how it is laid out. It is compiled with ``nvcc`` for ``sm_90a`` into a
plain C-ABI shared library at first use, from the sources in this package,
and bound with ``ctypes``.

:func:`nms_sorted_mask` takes score-sorted boxes ``(G, N, 4)`` and a validity
mask ``(G, N)`` and returns the keep mask ``(G, N)``. On a CPU tensor it runs
the plain PyTorch version (:func:`afan_torch.ops.nms.nms_sorted_mask_plain`);
on a CUDA tensor it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Optional

import torch

_CSRC = os.path.join(os.path.dirname(__file__), "..", "..", "csrc")
_SOURCES = ("nms.cu",)
BUILD_DIR = os.path.abspath(
    os.path.join(os.path.dirname(__file__), "..", "..", "..", "build",
                 "kernels"))
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC")
MAX_WORDS = 6144           # the scan's removed-bit array: 48 KB of shared memory
MAX_GROUPS = 65535         # grid.z of the mask pass

# Kernel launches since the last reset; a run sets it to 0 and reads it after.
launches = 0

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the NMS kernel is built with the CUDA "
                       "toolkit at first use")


def build() -> str:
    """Compile ``csrc/nms.cu`` into ``BUILD_DIR`` unless a library built from
    the same sources and flags is there; return the library's path."""
    paths = [os.path.abspath(os.path.join(_CSRC, s)) for s in _SOURCES]
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for p in paths:
        with open(p, "rb") as f:
            h.update(f.read())
    out = os.path.join(BUILD_DIR, f"libafan_nms-{h.hexdigest()[:12]}.so")
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, *paths],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def load_library() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            lib.afan_nms_words.restype = ctypes.c_int
            lib.afan_nms_words.argtypes = [ctypes.c_int]
            lib.afan_nms_sorted_mask.restype = ctypes.c_int
            lib.afan_nms_sorted_mask.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                ctypes.c_float, ctypes.c_float, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_void_p]
            _lib = lib
    return _lib


def _check(boxes: torch.Tensor, valid: torch.Tensor) -> None:
    if boxes.dim() != 3 or boxes.shape[-1] != 4:
        raise ValueError(f"boxes must be (G, N, 4), got {tuple(boxes.shape)}")
    if boxes.dtype != torch.float32:
        raise TypeError(f"boxes must be float32, got {boxes.dtype}")
    if tuple(valid.shape) != tuple(boxes.shape[:2]):
        raise ValueError(f"valid must be {tuple(boxes.shape[:2])}, got "
                         f"{tuple(valid.shape)}")
    if valid.dtype != torch.bool:
        raise TypeError(f"valid must be bool, got {valid.dtype}")
    if valid.device != boxes.device:
        raise ValueError(f"boxes on {boxes.device} but valid on {valid.device}")


def nms_sorted_mask(boxes: torch.Tensor, valid: torch.Tensor,
                    threshold: float, plus_one: bool = True) -> torch.Tensor:
    """Keep mask ``(G, N)`` bool of exact greedy NMS over each group's
    score-descending boxes ``(G, N, 4)``; ``valid`` ``(G, N)`` marks real
    slots (invalid slots are never kept and never suppress)."""
    global launches
    _check(boxes, valid)
    if boxes.device.type == "cpu":
        from ..nms import nms_sorted_mask_plain
        return nms_sorted_mask_plain(boxes, valid, threshold, plus_one)
    if boxes.device.type != "cuda":
        raise ValueError(f"no NMS kernel for device {boxes.device}")
    if not (boxes.is_contiguous() and valid.is_contiguous()):
        raise ValueError("boxes and valid must be contiguous")
    g, n = boxes.shape[0], boxes.shape[1]
    keep = torch.empty((g, n), dtype=torch.bool, device=boxes.device)
    if g == 0 or n == 0:
        return keep
    lib = load_library()
    words = lib.afan_nms_words(n)
    if words > MAX_WORDS or g > MAX_GROUPS:
        raise ValueError(f"NMS kernel takes N <= {64 * MAX_WORDS} and "
                         f"G <= {MAX_GROUPS}, got G={g}, N={n}")
    mask = torch.empty((g, n, words), dtype=torch.int64, device=boxes.device)
    with torch.cuda.device(boxes.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.afan_nms_sorted_mask(
            boxes.data_ptr(), valid.data_ptr(), g, n, float(threshold),
            1.0 if plus_one else 0.0, mask.data_ptr(), keep.data_ptr(),
            stream)
    if err != 0:
        raise RuntimeError(f"NMS kernel launch failed: CUDA error {err}")
    launches += 1
    return keep
