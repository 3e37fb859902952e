"""Build the port's CUDA sources into plain C-ABI shared libraries.

Each ``afan_torch/csrc/<name>.cu`` is compiled by its own ``nvcc`` for
``sm_90a`` into ``build/kernels/`` (git-ignored) at first use, under a name
that hashes the source and the flags, so an edited source is rebuilt and an
unchanged one is not. :func:`build_all` starts one ``nvcc`` per source at
once and waits for all of them. The kernel modules load the result with
``ctypes``.
"""
from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import time
from typing import Dict, Sequence

CSRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "..",
                                    "csrc"))
BUILD_DIR = os.path.abspath(
    os.path.join(os.path.dirname(__file__), "..", "..", "..", "build",
                 "kernels"))
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC")
SOURCES = ("nms.cu", "resize_ce.cu", "pgd_step.cu")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the port's CUDA kernels are built "
                       "with the CUDA toolkit at first use")


def library_path(source: str) -> str:
    """Where ``source`` (a file name under ``csrc/``) is built to."""
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    with open(os.path.join(CSRC, source), "rb") as f:
        h.update(f.read())
    stem = os.path.splitext(source)[0]
    return os.path.join(BUILD_DIR, f"libafan_{stem}-{h.hexdigest()[:12]}.so")


def build_all(sources: Sequence[str] = SOURCES) -> Dict[str, float]:
    """Compile every source whose library is missing, one ``nvcc`` each,
    all started together. Returns each source's build seconds (0.0 when the
    library was already there); raises with the compiler's output when one
    fails."""
    started = {}
    for source in sources:
        out = library_path(source)
        if os.path.exists(out):
            continue
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{out}.{os.getpid()}.tmp"
        proc = subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, source)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        started[source] = (proc, tmp, out, time.time())
    seconds = {s: 0.0 for s in sources}
    errors = []
    for source, (proc, tmp, out, t0) in started.items():
        _, err = proc.communicate()
        seconds[source] = time.time() - t0
        if proc.returncode != 0:
            errors.append(f"nvcc {source} failed ({proc.returncode}):\n{err}")
        else:
            os.replace(tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))
    return seconds


def build(source: str) -> str:
    """Compile one source unless its library is there; return its path."""
    build_all((source,))
    return library_path(source)
