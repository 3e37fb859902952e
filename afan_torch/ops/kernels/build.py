"""Build the port's CUDA sources into plain C-ABI shared libraries.

Each ``afan_torch/csrc/<name>.cu`` is compiled by its own ``nvcc`` for
``sm_90a`` into ``build/kernels/`` (git-ignored) at first use, under a name
that hashes the source and the flags, so an edited source is rebuilt and an
unchanged one is not. :func:`build_all` starts one ``nvcc`` per source at
once and waits for all of them, and keeps what ``ptxas -v`` said of each
kernel (registers, shared memory, spills) beside the library
(:func:`build_log`). The kernel modules load the result with ``ctypes``.

:func:`build_host` does the same for a host C++ source (the image decoder,
``csrc/imdecode.cpp``) with the system's ``c++`` into ``build/host/``.
"""
from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, Sequence

CSRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "..",
                                    "csrc"))
BUILD_DIR = os.path.abspath(
    os.path.join(os.path.dirname(__file__), "..", "..", "..", "build",
                 "kernels"))
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
SOURCES = ("nms.cu", "resize_ce.cu", "pgd_step.cu")
HOST_BUILD_DIR = os.path.join(os.path.dirname(BUILD_DIR), "host")
CXX_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the port's CUDA kernels are built "
                       "with the CUDA toolkit at first use")


def _cxx() -> str:
    for name in ("c++", "g++"):
        found = shutil.which(name)
        if found:
            return found
    raise RuntimeError("no C++ compiler (c++ or g++) found: the port's image "
                       "decoder (csrc/imdecode.cpp) is built with one at "
                       "first use")


def library_path(source: str, flags: Sequence[str] = NVCC_FLAGS,
                 build_dir: str = BUILD_DIR) -> str:
    """Where ``source`` (a file name under ``csrc/``) is built to."""
    h = hashlib.sha1(" ".join(flags).encode())
    with open(os.path.join(CSRC, source), "rb") as f:
        h.update(f.read())
    stem = os.path.splitext(source)[0]
    return os.path.join(build_dir, f"libafan_{stem}-{h.hexdigest()[:12]}.so")


def build_log(source: str) -> str:
    """What the compiler printed when it built ``source`` ("" when the
    build directory has no record of it)."""
    path = os.path.splitext(library_path(source))[0] + ".log"
    if not os.path.exists(path):
        return ""
    with open(path) as f:
        return f.read()


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
        said, err = proc.communicate()
        seconds[source] = time.time() - t0
        if proc.returncode != 0:
            errors.append(f"nvcc {source} failed ({proc.returncode}):\n{err}")
        else:
            with open(os.path.splitext(out)[0] + ".log", "w") as f:
                f.write(said + err)
            os.replace(tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))
    return seconds


def build(source: str) -> str:
    """Compile one source unless its library is there; return its path."""
    build_all((source,))
    return library_path(source)


def build_host(source: str) -> str:
    """Compile the host C++ ``source`` with ``c++`` unless its library is
    there; return its path (raises with the compiler's output on failure)."""
    out = library_path(source, CXX_FLAGS, HOST_BUILD_DIR)
    if os.path.exists(out):
        return out
    os.makedirs(HOST_BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
    done = subprocess.run([_cxx(), *CXX_FLAGS, "-o", tmp,
                           os.path.join(CSRC, source)],
                          capture_output=True, text=True)
    if done.returncode != 0:
        raise RuntimeError(f"c++ {source} failed ({done.returncode}):\n"
                           f"{done.stderr}")
    os.replace(tmp, out)
    return out
