"""Build the package's CUDA sources at first use and load them.

Every ``csrc/<name>.cu`` becomes ``_build/lib<name>_<hash>.so``: one
nvcc run per source, all started together, for ``sm_90a`` (Hopper).
The hash covers the source and the flags, so an edited source is
rebuilt and a stale library is never loaded.  A file lock serialises
concurrent builds (test workers, several processes on one card).
The libraries export plain C functions, loaded with ``ctypes``: no
PyTorch headers are compiled, which keeps a build to seconds.
"""
from __future__ import annotations

import ctypes
import fcntl
import glob
import hashlib
import os
import shutil
import subprocess
import time
from typing import Dict, List, Optional

from ..base import MXNetError

__all__ = ["build", "build_log", "load", "sources", "BUILD_DIR",
           "CSRC_DIR"]

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v"]

_loaded: Dict[str, ctypes.CDLL] = {}


def sources() -> List[str]:
    """Kernel names, one per ``csrc/*.cu``."""
    return sorted(os.path.splitext(os.path.basename(p))[0]
                  for p in glob.glob(os.path.join(CSRC_DIR, "*.cu")))


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin",
                              "nvcc"),
                 "/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""):
        if cand and os.path.isfile(cand) and os.access(cand, os.X_OK):
            return cand
    raise MXNetError("nvcc not found (set CUDA_HOME or put nvcc on "
                     "PATH): the CUDA kernels are built from source at "
                     "first use")


def _lib_path(name: str) -> str:
    src = os.path.join(CSRC_DIR, name + ".cu")
    h = hashlib.sha256()
    with open(src, "rb") as f:
        h.update(f.read())
    for inc in sorted(glob.glob(os.path.join(CSRC_DIR, "*.cuh"))):
        with open(inc, "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"lib{name}_{h.hexdigest()[:16]}.so")


def build(names: Optional[List[str]] = None) -> Dict[str, float]:
    """Build the named sources (default: all) that are not built yet.
    Returns ``{name: seconds}`` for what this call
    compiled; raises ``MXNetError`` with nvcc's output on a failure."""
    names = sources() if names is None else list(names)
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, ".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        todo = [n for n in names if not os.path.exists(_lib_path(n))]
        if not todo:
            return {}
        nvcc = _nvcc()
        started = {}
        for n in todo:              # one nvcc a source, all at once
            out = _lib_path(n)
            with open(out + ".log", "w") as log:
                started[n] = (time.perf_counter(), subprocess.Popen(
                    [nvcc, *NVCC_FLAGS, "-o", out + ".tmp",
                     os.path.join(CSRC_DIR, n + ".cu")],
                    stdout=log, stderr=subprocess.STDOUT))
        took, failed = {}, []
        for n, (t0, proc) in started.items():
            rc = proc.wait()
            took[n] = time.perf_counter() - t0
            if rc != 0:
                failed.append((n, rc))
            else:
                os.replace(_lib_path(n) + ".tmp", _lib_path(n))
        if failed:
            raise MXNetError("CUDA kernel build failed: " + "; ".join(
                f"nvcc {n}.cu (exit {rc})\n" + build_log(n)[-6000:]
                for n, rc in failed))
        return took


def build_log(name: str) -> str:
    """nvcc's output (ptxas register and shared-memory report) for the
    current build of ``name``; empty when it was never built here."""
    path = _lib_path(name) + ".log"
    if not os.path.exists(path):
        return ""
    with open(path) as f:
        return f.read()


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built if needed."""
    lib = _loaded.get(name)
    if lib is None:
        build([name])
        lib = _loaded[name] = ctypes.CDLL(_lib_path(name))
    return lib
