"""Build and load the CUDA kernels of ``coral_tpu_torch/csrc``.

``nvcc`` compiles every ``csrc/*.cu`` into one shared library with a plain
C interface (no PyTorch headers, so a build takes seconds), which is
loaded with ``ctypes``.  The library lands in ``build/coral_tpu_torch/``
at the root of the checkout, named by a hash of the sources and flags, so
the first call in a fresh checkout builds it and later calls reuse it.
Nothing here runs at import time: the CPU tests import this module on
machines without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import os
import shutil
from pathlib import Path

from .._buildlib import PKG, compile_library, hashed_path

CSRC = PKG / "csrc"
# --threads 0: the sources compile side by side, one per core
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
              "--threads", "0")

_lib = None


def nvcc_path() -> str:
    """``$CUDA_HOME/bin/nvcc``, ``/usr/local/cuda/bin/nvcc`` or ``nvcc`` on
    ``PATH``; raises when there is none."""
    candidates = [os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc")] \
        if os.environ.get("CUDA_HOME") else []
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA "
                           "kernels of coral_tpu_torch cannot be built")
    return found


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    cu, cuh = _sources()
    return hashed_path("libcoral_kernels", NVCC_FLAGS, cu + cuh)


def build() -> Path:
    """Compile the kernels unless the library for these sources exists.
    Returns its path; the compiler's output (``-Xptxas=-v``: registers,
    shared memory, spills per kernel) is kept beside it as ``.log``."""
    return compile_library(nvcc_path(), NVCC_FLAGS, _sources()[0],
                           library_path())


def load() -> ctypes.CDLL:
    """Build if needed, load once per process, and declare the C entries."""
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(build()))
    p, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
        ctypes.c_float
    lib.coral_pair3_hitmask.argtypes = [p, p, p, p, ll, i, f, i, p]
    lib.coral_pair3_hitmask.restype = i
    lib.coral_pair3_support.argtypes = [p, p, p, p, ll, i, i, f, i, p]
    lib.coral_pair3_support.restype = i
    lib.coral_pair2_hitmask.argtypes = [p] * 6 + [ll, i, i, f, i, p]
    lib.coral_pair2_hitmask.restype = i
    lib.coral_pair2_support.argtypes = [p] * 5 + [ll, i, i, i, f, i, p]
    lib.coral_pair2_support.restype = i
    lib.coral_pair6_hitmask.argtypes = [p] * 9 + [p, p, ll, i, i, i, f, i, p]
    lib.coral_pair6_hitmask.restype = i
    lib.coral_pair6_support.argtypes = [p] * 9 + [p, ll, i, i, i, f, i, p]
    lib.coral_pair6_support.restype = i
    lib.coral_stream_control.argtypes = [p, p, p, p, ll, i, p]
    lib.coral_stream_control.restype = i
    lib.coral_bin_overlap.argtypes = [p, p, p, ll, ll, ll] + [i] * 5 + [p]
    lib.coral_bin_overlap.restype = i
    lib.coral_bin_overlap_plan.argtypes = [ll, i, i,
                                           ctypes.POINTER(ctypes.c_int)]
    lib.coral_bin_overlap_plan.restype = i
    lib.coral_match_matrix.argtypes = [p, p, p, i, i, i, p]
    lib.coral_match_matrix.restype = i
    lib.coral_cuda_error_string.argtypes = [i]
    lib.coral_cuda_error_string.restype = ctypes.c_char_p
    _lib = lib
    return lib


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a C entry."""
    if rc != 0:
        msg = lib.coral_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")
