"""Native (C++) host-side tools, loaded through `ctypes`.

The host-side graph builds where numpy is the bottleneck (banded DTW
over all node pairs, `graph/dtw.py`). `dtw.cpp` compiles at first use
with `g++ -O3 -fopenmp` (or without OpenMP where the compiler lacks it)
into `gptst_tpu_torch/_build/libdtw.so` (listed in `.gitignore`), and
again when the source is newer than the library. Every entry point
returns None where no library could be built, and its caller takes the
numpy path. Nothing is built at import time.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

SRC_DIR = Path(__file__).resolve().parent
BUILD_DIR = SRC_DIR.parent / "_build"
_LOCK = threading.Lock()
_LIBS: dict = {}


def library_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def _build(name: str) -> Path | None:
    src, lib = SRC_DIR / f"{name}.cpp", library_path(name)
    if lib.exists() and lib.stat().st_mtime >= src.stat().st_mtime:
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    for flags in (["-O3", "-fopenmp"], ["-O3"]):
        # build under a temporary name and rename: a concurrent process
        # never loads a half-written library
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        try:
            subprocess.run(["g++", *flags, "-shared", "-fPIC", str(src),
                            "-o", tmp], check=True, capture_output=True,
                           timeout=120)
        except (subprocess.SubprocessError, FileNotFoundError):
            os.unlink(tmp)
            continue
        os.replace(tmp, lib)
        return lib
    return None


def load(name: str) -> ctypes.CDLL | None:
    """Build and load `lib<name>.so`; None when it cannot be built."""
    with _LOCK:
        if name not in _LIBS:
            path = _build(name)
            _LIBS[name] = ctypes.CDLL(str(path)) if path else None
        return _LIBS[name]


_P = ctypes.POINTER
_I64 = ctypes.c_int64
_DTW_ARGS = (_P(ctypes.c_float), _I64, _I64, _I64, _P(ctypes.c_int32),
             _P(ctypes.c_int32), _I64, _I64, _I64, _P(ctypes.c_double))


def native_banded_dtw_pairs(x: np.ndarray, ii: np.ndarray, jj: np.ndarray,
                            radius: int, order: int = 1) -> np.ndarray | None:
    """All-pairs banded DTW in C++ (OpenMP over pairs). x: (days, T, N),
    read as float32 and summed in double; pair p is (ii[p], jj[p]).
    Returns the (npairs,) float64 costs, or None without the library
    (callers take the numpy path)."""
    lib = load("dtw")
    if lib is None:
        return None
    x = np.ascontiguousarray(x, np.float32)
    ii = np.ascontiguousarray(ii, np.int32)
    jj = np.ascontiguousarray(jj, np.int32)
    days, t, n = x.shape
    if ii.shape != jj.shape or ii.ndim != 1:
        raise ValueError(f"pair index shapes {ii.shape} and {jj.shape}")
    if ii.size and (min(ii.min(), jj.min()) < 0
                    or max(ii.max(), jj.max()) >= n):
        raise ValueError(f"pair indices outside [0, {n})")
    out = np.zeros(ii.size, np.float64)
    fn = lib.banded_dtw_pairs
    fn.argtypes, fn.restype = _DTW_ARGS, None
    fn(x.ctypes.data_as(_P(ctypes.c_float)), days, t, n,
       ii.ctypes.data_as(_P(ctypes.c_int32)),
       jj.ctypes.data_as(_P(ctypes.c_int32)), ii.size, radius, order,
       out.ctypes.data_as(_P(ctypes.c_double)))
    return out
