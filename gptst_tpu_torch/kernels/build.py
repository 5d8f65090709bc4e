"""Build and load the hand-written CUDA kernels.

Each `csrc/<name>.cu` compiles on first use, with `nvcc` for `sm_90a`,
into `gptst_tpu_torch/_build/lib<name>.so` (listed in `.gitignore`),
which is loaded through `ctypes`: the sources have a plain C interface
and include no PyTorch header, so a build takes seconds. A library is
rebuilt when any source in `csrc/` is newer than it. `build_all`
starts one `nvcc` per source at once and waits for all of them.

Nothing here runs at import time: the CPU tests import every module
of the package on a machine without `nvcc` or a card.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# bsr_spmm and dia_spmm: 10 pointers, 7 ints, the stream
_GATHER = (_P,) * 10 + (_I,) * 7 + (_P,)
# C signatures of each source's entry points (pointers and the stream as
# void*); each returns its launch's or copy's cudaError_t
SIGNATURES = {
    "block_spmm": {"bsr_spmm": _GATHER, "dia_spmm": _GATHER},
    "sddmm": {"sddmm": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                        _P)},
    "spmm_dvals": {"spmm_dvals": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                  _I, _I, _P)},
    "ring_spmm": {"ring_spmm": (_P, _L, _P, _P, _P, _I, _I, _I, _I, _P),
                  "ring_copy": (_P, _I, _P, _I, ctypes.c_size_t, _P)},
}
KERNELS = tuple(SIGNATURES)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def nvcc_path() -> str:
    """`nvcc` from CUDA_HOME (as PyTorch's extension builder finds it)
    or from PATH; raises when there is none."""
    from torch.utils.cpp_extension import CUDA_HOME

    cands = [os.path.join(CUDA_HOME, "bin", "nvcc")] if CUDA_HOME else []
    cands.append(shutil.which("nvcc") or "")
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME)")


def _lib_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def _stale(name: str) -> bool:
    so = _lib_path(name)
    if not so.exists():
        return True
    newest = max(p.stat().st_mtime for p in CSRC.iterdir())
    return so.stat().st_mtime < newest


def _start(name: str) -> tuple[subprocess.Popen, str, Path]:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # build under a temporary name and rename: concurrent processes
    # never load a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, _lib_path(name)


def _finish(name: str, proc: subprocess.Popen, tmp: str,
            dst: Path) -> str:
    log, _ = proc.communicate()
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed for {name}.cu "
                           f"(exit {proc.returncode}):\n{log}")
    os.replace(tmp, dst)
    return log


def build_all(names=KERNELS, force: bool = False) -> dict[str, str]:
    """Compile every stale kernel library in parallel; returns the
    compiler output (ptxas register and spill report) per kernel."""
    with _LOCK:
        todo = [n for n in names if force or _stale(n)]
        started = [(n, *_start(n)) for n in todo]
        return {n: _finish(n, p, tmp, dst) for n, p, tmp, dst in started}


def load(name: str) -> ctypes.CDLL:
    """The loaded library for `csrc/<name>.cu`, built if needed."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    build_all((name,))
    with _LOCK:
        if name not in _LIBS:
            lib = ctypes.CDLL(str(_lib_path(name)))
            for entry, argtypes in SIGNATURES[name].items():
                fn = getattr(lib, entry)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _LIBS[name] = lib
        return _LIBS[name]
