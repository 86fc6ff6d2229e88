"""Build and load the port's hand-written CUDA kernels (``csrc/*.cu``).

One ``nvcc`` command compiles every source into one shared library with a
plain C interface, which ``ctypes`` loads: no PyTorch headers, so the build
takes seconds. The library is built at first use into ``_build/`` beside
the package (listed in ``.gitignore``), under a name that hashes the
sources and flags, so an edited source never loads a stale binary. It is
written to a temporary name and moved into place with ``os.replace``, so
processes that build at once never load a half-written file.

Every launcher returns ``cudaGetLastError()`` after its launch; the
wrappers in ``cuda_topk.py``, ``cuda_supertile.py`` and ``cuda_impact.py``
raise when it is not zero. Nothing here runs at import: the CPU tests
import every module.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from typing import Optional

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
SOURCES = ("tile_stats.cu", "super_scores.cu", "place_windows.cu",
           "slice_runs.cu", "impact_rescore.cu")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
# C signatures of the launchers (csrc/*.cu); every pointer and the stream
# are c_void_p so ctypes never truncates them to 32 bits.
_SIGNATURES = {
    "hst_tile_stats": (_P, _I, _P, _P, _L, _I, _I, _L, _P, _P, _P),
    "hst_super_scores": (_P, _I, _P, _P, _L, _I, _I, _I, _I, _I, _P, _P, _P),
    "hst_place_windows": (_P, _P, _L, _L, _I, _P, _P),
    "hst_slice_runs": (_P, _P, _P, _P, _L, _I, _I, _P, _P, _P),
    "hst_impact_rescore": (_P, _P, _P, _L, _I, _I, _I, _I, _I, _P, _P),
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
# {"path", "seconds", "log", "cached"} of the build that produced _lib
last_build: Optional[dict] = None


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")
    return found


def build() -> dict:
    """Compile the kernels (unless this exact build exists) and return
    {"path", "seconds", "log", "cached"}; ``log`` holds nvcc's output,
    including the ``-Xptxas -v`` register and shared-memory lines."""
    srcs = [os.path.join(CSRC_DIR, s) for s in SOURCES]
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in srcs:
        with open(path, "rb") as f:
            h.update(f.read())
    out = os.path.join(BUILD_DIR, f"libhst_kernels_{h.hexdigest()[:16]}.so")
    if os.path.exists(out):
        return {"path": out, "seconds": 0.0, "log": "", "cached": True}
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so.tmp")
    os.close(fd)
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, *srcs]
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
                f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return {"path": out, "seconds": time.perf_counter() - t0,
            "log": proc.stdout + proc.stderr, "cached": False}


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib, last_build
    with _lock:
        if _lib is None:
            info = build()
            lib = ctypes.CDLL(info["path"])
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
            _lib, last_build = lib, info
        return _lib


def check(rc: int, name: str) -> None:
    """Raise when a launcher reported a CUDA error."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")
