"""Build and load the port's hand-written CUDA kernels (``csrc/*.cu``).

One ``nvcc`` a source, all started together, compiles each source to an
object; one more links them into a shared library with a plain C
interface, which ``ctypes`` loads: no PyTorch headers, so the build takes
seconds. The library is built at first use into ``_build/`` beside the
package (listed in ``.gitignore``), under a name that hashes the sources
and flags, so an edited source never loads a stale binary. It is written
to a temporary name and moved into place with ``os.replace``, so
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

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
SOURCES = ("tile_stats.cu", "super_scores.cu", "place_windows.cu",
           "place_fused.cu", "slice_runs.cu", "impact_rescore.cu")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
# C signatures of the launchers (csrc/*.cu); every pointer and the stream
# are c_void_p so ctypes never truncates them to 32 bits.
_SIGNATURES = {
    "hst_tile_stats": (_P, _I, _P, _P, _L, _I, _I, _L, _P, _P, _I, _P),
    "hst_tile_stats_v1": (_P, _I, _P, _P, _L, _I, _I, _L, _P, _P, _P),
    "hst_super_scores": (_P, _I, _P, _P, _L, _I, _I, _I, _I, _I, _I, _P, _P, _P),
    "hst_super_scores_v1": (_P, _I, _P, _P, _L, _I, _I, _I, _I, _I, _P, _P, _P),
    "hst_super_scores_dedup": (_P, _I, _P, _P, _P, _P, _I, _L, _I, _I, _I, _I, _P, _P,
                               _P),
    "hst_super_scores_dedup_v1": (_P, _I, _P, _P, _L, _I, _I, _I, _I, _P, _P),
    "hst_group_table": (_P, _I, _I, _I, _P, _P),
    "hst_place_windows": (_P, _P, _L, _L, _I, _P, _P),
    "hst_place_windows_v1": (_P, _P, _L, _L, _I, _P, _P),
    "hst_place_fused": (_P, _P, _P, _I, _P, _P, _L, _L, _I, _P, _I, _P, _I, _I, _I, _I,
                        _P),
    "hst_place_fused_v1": (_P, _P, _P, _P, _P, _L, _L, _I, _P, _I, _P, _P),
    "hst_slice_runs": (_P, _P, _P, _P, _L, _I, _I, _P, _P, _P),
    "hst_slice_runs_v1": (_P, _P, _P, _P, _L, _I, _I, _P, _P, _P),
    "hst_impact_rescore": (_P, _P, _P, _L, _I, _I, _I, _I, _I, _P, _I, _I, _P),
    "hst_impact_rescore_v1": (_P, _P, _P, _L, _I, _I, _I, _I, _I, _P, _P),
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
    nvcc = nvcc_path()
    t0 = time.perf_counter()
    log = []
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as work:
        objs = [os.path.join(work, os.path.basename(src) + ".o") for src in srcs]
        cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", obj, src]
                for src, obj in zip(srcs, objs)]
        procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for cmd in cmds]
        outs = [proc.communicate()[0] for proc in procs]
        tmp = os.path.join(work, "lib.so")
        link = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
                "-o", tmp, *objs]
        for cmd, proc, text in zip(cmds, procs, outs):
            log.append(text)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}): "
                                   f"{' '.join(cmd)}\n{text}")
        proc = subprocess.run(link, capture_output=True, text=True)
        log.append(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}): "
                               f"{' '.join(link)}\n{log[-1]}")
        os.replace(tmp, out)
    return {"path": out, "seconds": time.perf_counter() - t0,
            "log": "".join(log), "cached": False}


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib, last_build
    if _lib is not None:
        return _lib
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


def stream_of(t: torch.Tensor) -> int:
    """The raw handle of the current stream on ``t``'s card: the launchers'
    stream argument, without building a ``torch.cuda.Stream`` a call."""
    return torch._C._cuda_getCurrentRawStream(t.get_device())


def check(rc: int, name: str) -> None:
    """Raise when a launcher reported a CUDA error."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")
