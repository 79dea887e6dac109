"""Build and load the hand-written CUDA kernels (csrc/*.cu).

nvcc compiles the sources in this checkout into one shared library with a
plain C interface, loaded with ctypes (no PyTorch headers, so the build
takes seconds). The library lands in pysdr_tpu_torch/build/, named by a
hash of the sources and flags, so a changed source rebuilds and an
unchanged one is reused. Nothing is built at import time: the first call
of `library()` builds, and a missing nvcc or a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "build")
SOURCES = ("scan.cu",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_lib = None
build_seconds: float | None = None   # wall time of the last nvcc run


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and os.path.exists(os.path.join(cand, "bin", "nvcc")):
            return os.path.join(cand, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on "
                           "PATH): the CUDA kernels cannot be built")
    return found


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in sorted(os.listdir(CSRC)):
        if name.endswith((".cu", ".cuh")):
            with open(os.path.join(CSRC, name), "rb") as f:
                h.update(name.encode() + f.read())
    return h.hexdigest()[:16]


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.pysdr_linrec_f32.argtypes = [ptr] * 5 + [i32] * 4 + [ptr]
    lib.pysdr_linrec_f32.restype = i32
    lib.pysdr_sr_latch_u8.argtypes = [ptr] * 5 + [i32] * 3 + [ptr]
    lib.pysdr_sr_latch_u8.restype = i32
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    global _lib, build_seconds
    with _lock:
        if _lib is not None:
            return _lib
        out = os.path.join(BUILD_DIR, f"libpysdr_kernels_{_digest()}.so")
        if not os.path.exists(out):
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{out}.{os.getpid()}.tmp"
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
                   *(os.path.join(CSRC, s) for s in SOURCES)]
            t0 = time.perf_counter()
            res = subprocess.run(cmd, capture_output=True, text=True)
            build_seconds = time.perf_counter() - t0
            if res.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed ({res.returncode}):\n{' '.join(cmd)}\n"
                    f"{res.stdout}\n{res.stderr}")
            os.replace(tmp, out)
        _lib = _declare(ctypes.CDLL(out))
        return _lib
