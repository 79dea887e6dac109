"""Build and load the hand-written CUDA kernels (csrc/*.cu).

nvcc compiles the sources in this checkout into one shared library with a
plain C interface, loaded with ctypes (no PyTorch headers, so the build
takes seconds): one nvcc per source, all started together, then one link.
The library lands in pysdr_tpu_torch/build/, named by a hash of the
sources and flags, so a changed source rebuilds and an unchanged one is
reused. Nothing is built at import time: the first call of `library()`
builds, and a missing nvcc or a failed build raises. ptxas's register
and shared-memory report of each kernel is kept in `build_log`.

`check_tensors` and `check_launch` are the checks every wrapper makes
before and after its launch; `count_launch` counts the launch, or, while
a CUDA graph is captured under `capture_tally`, tallies it for the
graph, whose every replay adds the tally (kernels.add_launches).
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "build")
SOURCES = ("scan.cu", "pfb.cu", "rtty.cu")
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
              "-Xptxas=-v")

_lock = threading.Lock()
_lib = None
build_seconds: float | None = None   # wall time of the last build
build_log: str = ""                  # nvcc/ptxas output of the last build


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
    i64, f32 = ctypes.c_longlong, ctypes.c_float
    lib.pysdr_linrec_f32.argtypes = [ptr, f32, i64, i64, i32] + [ptr] * 4 \
        + [i32] * 4 + [ptr, i64, ptr, ctypes.c_uint, ptr]
    lib.pysdr_linrec_f32.restype = i32
    lib.pysdr_sr_latch_u8.argtypes = [ptr] * 5 + [i32] * 3 \
        + [ptr, i64, ptr, ctypes.c_uint, ptr]
    lib.pysdr_sr_latch_u8.restype = i32
    lib.pysdr_pfb_branch.argtypes = [ptr, i32, ctypes.c_float, ptr, ptr,
                                     ptr, ptr, i32, i32, i32, ptr]
    lib.pysdr_pfb_branch.restype = i32
    lib.pysdr_rtty_scores.argtypes = [ptr] * 7 + [i32] * 5 + [ptr]
    lib.pysdr_rtty_scores.restype = i32
    return lib


def _run(procs) -> None:
    """Wait for every (cmd, Popen); raise with the output of the first
    that failed."""
    global build_log
    failed = None
    for cmd, p in procs:
        out, _ = p.communicate()
        build_log += out
        if p.returncode != 0 and failed is None:
            failed = (cmd, p.returncode, out)
    if failed is not None:
        cmd, rc, out = failed
        raise RuntimeError(f"nvcc failed ({rc}):\n{' '.join(cmd)}\n{out}")


def _compile(out: str) -> None:
    """Every source to an object in parallel, then one shared library."""
    tmp = f"{out}.{os.getpid()}.d"
    os.makedirs(tmp, exist_ok=True)
    objs = [os.path.join(tmp, s + ".o") for s in SOURCES]
    nvcc = _nvcc()
    procs = []
    for src, obj in zip(SOURCES, objs):
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", obj, os.path.join(CSRC, src)]
        procs.append((cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    _run(procs)
    lib = os.path.join(tmp, "lib.so")
    cmd = [nvcc, *ARCH_FLAGS, "-shared", "-o", lib, *objs]
    _run([(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True))])
    os.replace(lib, out)
    shutil.rmtree(tmp, ignore_errors=True)


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    global _lib, build_seconds
    with _lock:
        if _lib is not None:
            return _lib
        out = os.path.join(BUILD_DIR, f"libpysdr_kernels_{_digest()}.so")
        if not os.path.exists(out):
            os.makedirs(BUILD_DIR, exist_ok=True)
            t0 = time.perf_counter()
            _compile(out)
            build_seconds = time.perf_counter() - t0
        _lib = _declare(ctypes.CDLL(out))
        return _lib


def check_tensors(*specs) -> None:
    """Each spec is (tensor, name, dtypes, shape). Raise ValueError unless
    every tensor is contiguous, of one of its dtypes and exactly its
    shape, and then unless every one lies on a CUDA device: a wrong dtype
    or shape raises wherever the tensors lie."""
    for x, name, dtypes, shape in specs:
        if not isinstance(x, torch.Tensor):
            raise ValueError(f"{name}: expected a tensor, got {type(x)}")
        if x.dtype not in dtypes:
            raise ValueError(f"{name}: expected "
                             f"{' or '.join(str(d) for d in dtypes)}, got "
                             f"{x.dtype}")
        if tuple(x.shape) != tuple(shape):
            raise ValueError(f"{name}: expected shape {tuple(shape)}, got "
                             f"{tuple(x.shape)}")
        if not x.is_contiguous():
            raise ValueError(f"{name}: must be contiguous")
    for x, name, _, _ in specs:
        if x.device.type != "cuda":
            raise ValueError(f"{name}: expected a CUDA tensor, got "
                             f"{x.device}")


def check_launch(rc: int, name: str) -> None:
    """Raise if a launch returned a CUDA error (a refused launch never
    runs, and no later synchronize reports it)."""
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError_t {rc}")


_tally = threading.local()


def count_launch(fn) -> None:
    """One launch of `fn`'s kernel: one more on fn.launches, or, while this
    thread captures a graph under capture_tally, on the capture's tally
    (a captured kernel runs at each replay, not now)."""
    counts = getattr(_tally, "counts", None)
    if counts is None:
        fn.launches += 1
    else:
        counts[fn.__name__] = counts.get(fn.__name__, 0) + 1


@contextlib.contextmanager
def capture_tally():
    """Within: this thread's wrapper launches go to the yielded dict
    {wrapper name: launches} instead of the wrappers' counts."""
    prev = getattr(_tally, "counts", None)
    _tally.counts = {}
    try:
        yield _tally.counts
    finally:
        _tally.counts = prev
