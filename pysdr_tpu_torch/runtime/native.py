"""ctypes bindings for the C++ host runtime (native/sdrio.cpp).

Provides NativeRing (lock-free SPSC ring) and NativeStreamer (background
.dat file reader with format conversion) with the same API shape as the
Python RingBuffer / io.datfile.DatReader. Builds libsdrio.so from the
port's native/sdrio.cpp into pysdr_tpu_torch/build/ on first use if a
compiler is available; falls back cleanly (available() == False)
otherwise. No pybind11 in this image — plain C ABI + ctypes.

The port's own copy of pysdr_tpu/runtime/native.py, with its imports
rewritten to pysdr_tpu_torch: the port imports nothing of the JAX package.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Callable

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_DIR = os.path.join(_PKG, "native")
_LIB_PATH = os.path.join(_PKG, "build", "libsdrio.so")
_lib = None
_load_failed = False      # remember a failed build/dlopen: the rtl_tcp
_build_lock = threading.Lock()   # hot path must not re-spawn make per block


_HASH_PATH = _LIB_PATH + ".srchash"
# the C++ quantizer of each integer RF wire's dtype (wire_quantizer)
_WIRE_QUANTIZERS = {np.dtype(np.int8): "psdr_quantize_wire_i8",
                    np.dtype(np.int16): "psdr_quantize_wire_i16"}


def _src_hash() -> str:
    """Content hash of the C++ source. Stored next to the .so at build
    time; staleness is hash inequality, not mtime comparison (a fresh
    git checkout gives arbitrary mtimes)."""
    import hashlib
    h = hashlib.sha256()
    with open(os.path.join(_DIR, "sdrio.cpp"), "rb") as f:
        h.update(f.read())
    return h.hexdigest()


def _build() -> bool:
    try:
        # -B: _build is only reached when the lib is missing or its
        # source hash mismatches — make's own mtime rule may consider a
        # hash-stale .so "up to date" (arbitrary checkout mtimes), and a
        # no-op make here would stamp the new hash onto the old binary.
        # Built under a name of this process and renamed into place, so a
        # process loading the library never sees a half-written one
        os.makedirs(os.path.dirname(_LIB_PATH), exist_ok=True)
        tmp = f"{_LIB_PATH}.{os.getpid()}.tmp"
        subprocess.run(["make", "-C", _DIR, "-s", "-B", f"OUT={tmp}"],
                       check=True, capture_output=True, timeout=120)
        ok = os.path.exists(tmp)
        if ok:
            os.replace(tmp, _LIB_PATH)
            with open(_HASH_PATH, "w") as f:
                f.write(_src_hash())
        return ok
    except Exception:
        return False


def _stale() -> bool:
    """True when the built library does not match the current source
    content (missing hash sidecar counts as unknown => stale)."""
    try:
        with open(_HASH_PATH) as f:
            return f.read().strip() != _src_hash()
    except OSError:
        return True


def _load():
    global _lib, _load_failed
    with _build_lock:
        if _lib is not None:
            return _lib
        if _load_failed:
            return None
        if (not os.path.exists(_LIB_PATH) or _stale()) and not _build():
            # a stale library that failed to rebuild is UNAVAILABLE:
            # loading a binary that no longer matches the source is
            # worse than the numpy fallback
            _load_failed = True
            return None
        try:
            lib = ctypes.CDLL(_LIB_PATH)
        except OSError:
            _load_failed = True
            return None
        fp = ctypes.POINTER(ctypes.c_float)
        lib.psdr_rb_create.restype = ctypes.c_void_p
        lib.psdr_rb_create.argtypes = [ctypes.c_size_t]
        lib.psdr_rb_destroy.argtypes = [ctypes.c_void_p]
        lib.psdr_rb_push.restype = ctypes.c_size_t
        lib.psdr_rb_push.argtypes = [ctypes.c_void_p, fp, ctypes.c_size_t]
        lib.psdr_rb_pull.restype = ctypes.c_size_t
        lib.psdr_rb_pull.argtypes = [ctypes.c_void_p, fp, ctypes.c_size_t]
        lib.psdr_rb_count.restype = ctypes.c_size_t
        lib.psdr_rb_count.argtypes = [ctypes.c_void_p]
        lib.psdr_rb_capacity.restype = ctypes.c_size_t
        lib.psdr_rb_capacity.argtypes = [ctypes.c_void_p]
        lib.psdr_rb_overflows.restype = ctypes.c_uint64
        lib.psdr_rb_overflows.argtypes = [ctypes.c_void_p]
        lib.psdr_streamer_open.restype = ctypes.c_void_p
        lib.psdr_streamer_open.argtypes = [ctypes.c_char_p, ctypes.c_size_t,
                                           ctypes.c_int]
        lib.psdr_streamer_read.restype = ctypes.c_size_t
        lib.psdr_streamer_read.argtypes = [ctypes.c_void_p, fp,
                                           ctypes.c_size_t]
        lib.psdr_streamer_available.restype = ctypes.c_size_t
        lib.psdr_streamer_available.argtypes = [ctypes.c_void_p]
        lib.psdr_streamer_fs.restype = ctypes.c_double
        lib.psdr_streamer_fs.argtypes = [ctypes.c_void_p]
        lib.psdr_streamer_fc.restype = ctypes.c_double
        lib.psdr_streamer_fc.argtypes = [ctypes.c_void_p]
        lib.psdr_streamer_eof.restype = ctypes.c_int
        lib.psdr_streamer_eof.argtypes = [ctypes.c_void_p]
        lib.psdr_streamer_close.argtypes = [ctypes.c_void_p]
        for name in ("psdr_convert_cs16", "psdr_convert_cs8"):
            getattr(lib, name).argtypes = [ctypes.c_void_p, fp,
                                           ctypes.c_size_t, ctypes.c_float]
        lib.psdr_convert_cu8.argtypes = [ctypes.c_void_p, fp, ctypes.c_size_t]
        for name in _WIRE_QUANTIZERS.values():
            getattr(lib, name).argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                           ctypes.c_size_t, ctypes.c_float]
        _lib = lib
        return lib


def available() -> bool:
    return _load() is not None


def convert_cu8(raw: np.ndarray) -> np.ndarray | None:
    """CU8 byte stream -> float32 packed pairs via the C++ converter
    ((u8 - 127.5)/127.5, the RTL ADC convention shared with the file
    streamer). Returns None when the native library is unavailable so
    callers can fall back to the numpy LUT."""
    lib = _load()
    if lib is None:
        return None
    raw = np.ascontiguousarray(raw, np.uint8)
    out = np.empty(raw.size, np.float32)
    lib.psdr_convert_cu8(
        raw.ctypes.data_as(ctypes.c_void_p), _as_fp(out), raw.size)
    return out.reshape(-1, 2)


def wire_quantizer(dtype) -> Callable[[np.ndarray, int, float], None] | None:
    """The C++ one-pass quantizer to an integer RF wire (dtype int8 or
    int16), or None for any other dtype or where the library is
    unavailable. quantize(xp, addr, s) writes round-half-even(clip(xp * s,
    -s, s)) of the C-contiguous float32 array xp, xp.size codes, to the
    buffer at address addr: ops/cplx.quantize_host's codes bit for bit.
    Loads (and if need be builds) the library now, not at the first
    call."""
    name = _WIRE_QUANTIZERS.get(np.dtype(dtype))
    lib = _load() if name is not None else None
    if lib is None:
        return None
    fn = getattr(lib, name)

    def quantize(xp: np.ndarray, addr: int, s: float) -> None:
        fn(xp.ctypes.data, addr, xp.size, s)
    return quantize


def _as_fp(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


class NativeRing:
    """Lock-free SPSC complex-sample ring (C++)."""

    def __init__(self, tag: str, size: int):
        lib = _load()
        if lib is None:
            raise RuntimeError("native library unavailable")
        self._lib = lib
        self.tag = tag
        self._h = lib.psdr_rb_create(size)
        self.size = size

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.psdr_rb_destroy(self._h)
            self._h = None

    @property
    def nsamps(self) -> int:
        return self._lib.psdr_rb_count(self._h)

    @property
    def overflows(self) -> int:
        return self._lib.psdr_rb_overflows(self._h)

    def push(self, x) -> int:
        """x: complex64 array or float32 (n, 2) packed pairs."""
        x = np.ascontiguousarray(x)
        if np.iscomplexobj(x):
            x = x.astype(np.complex64).view(np.float32).reshape(-1, 2)
        n = len(x)
        return self._lib.psdr_rb_push(self._h, _as_fp(x), n)

    def pull(self, n: int) -> np.ndarray:
        out = np.empty((n, 2), np.float32)
        got = self._lib.psdr_rb_pull(self._h, _as_fp(out), n)
        return out[:got].view(np.complex64).reshape(-1)

    def ready(self, n: int) -> bool:
        return self.nsamps >= n


class NativeStreamer:
    """Background-threaded .dat replay with CS8/CS16/CU8 -> float
    conversion in C++ (the host-throughput path for >100 Msamp/s replay —
    SURVEY.md §7 'real-time-ish host I/O')."""

    def __init__(self, path: str, ring_samples: int = 1 << 22,
                 loop: bool = False):
        lib = _load()
        if lib is None:
            raise RuntimeError("native library unavailable")
        self._lib = lib
        self._h = lib.psdr_streamer_open(path.encode(), ring_samples,
                                         1 if loop else 0)
        if not self._h:
            raise IOError(f"cannot open {path}")

    @property
    def srate(self) -> float:
        return self._lib.psdr_streamer_fs(self._h)

    @property
    def fc(self) -> float:
        return self._lib.psdr_streamer_fc(self._h)

    def read_packed(self, n: int) -> np.ndarray:
        """Read n samples as float32 (n, 2) packed pairs (ready for
        jax.device_put without any host complex math). np.empty, not
        zeros: the C++ side overwrites every delivered sample and a
        fresh 5-50 MB zero page-faults per block."""
        out = np.empty((n, 2), np.float32)
        got = self._lib.psdr_streamer_read(self._h, _as_fp(out), n)
        return out[:got]

    def read_data(self, n: int, loop: bool = False) -> np.ndarray:
        return self.read_packed(n).view(np.complex64).reshape(-1)

    def close(self):
        if getattr(self, "_h", None):
            self._lib.psdr_streamer_close(self._h)
            self._h = None

    def __del__(self):
        self.close()
