"""Thread-safe ring buffers for the streaming pipeline.

Equivalent of the reference's `ring_buffer2` (thread-safe ring with
push/pull/push_zeros/ready/clear/nsamps, reference usage receiver.py:72,848,
watchdog.py:153-197) and `ring_buffer3` (mp.Queue-backed cross-process
variant, pySDR.py:107-111). A C++ SPSC implementation with the same API is
in native/ (used automatically when built — see native.py); this module is
the pure-python fallback and the shared API definition.

The port's own copy of pysdr_tpu/runtime/ringbuffer.py, with its imports
rewritten to pysdr_tpu_torch: the port imports nothing of the JAX package.
"""

from __future__ import annotations

import threading

import numpy as np


class RingBuffer:
    """Lock-based ring over a numpy array. API mirrors the reference's
    ring_buffer2: push/pull/push_zeros/ready/clear/nsamps/size/tag."""

    def __init__(self, tag: str, size: int, dtype="complex64",
                 prevent_overflow: bool = False):
        self.tag = tag
        self.size = int(size)
        self.dtype = np.dtype(dtype)
        self.buf = np.zeros(self.size, self.dtype)
        self._r = 0
        self._w = 0
        self._count = 0
        self.overflows = 0
        self.underflows = 0
        self.prevent_overflow = prevent_overflow
        self._lock = threading.Lock()
        self._data_avail = threading.Condition(self._lock)

    @property
    def nsamps(self) -> int:
        with self._lock:
            return self._count

    def ready(self, n: int) -> bool:
        """True if n samples can be pulled (reference .ready)."""
        with self._lock:
            return self._count >= n

    def free(self) -> int:
        with self._lock:
            return self.size - self._count

    def push(self, x) -> int:
        """Append samples; drops oldest on overflow (unless
        prevent_overflow, which drops the incoming excess instead —
        matching the reference's PREVENT_OVERFLOW ctor flag)."""
        x = np.asarray(x, self.dtype).reshape(-1)
        n = len(x)
        with self._lock:
            if n >= self.size:
                x = x[-self.size:]
                n = len(x)
            space = self.size - self._count
            if n > space:
                self.overflows += 1
                if self.prevent_overflow:
                    x = x[:space]
                    n = space
                else:  # drop oldest
                    drop = n - space
                    self._r = (self._r + drop) % self.size
                    self._count -= drop
            end = min(n, self.size - self._w)
            self.buf[self._w:self._w + end] = x[:end]
            if n > end:
                self.buf[:n - end] = x[end:]
            self._w = (self._w + n) % self.size
            self._count += n
            self._data_avail.notify_all()
            return n

    def push_zeros(self, n: int):
        """Watchdog low-water refill (reference watchdog.py:188-201)."""
        self.push(np.zeros(n, self.dtype))

    def pull(self, n: int, timeout: float | None = None):
        """Remove and return n samples; blocks up to timeout if short
        (None = non-blocking: zero-pads, counts an underflow)."""
        with self._lock:
            if timeout is not None:
                self._data_avail.wait_for(lambda: self._count >= n,
                                          timeout=timeout)
            out = np.empty(n, self.dtype)
            avail = min(n, self._count)
            if avail < n:
                self.underflows += 1
                out[avail:] = 0
            end = min(avail, self.size - self._r)
            out[:end] = self.buf[self._r:self._r + end]
            if avail > end:
                out[end:avail] = self.buf[:avail - end]
            self._r = (self._r + avail) % self.size
            self._count -= avail
            return out

    def drop(self, n: int):
        """Discard n oldest samples (watchdog high-water recentring)."""
        with self._lock:
            n = min(n, self._count)
            self._r = (self._r + n) % self.size
            self._count -= n

    def clear(self):
        with self._lock:
            self._r = self._w = self._count = 0

    def depth_fraction(self) -> float:
        with self._lock:
            return self._count / self.size
