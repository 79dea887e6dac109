"""Memory monitor: periodic RSS snapshots to a log file.

Equivalent of the reference's `utilities.Memory_Monitor
('/tmp/SDR_MEMORY.TXT')` + `take_snapshot()` driven from the watchdog
(reference pySDR.py:224-225, watchdog.py:293-294) — the tool that caught
the reference's multi-hour waterfall leak (README.md:272-275).

The port's own copy of pysdr_tpu/runtime/memmon.py, with its imports
rewritten to pysdr_tpu_torch: the port imports nothing of the JAX package.
"""

from __future__ import annotations

import os
import time

_PAGE = os.sysconf("SC_PAGE_SIZE") if hasattr(os, "sysconf") else 4096


def rss_bytes() -> int:
    """Resident set size of this process (Linux /proc)."""
    try:
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * _PAGE
    except OSError:
        return 0


class MemoryMonitor:
    def __init__(self, path: str | None = "/tmp/SDR_MEMORY.TXT"):
        self.path = path
        self.peak_bytes = 0
        self.snapshots: list[tuple[float, int]] = []
        self._f = open(path, "a") if path else None
        self._t0 = time.time()

    def take_snapshot(self) -> int:
        rss = rss_bytes()
        t = time.time()
        self.peak_bytes = max(self.peak_bytes, rss)
        self.snapshots.append((t, rss))
        if self._f:
            self._f.write(f"{t - self._t0:10.1f}  {rss / 2**20:10.1f} MB  "
                          f"peak {self.peak_bytes / 2**20:10.1f} MB\n")
            self._f.flush()
        return rss

    def growth_mb(self) -> float:
        """RSS growth since the first snapshot (leak indicator)."""
        if len(self.snapshots) < 2:
            return 0.0
        return (self.snapshots[-1][1] - self.snapshots[0][1]) / 2**20

    def close(self):
        if self._f:
            self._f.close()
            self._f = None
