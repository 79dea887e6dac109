"""Ring-buffer watermark watchdog + latency logger.

Equivalent of the reference `WatchDog.Monitor` (reference watchdog.py:
ring-buffer latency EMA 165-173; high-water drop / low-water zero-fill
188-201; dead-man ItsAlive timer 240-268; CSV latency log 176-227 analyzed
by sigs/plot_latency.m). Runs as a plain repeating timer thread over the
runtime ring buffers; self-healing keeps the audio sink between the low and
high watermarks.

The port's own copy of pysdr_tpu/runtime/watchdog.py, with its imports
rewritten to pysdr_tpu_torch: the port imports nothing of the JAX package.
"""

from __future__ import annotations

import dataclasses
import threading
import time


@dataclasses.dataclass
class WatchdogStats:
    tag: str
    depth: float = 0.5
    latency_ema_s: float = 0.0
    drops: int = 0
    zero_fills: int = 0
    overflows: int = 0
    underflows: int = 0


class WatchDog:
    def __init__(self, ring, fs: float, period_s: float = 2.0,
                 low: float = 0.25, high: float = 0.75,
                 target: float = 0.5, log_path: str | None = None,
                 ema: float = 0.2):
        self.ring, self.fs = ring, fs
        self.period_s, self.low, self.high, self.target = \
            period_s, low, high, target
        self.stats = WatchdogStats(tag=ring.tag)
        self._ema = ema
        self._log = open(log_path, "a") if log_path else None
        self._timer = None
        self._stopped = threading.Event()
        self.last_alive = time.monotonic()

    def check_once(self):
        """One monitor pass (reference Monitor body)."""
        rb = self.ring
        depth = rb.depth_fraction()
        latency = rb.nsamps / self.fs
        s = self.stats
        s.depth = depth
        s.latency_ema_s = ((1 - self._ema) * s.latency_ema_s
                           + self._ema * latency)
        s.overflows, s.underflows = rb.overflows, rb.underflows
        if depth > self.high:        # high-water: drop to recentre
            n = int((depth - self.target) * rb.size)
            rb.drop(n)
            s.drops += 1
            self._log_event("HIGH", n)
        elif depth < self.low:       # low-water: push zeros
            n = int((self.target - depth) * rb.size)
            rb.push_zeros(n)
            s.zero_fills += 1
            self._log_event("LOW", n)
        if self._log:
            self._log.write(f"{rb.tag},{time.time():.3f},{rb.nsamps},"
                            f"{latency:.4f},{s.latency_ema_s:.4f}\n")
            self._log.flush()
        self.last_alive = time.monotonic()

    def _log_event(self, kind, n):
        if self._log:
            self._log.write(f"#{kind},{self.ring.tag},{time.time():.3f},"
                            f"{n}\n")

    def alive(self, max_age_s: float | None = None) -> bool:
        """Dead-man check (reference ItsAlive, watchdog.py:240-268)."""
        max_age = max_age_s if max_age_s is not None else 3 * self.period_s
        return (time.monotonic() - self.last_alive) < max_age

    def start(self):
        def tick():
            if self._stopped.is_set():
                return
            try:
                self.check_once()
            except Exception:  # noqa: BLE001 — a one-off failure (log
                # disk full, ring torn down) must not silently end the
                # self-rescheduling chain: the watchdog IS the safety net
                import sys
                import traceback
                print(f"watchdog {self.stats.tag}: check failed: "
                      f"{traceback.format_exc(limit=1)}",
                      file=sys.stderr, flush=True)
            self._timer = threading.Timer(self.period_s, tick)
            self._timer.daemon = True
            self._timer.start()
        tick()

    def stop(self):
        self._stopped.set()
        if self._timer:
            self._timer.cancel()
        if self._log:
            # a timer-thread pass may be mid-write: detach before close
            log, self._log = self._log, None
            log.close()


class PairWatchDog(WatchDog):
    """Atomic watermark control for a stereo L/R ring pair.

    A StereoPairRing (runtime/audio.py) pulls both rings in lockstep, so
    recentring one ring without its partner permanently skews L/R sample
    alignment (ADVICE r2 #2). This watchdog evaluates the pair's combined
    state and applies the SAME drop / zero-fill count to every ring in one
    pass, preserving relative alignment."""

    def __init__(self, rings, fs: float, **kw):
        super().__init__(rings[0], fs, **kw)
        self.rings = list(rings)
        self.stats.tag = "+".join(r.tag for r in self.rings)

    def check_once(self):
        depths = [r.depth_fraction() for r in self.rings]
        # the consumer is gated on min(nsamps): the emptiest ring sets the
        # pair's effective latency; the fullest sets overflow risk
        depth = min(depths)
        latency = min(r.nsamps for r in self.rings) / self.fs
        s = self.stats
        s.depth = depth
        s.latency_ema_s = ((1 - self._ema) * s.latency_ema_s
                           + self._ema * latency)
        s.overflows = sum(r.overflows for r in self.rings)
        s.underflows = sum(r.underflows for r in self.rings)
        size = min(r.size for r in self.rings)
        if max(depths) > self.high:     # drop the same n from BOTH rings
            # the SAME count must actually be applicable to both: clamp
            # to the emptiest ring's backlog, or the clamped drop on one
            # side would skew L/R alignment — the thing this class exists
            # to prevent
            n = int((max(depths) - self.target) * size)
            n = min(n, min(r.nsamps for r in self.rings))
            if n > 0:
                for r in self.rings:
                    r.drop(n)
                s.drops += 1
                self._log_event("HIGH", n)
        elif depth < self.low:          # zero-fill both by the same n
            n = int((self.target - depth) * size)
            n = min(n, min(r.size - r.nsamps for r in self.rings))
            if n > 0:
                for r in self.rings:
                    r.push_zeros(n)
                s.zero_fills += 1
                self._log_event("LOW", n)
        if self._log:
            self._log.write(f"{s.tag},{time.time():.3f},"
                            f"{min(r.nsamps for r in self.rings)},"
                            f"{latency:.4f},{s.latency_ema_s:.4f}\n")
            self._log.flush()
        self.last_alive = time.monotonic()
