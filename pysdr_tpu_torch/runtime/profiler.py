"""Block-rate profiling against the real-time frame budget.

Equivalent of the reference `Profiler` (duty-cycled cProfile printed
against the nominal frame time, reference profiler.py:27-46): samples/s
and realtime factor per block.

The port's own copy of BlockProfiler from pysdr_tpu/runtime/profiler.py.
Its `jax_trace` becomes `torch_trace`, a torch.profiler trace of the run
(`--jax-trace DIR`); `Stopwatch`, which the port does not use, is left
out.
"""

from __future__ import annotations

import contextlib
import os
import time


class BlockProfiler:
    """Rolling block-time statistics vs the real-time budget."""

    def __init__(self, samples_per_block: int, fs: float, window: int = 50):
        self.spb = samples_per_block
        self.fs = fs
        self.budget_s = samples_per_block / fs  # nominal frame time
        self.window = window
        self._times = []
        self.n_blocks = 0
        self._t0 = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def discount(self, dt: float):
        """Exclude dt seconds (e.g. a realtime pacing sleep) from the
        currently-open measurement, so mean_block_s reflects work, not
        idle time."""
        if self._t0 is not None:
            self._t0 += dt

    def __exit__(self, *exc):
        dt = time.perf_counter() - self._t0
        self._times.append(dt)
        if len(self._times) > self.window:
            self._times.pop(0)
        self.n_blocks += 1

    @property
    def mean_block_s(self) -> float:
        return sum(self._times) / max(1, len(self._times))

    @property
    def realtime_factor(self) -> float:
        """>1 means faster than real time."""
        m = self.mean_block_s
        return self.budget_s / m if m > 0 else float("inf")

    @property
    def samples_per_s(self) -> float:
        m = self.mean_block_s
        return self.spb / m if m > 0 else float("inf")

    def report(self) -> str:
        return (f"{self.n_blocks} blocks, {self.mean_block_s*1e3:.2f} ms/block "
                f"(budget {self.budget_s*1e3:.2f} ms), "
                f"{self.realtime_factor:.1f}x realtime, "
                f"{self.samples_per_s/1e6:.2f} Msamp/s")


@contextlib.contextmanager
def torch_trace(log_dir: str):
    """torch.profiler trace of the enclosed run, CPU and (when a card is
    present) CUDA activity, exported as a Chrome trace
    `log_dir/trace_<pid>.json` (open with Perfetto or chrome://tracing);
    the counterpart of pysdr_tpu's jax_trace (the trace hook points the
    reference comments out, pySDR.py:170-171)."""
    import torch
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(
        os.path.join(log_dir, f"trace_{os.getpid()}.json"))
