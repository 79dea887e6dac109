"""Block-rate profiling against the real-time frame budget.

Equivalent of the reference `Profiler` (duty-cycled cProfile printed
against the nominal frame time, reference profiler.py:27-46): samples/s
and realtime factor per block.

The port's own copies of BlockProfiler and Stopwatch from
pysdr_tpu/runtime/profiler.py. Its `jax_trace` becomes `torch_trace`, a
torch.profiler trace of the run (`--jax-trace DIR`).

`timed_steps` and `profile_steps` time a bank's device step on the card
(CUDA events; torch.profiler's kernel time against the host's wall
time): the step measurements that chip_smoke.py and pysdr_tpu_torch.bench
share, the counterpart of the JAX package's probes/profile_device_step.py.

`BlockSpan` is the executive's record of one block's life, always on, and
`stage_range` puts each of its stages on a recording torch.profiler's
timeline as a `pysdr.<stage>#<block id>` range.
"""

from __future__ import annotations

import contextlib
import os
import sys
import time

import torch
from torch.autograd import profiler as _autograd_profiler

# perf_counter_ns marks of a block's life, in order: read0 (the source
# read begins), arrival (it returned), quantized, issued (pin+issue
# done), taken (the executive got it), dispatch0/dispatch1 (around the
# step's issue and its host copies' start), drain0, waited (its copies'
# events synchronised), decoded (audio_from_wire done), pushed (ring
# pushes and writers done, before the per-block callback)
BLOCK_MARKS = ("read0", "arrival", "quantized", "issued", "taken",
               "dispatch0", "dispatch1", "drain0", "waited", "decoded",
               "pushed")
# a block's stages: (stage, from mark, to mark, tiles, summed). The tiling
# stages run one mark to the next from arrival to pushed; read, upload
# and drain span others. The executive's stage_ms sums the summed ones
# over its drained blocks. quantize is the staging tensor's allocation
# (pinned on a card) and the wire codes' write into it, pin+issue the
# host->device copy's issue. control is the take to the dispatch: the
# control commands, the raw writer and, where this take released one,
# the released block's drain, push and per-block callback (psd_callback,
# the App's display and RTTY taps; with realtime, the pacing sleep); hold
# is the wait of a dispatched block for its drain. While the executive's
# next block is not ready (the prefetch queue empty, as in a live
# stream), a block drains as soon as the executive's poll finds its
# copies done (its hold is that wait, its callback runs in the
# executive's idle time); once the next block is ready, or without
# prefetch, the take of block id + pipeline_depth + 1 starts it
BLOCK_STAGES = (
    # stage        from         to           tiles  summed
    ("read",       "read0",     "arrival",   False, True),
    ("quantize",   "arrival",   "quantized", True,  True),
    ("pin+issue",  "quantized", "issued",    True,  True),
    ("upload",     "arrival",   "issued",    False, True),
    ("handoff",    "issued",    "taken",     True,  True),
    ("control",    "taken",     "dispatch0", True,  False),
    ("dispatch",   "dispatch0", "dispatch1", True,  True),
    ("hold",       "dispatch1", "drain0",    True,  True),
    ("drain_wait", "drain0",    "waited",    True,  True),
    ("decode",     "waited",    "decoded",   True,  True),
    ("drain",      "drain0",    "decoded",   False, True),
    ("push",       "decoded",   "pushed",    True,  False))


class BlockSpan:
    """One block's life in the executive: its id (the source's read order,
    from 0 an executive), a perf_counter_ns mark at each boundary
    (BLOCK_MARKS), `released_by` (the id of the block whose take started
    this block's drain, None where no take did: a block drained while the
    executive waited for its next block, and the run's last blocks)."""

    __slots__ = ("id", *BLOCK_MARKS, "released_by")

    def __init__(self, block_id):
        self.id = block_id
        self.released_by = None

    def stages_ms(self) -> dict:
        """{stage: ms} of every BLOCK_STAGES row; the tiling stages sum to
        pushed - arrival."""
        return {s: (getattr(self, b) - getattr(self, a)) / 1e6
                for s, a, b, _, _ in BLOCK_STAGES}


_NO_RANGE = contextlib.nullcontext()
# a FUNCTION-scope range, on the host's timeline alone: the profiler
# mirrors a record_function (a user annotation) around device work onto
# the device's timeline, where a trace would count it as device activity
_RANGE = torch._C._profiler._RecordFunctionFast


def stage_range(stage: str, block_id):
    """The range `pysdr.<stage>#<block_id>` while a torch.profiler records
    (the profiler's own process-wide flag), else a shared no-op context:
    with no profiler, no range is entered."""
    if not _autograd_profiler._is_profiler_enabled:
        return _NO_RANGE
    return _RANGE(f"pysdr.{stage}#{block_id}")


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
    reference comments out, pySDR.py:170-171). It records every thread,
    so the executive's prefetch thread's `pysdr.*` ranges are in it too
    (a profiler records the thread that started it alone by default)."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    every_thread = torch._C._profiler._ExperimentalConfig(
        profile_all_threads=True)
    with torch.profiler.profile(activities=acts,
                                experimental_config=every_thread) as prof:
        yield prof
    prof.export_chrome_trace(
        os.path.join(log_dir, f"trace_{os.getpid()}.json"))


class Stopwatch:
    """Profiler2 equivalent: start/stop with accumulated wall time."""

    def __init__(self, tag: str = ""):
        self.tag = tag
        self.total_s = 0.0
        self.count = 0
        self._t0 = None

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self) -> float:
        dt = time.perf_counter() - self._t0
        self.total_s += dt
        self.count += 1
        return dt


def timed_steps(bank, xbs):
    """CUDA-event time of bank.step_device per block, each step under
    sync debug mode "error" (any blocking copy or stream sync inside it
    raises), after the bank has captured its step for the blocks' wire
    (bank.prepare: the capture itself synchronizes). Returns (a copy of
    each step's output, ms per step)."""
    for xb in xbs:
        bank.prepare(xb.dtype, xb.shape[0])
    outs, step_ms = [], []
    for xb in xbs:
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = bank.step_device(xb)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        b.record()
        b.synchronize()
        step_ms.append(a.elapsed_time(b))
        # the step's output is rewritten by the next step
        outs.append(out.clone())
    return outs, step_ms


# the hand-written kernels whose own device time profile_steps prints
HAND_KERNELS = ("pfb_branch", "linrec", "sr_latch")


def profile_steps(bank, xbs, out=None) -> dict:
    """torch.profiler over bank.step_device on each block of xbs: prints
    the profiler's table, each hand kernel's launches and device time, and
    a summary line to `out` (default stdout). Busy is the kernels' self
    device time; the idle share is 1 - busy / the host's wall time a step,
    which includes the profiler's own host cost. A replayed CUDA graph's
    kernels are listed one by one, as eager ones (CUPTI records each),
    so a graphed step counts and times the kernels it replays.
    Returns {kernels_per_step, device_busy_ms, host_wall_ms,
    device_idle_share}."""
    out = out or sys.stdout
    for xb in xbs:
        bank.prepare(xb.dtype, xb.shape[0])      # no capture in the window
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for xb in xbs:
            bank.step_device(xb)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / len(xbs)
    ka = prof.key_averages()
    print(ka.table(sort_by="device_time_total", row_limit=12), file=out,
          flush=True)
    # kernels only: an aten op's self device time repeats its kernels'
    kern = [e for e in ka
            if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kern) / len(xbs) / 1e3
    n_kern = sum(e.count for e in kern) / len(xbs)
    # the hand-written kernels' own device time, without the wrapper's
    # host cost that CUDA events around a call include
    for e in kern:
        name = next((k for k in HAND_KERNELS if f"{k}_kernel" in e.key),
                    None)
        if name:
            print(f"  {name} kernel: {e.count} launches, device "
                  f"{e.self_device_time_total / e.count:.3f} us each",
                  file=out, flush=True)
    idle = max(0.0, 1 - busy_ms / 1e3 / wall)
    print(f"profiled step ({len(xbs)} steps): {n_kern:.0f} kernels, "
          f"device busy {busy_ms:.3f} ms, host wall {wall * 1e3:.3f} ms, "
          f"device idle share {idle:.3f}", file=out, flush=True)
    return {"kernels_per_step": n_kern, "device_busy_ms": busy_ms,
            "host_wall_ms": wall * 1e3, "device_idle_share": idle}
