"""The streaming executive: source -> device -> bank -> sinks
(counterpart of pysdr_tpu/runtime/executive.py, same surface: run,
post, stop, stage_report, run_in_thread).

Per block the host reads (and wire-quantizes) the next IQ chunk while the
device computes the current one: CUDA kernels run asynchronously and the
step never waits on the card (its constants live on the device). A
bank's step (ReceiverBank, ChannelizerBank) is one CUDA graph replay a
block, a --mesh adapter's one replay a shard, captured by `prepare`
before the prefetch thread starts (a capture fails if another thread
works on the card meanwhile). Right after a block's step is issued, its
audio wire (the step's static output, rewritten by the next step)
starts copying into pinned host memory with one CUDA event a device
(start_host_copy, the reference's copy_to_host_async), so the drain of
block k-D waits for that block's copy alone, not for the steps and
uploads queued after it.
Uploads go through pinned host memory with a non_blocking copy. Control
mutations arrive through a thread-safe queue and are applied between
blocks as writes into the bank's params; each copies the new params up
from pageable memory, a sync of its own between blocks.
"""

from __future__ import annotations

import queue
import sys
import threading
import time
import traceback
from collections import deque
from typing import Callable

import numpy as np
import torch

from pysdr_tpu_torch.ops import cplx
from pysdr_tpu_torch.runtime.profiler import BlockProfiler
from pysdr_tpu_torch.runtime.ringbuffer import RingBuffer

# the RF wire's dtype on the device, as upload() moves it
WIRE_TORCH_DTYPES = {"f32": torch.float32, "i16": torch.int16,
                     "i8": torch.int8}


def upload(q: torch.Tensor, device: torch.device) -> torch.Tensor:
    """A host wire block onto `device`: on a card, copied into pinned
    memory (PyTorch's caching host allocator) and issued as a non_blocking
    copy; on the CPU, the block itself."""
    if device.type != "cuda":
        return q
    pinned = torch.empty(q.shape, dtype=q.dtype, pin_memory=True)
    pinned.copy_(q)
    return pinned.to(device, non_blocking=True)


def start_host_copy(audio_w):
    """Start a step's audio wire (a tensor, or a tuple of one a shard)
    copying to the host right after dispatch (the reference's
    copy_to_host_async). A CUDA piece goes to pinned memory from the
    caching host allocator with a non_blocking copy, which holds its block
    until the copy is done; one CUDA event a device follows its copies. A
    CPU piece is copied too: the bank's next step rewrites its output.
    Returns (host pieces shaped as audio_w, events)."""
    one = isinstance(audio_w, torch.Tensor)
    pieces = [audio_w] if one else list(audio_w)
    host = [p.to("cpu", non_blocking=True) if p.is_cuda else p.clone()
            for p in pieces]
    events = []
    for dev in dict.fromkeys(p.device for p in pieces if p.is_cuda):
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(dev))
        events.append(ev)
    return (host[0] if one else tuple(host)), events


def drain(bank, entry):
    """Wait for one block's host copy alone; (host audio complex64 (n_rx,
    out_block), the block's baseband from bank.baseband_from_wire, or
    None). entry: (start_host_copy's result, the step's baseband)."""
    (host_audio, events), bb = entry
    for ev in events:
        ev.synchronize()
    audio = bank.audio_from_wire(host_audio)
    return audio, None if bb is None else bank.baseband_from_wire(bb)


class Executive:
    def __init__(self, bank, source, audio_rings=None, realtime=False,
                 raw_writer=None, demod_writer=None,
                 psd_callback: Callable | None = None, loop_source=True,
                 wire: str = "f32", pipeline_depth: int = 2,
                 want_bb: bool = True, prefetch: bool = True):
        """bank: a models.receiver.ReceiverBank,
        models.channelizer_bank.ChannelizerBank or a parallel.adapter
        bank, driven only through design.{in_block, fs_in, fs_out}, n_rx,
        device, prepare, step_device, audio_from_wire, baseband_from_wire,
        _last_bb and the control methods post() names;
        source: anything with read_data(n) (DatReader / SynthSource) or
        read_packed(n);
        wire: "f32" | "i16" | "i8" RF format across host->device;
        pipeline_depth: device blocks in flight before the oldest drains;
        prefetch: read + quantize + upload the next blocks on a thread."""
        if wire not in ("f32", "i16", "i8"):
            raise ValueError(f"unknown wire {wire!r}")
        self.bank = bank
        self.source = source
        self.realtime = realtime
        self.loop_source = loop_source
        self.wire = wire
        self.pipeline_depth = max(1, int(pipeline_depth))
        self.want_bb = want_bb
        self.prefetch = prefetch
        self._pf_q: queue.Queue | None = None
        self._pf_thread: threading.Thread | None = None
        self._pf_error: BaseException | None = None
        # a block read but not dispatched when a run() ended (bound or
        # deadline): the next run() starts from it, so none is dropped
        self._held = None
        d = bank.design
        ring_size = 32 * 1024 * max(1, int(d.fs_out / 48e3))
        self.audio_rings = audio_rings or [
            RingBuffer(f"audio{i}", ring_size, "complex64")
            for i in range(bank.n_rx)]
        self.raw_writer = raw_writer
        self.demod_writer = demod_writer
        self.psd_callback = psd_callback
        self.profiler = BlockProfiler(d.in_block, d.fs_in)
        self._cmd_q: queue.Queue = queue.Queue()
        self._stop = threading.Event()
        self._pf_active = threading.Event()
        self.n_blocks = 0
        self.last_rf_block: np.ndarray | None = None
        # the drained block's baseband: a device tensor (n_rx, out_block)
        self.drained_bb = None
        # mean ms/block per stage: read = host source, upload = quantize
        # (the host's wire quantization) + pin+issue (the copy into pinned
        # memory and the host->device issue), dispatch = device step issue
        # (the block's copy into the step's static input and the graph's
        # replay), drain = result pull + sinks
        self.stage_ms = {"read": 0.0, "upload": 0.0, "quantize": 0.0,
                         "pin+issue": 0.0, "dispatch": 0.0, "drain": 0.0}

    def stage_report(self) -> dict:
        n = max(1, self.n_blocks)
        return {k: v / n for k, v in self.stage_ms.items()}

    # ---- control plane: thread-safe, applied at block boundaries ----

    def post(self, method, *args):
        """Queue a block-boundary mutation: a bank method name or a
        callable applied to the executive."""
        self._cmd_q.put((method, args))

    def _apply_pending(self):
        while True:
            try:
                method, args = self._cmd_q.get_nowait()
            except queue.Empty:
                return
            try:
                if callable(method):
                    method(self, *args)
                else:
                    getattr(self.bank, method)(*args)
            except Exception:  # noqa: BLE001 — one bad control command
                # must not kill the DSP thread
                print(f"executive: control command {method!r}{args!r} "
                      f"failed:\n{traceback.format_exc(limit=3)}",
                      file=sys.stderr, flush=True)

    # ---- source stage ----

    def _read_host_raw(self):
        """(float32 (n, 2) pairs, complex64 view) or None at stream end."""
        n = self.bank.design.in_block
        if hasattr(self.source, "read_packed"):
            xp = self.source.read_packed(n)
            if len(xp) < n:
                return None
            return xp, xp.view(np.complex64).reshape(-1)
        x = self.source.read_data(n, loop=self.loop_source) \
            if self.loop_source else self.source.read_data(n)
        x = np.asarray(x).reshape(-1)[:n]
        if len(x) < n:
            return None
        x = x.astype(np.complex64)
        return x.view(np.float32).reshape(-1, 2), x

    def _prepare(self, pair):
        """Wire quantization + host->device issue for a read pair."""
        if pair is None:
            return None
        t1 = time.perf_counter()
        q = torch.from_numpy(np.ascontiguousarray(
            cplx.quantize_host(pair[0], self.wire)))
        t2 = time.perf_counter()
        xb = upload(q, self.bank.device)
        t3 = time.perf_counter()
        self.stage_ms["quantize"] += (t2 - t1) * 1e3
        self.stage_ms["pin+issue"] += (t3 - t2) * 1e3
        self.stage_ms["upload"] += (t3 - t1) * 1e3
        return xb, pair[1]

    def _pf_loop(self):
        # each stage_ms key has one writer thread (read, upload, quantize
        # and pin+issue here when prefetch is on, dispatch and drain on
        # the executive thread)
        while not self._stop.is_set():
            if not self._pf_active.wait(timeout=0.2):
                continue           # paused between run() calls
            t0 = time.perf_counter()
            try:
                pair = self._read_host_raw()
                self.stage_ms["read"] += (time.perf_counter() - t0) * 1e3
                item = self._prepare(pair)
            except BaseException as e:  # noqa: BLE001 — surfaced by
                # _read_block on the executive thread
                self._pf_error = e
                item = None
            while not self._stop.is_set():
                try:
                    self._pf_q.put(item, timeout=0.2)
                    break
                except queue.Full:
                    continue
            if item is None:
                return                         # stream end / error

    def _read_block(self):
        """Next (device block, host complex64) or None at stream end."""
        if self._held is not None:
            item, self._held = self._held, None
            return item
        if self.prefetch:
            if self._pf_q is None:
                self._pf_q = queue.Queue(maxsize=2)
            if (self._pf_thread is None or not self._pf_thread.is_alive()) \
                    and self._pf_q.empty():
                self._pf_error = None
                self._pf_thread = threading.Thread(target=self._pf_loop,
                                                   daemon=True)
                self._pf_thread.start()
            while True:
                try:
                    item = self._pf_q.get(timeout=1.0)
                    break
                except queue.Empty:
                    if self._stop.is_set():
                        return None
                    if not self._pf_thread.is_alive():
                        item = None
                        break
            if item is None and self._pf_error is not None:
                err, self._pf_error = self._pf_error, None
                raise err
            return item
        t0 = time.perf_counter()
        pair = self._read_host_raw()
        self.stage_ms["read"] += (time.perf_counter() - t0) * 1e3
        return self._prepare(pair)

    # ---- the hot loop ----

    def prepare(self):
        """Capture the bank's step for this executive's wire blocks (a
        no-op once done): run() calls it before it starts the prefetch
        thread, and a caller may call it earlier, before other threads
        (a trace, services) start."""
        self.bank.prepare(WIRE_TORCH_DTYPES[self.wire],
                          self.bank.design.in_block)

    def run(self, n_blocks: int | None = None,
            duration_s: float | None = None):
        self.prepare()
        d = self.bank.design
        deadline = time.monotonic() + duration_s if duration_s else None
        block_budget = d.in_block / d.fs_in
        next_deadline = None

        def finish(entry):
            nonlocal next_deadline
            t0 = time.perf_counter()
            # waits for this block's host copy alone
            audio, self.drained_bb = drain(self.bank, entry)
            self.stage_ms["drain"] += (time.perf_counter() - t0) * 1e3
            for i, ring in enumerate(self.audio_rings):
                ring.push(audio[i])
            if self.demod_writer is not None:
                self.demod_writer.save_data(audio.T)
            if self.psd_callback is not None:
                self.psd_callback(self, audio)
            self.n_blocks += 1
            if self.realtime:
                # absolute schedule, debt clamped to one budget
                now = time.monotonic()
                if next_deadline is None:
                    next_deadline = now
                next_deadline += block_budget
                if now < next_deadline:
                    time.sleep(next_deadline - now)
                    self.profiler.discount(next_deadline - now)
                else:
                    next_deadline = max(next_deadline, now - block_budget)

        def wants_more(in_flight: int) -> bool:
            if self._stop.is_set():
                return False
            if n_blocks is not None and self.n_blocks + in_flight >= n_blocks:
                return False
            return not (deadline and time.monotonic() > deadline)

        pending: deque = deque()
        self._pf_active.set()
        try:
            item = self._read_block() if wants_more(0) else None
            while item is not None:
                self._apply_pending()
                with self.profiler:
                    xb, x = item
                    if self.raw_writer is not None:
                        self.raw_writer.save_data(x)
                    self.last_rf_block = x
                    t0 = time.perf_counter()
                    audio_w = self.bank.step_device(xb)      # async
                    bb = self.bank._last_bb if self.want_bb else None
                    # the host copy starts now, behind this step only
                    pending.append((start_host_copy(audio_w), bb))
                    self.stage_ms["dispatch"] += \
                        (time.perf_counter() - t0) * 1e3
                    # read the next block only if it will be dispatched
                    item = self._read_block() \
                        if wants_more(len(pending)) else None
                    if len(pending) > self.pipeline_depth:
                        finish(pending.popleft())            # block k-D
                if item is not None and not wants_more(len(pending)):
                    self._held, item = item, None            # deadline hit
            while pending:
                finish(pending.popleft())
            return self.profiler
        finally:
            self._pf_active.clear()

    def stop(self):
        """End the run, and wait (2 s at most) for the prefetch thread to
        leave: a process that exits while that thread is inside a device
        copy aborts in the interpreter's shutdown."""
        self._stop.set()
        t = self._pf_thread
        if t is not None and t is not threading.current_thread():
            t.join(timeout=2.0)

    def run_in_thread(self, **kw) -> threading.Thread:
        t = threading.Thread(target=self.run, kwargs=kw, daemon=True)
        t.start()
        return t
