"""The streaming executive: source -> device -> bank -> sinks
(counterpart of pysdr_tpu/runtime/executive.py, same surface: run,
post, stop, stage_report, run_in_thread).

The host reads and stages the next IQ chunk while the device computes
the current one: CUDA kernels run asynchronously and the step never
waits on the card. A bank's step is one CUDA graph replay a block (a
--mesh adapter's, one a shard), captured by `prepare` before the
prefetch thread starts (a capture fails if another thread works on the
card meanwhile). Right after a block's step is issued, its audio wire
(the step's static output, rewritten by the next step), and its
baseband when the caller reads that on the host, start copying to the
host (start_host_copy), so a block's drain waits for that block's copies
alone, not for the steps and uploads queued after it; the same events
tell a consumer of the baseband on the card (the RTTY decoder, on its
own stream) when the block's baseband is valid.

While the next block is not ready (the prefetch queue empty, as in a
live stream), the executive waits on one condition until the oldest
block's copies are done or the prefetch thread has handed over an item
(the next block, or the stream's end), and drains that block at once in
the first case. Both ends notify it: the copy waiter, a thread that
synchronises each dispatched block's copy events in dispatch order, once
a block's copies are done, and the prefetch thread after each put; no
timer wakes the executive. Once the next block is ready, or without
prefetch (the read runs on the executive's thread, which cannot see
whether it would wait), block k drains at the take of block k +
pipeline_depth + 1, so at most pipeline_depth + 1 blocks are in flight
and their steps overlap on the device.

Control mutations arrive through a thread-safe queue and are applied
between blocks as writes into the bank's params; each copies the new
params up from pageable memory, a sync of its own between blocks.

Each block read gets an id (the source's read order) and a record
(profiler.BlockSpan, whose stages profiler.BLOCK_STAGES names): the last
4096 drained blocks' records stay in `block_spans`, and `stage_ms` sums
their stages. While a torch.profiler records, each stage is also a
`pysdr.<stage>#<id>` range.
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
from pysdr_tpu_torch.runtime import native
from pysdr_tpu_torch.runtime.profiler import (BLOCK_STAGES, BlockProfiler,
                                               BlockSpan, stage_range)
from pysdr_tpu_torch.runtime.ringbuffer import RingBuffer

# the stages stage_ms sums over the drained blocks
SUMMED_STAGES = tuple(s for s, _, _, _, summed in BLOCK_STAGES if summed)


def staging(shape, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """An empty host tensor to write a wire block bound for `device` into:
    on a card, pinned (PyTorch's caching host allocator), so that
    upload's copy runs asynchronously."""
    return torch.empty(shape, dtype=dtype, pin_memory=device.type == "cuda")


def upload(q: torch.Tensor, device: torch.device) -> torch.Tensor:
    """A wire block written into staging() onto `device`: on a card, a
    non_blocking copy; on the CPU, the block itself."""
    return q.to(device, non_blocking=True)


def start_host_copy(audio_w, bb=None):
    """Start a step's audio wire (a tensor, or a tuple of one a shard),
    and the block's baseband (a tensor) when one is given, copying to the
    host right after dispatch (the reference's copy_to_host_async). A
    CUDA piece goes to pinned memory from the caching host allocator with
    a non_blocking copy, which holds its block until the copy is done;
    one CUDA event a device follows its copies, and so the step and
    everything issued before them. A CPU piece is copied too: the bank's
    next step rewrites its output. Returns (host pieces shaped as
    audio_w, host baseband or None, events)."""
    one = isinstance(audio_w, torch.Tensor)
    pieces = [audio_w] if one else list(audio_w)
    if bb is not None:
        pieces.append(bb)
    host = [p.to("cpu", non_blocking=True) if p.is_cuda else p.clone()
            for p in pieces]
    host_bb = host.pop() if bb is not None else None
    events = []
    for dev in dict.fromkeys(p.device for p in pieces if p.is_cuda):
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(dev))
        events.append(ev)
    return (host[0] if one else tuple(host)), host_bb, events


def drain(bank, entry, span: BlockSpan | None = None):
    """Wait for one block's host copies alone; (host audio complex64
    (n_rx, out_block), the block's baseband on the device or None).
    entry: (start_host_copy's result, the block's baseband from
    bank.baseband_from_wire, or None); span: the block's record, which
    gets the marks `waited` (the copies' events synchronised) and
    `decoded` (audio_from_wire done)."""
    (host_audio, _, events), bb = entry
    span = span or BlockSpan(None)
    with stage_range("drain_wait", span.id):
        for ev in events:
            ev.synchronize()
    span.waited = time.perf_counter_ns()
    with stage_range("decode", span.id):
        audio = bank.audio_from_wire(host_audio)
    span.decoded = time.perf_counter_ns()
    return audio, bb


class Executive:
    def __init__(self, bank, source, audio_rings=None, realtime=False,
                 raw_writer=None, demod_writer=None,
                 psd_callback: Callable | None = None, loop_source=True,
                 wire: str = "f32", pipeline_depth: int = 2,
                 want_bb: bool = True, prefetch: bool = True,
                 host_bb: bool = False):
        """bank: a models.receiver.ReceiverBank,
        models.channelizer_bank.ChannelizerBank or a parallel.adapter
        bank, driven only through design.{in_block, fs_in, fs_out}, n_rx,
        device, prepare, step_device, audio_from_wire, baseband_from_wire,
        _last_bb and the control methods post() names;
        source: anything with read_data(n) (DatReader / SynthSource) or
        read_packed(n);
        wire: "f32" | "i16" | "i8" RF format across host->device;
        pipeline_depth: device blocks in flight before the oldest drains
        when the next block is ready (the module's docstring);
        prefetch: read + quantize + upload the next blocks on a thread;
        want_bb: carry each block's baseband (bank._last_bb) to the
        drain; host_bb: copy it to the host too, beside the audio."""
        if wire not in ("f32", "i16", "i8"):
            raise ValueError(f"unknown wire {wire!r}")
        self.bank = bank
        self.source = source
        self.realtime = realtime
        self.loop_source = loop_source
        self.wire = wire
        # an integer wire's C++ one-pass quantizer; None for f32 or where
        # the library is unavailable (then quantize_host)
        self._wire_pass = native.wire_quantizer(cplx.WIRES[wire].np_dtype)
        self.pipeline_depth = max(1, int(pipeline_depth))
        self.want_bb = want_bb
        self.host_bb = host_bb
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
        # callables prepare() runs after the bank's capture (the App's
        # display captures its panes there)
        self.prepare_hooks: list[Callable] = []
        self.profiler = BlockProfiler(d.in_block, d.fs_in)
        self._cmd_q: queue.Queue = queue.Queue()
        self._stop = threading.Event()
        self._pf_active = threading.Event()
        # held by the prefetch thread while it issues a block to the card,
        # and by stop(): after stop() the thread issues nothing more
        self._issue_lock = threading.Lock()
        # the copy waiter (started at the first block dispatched with
        # prefetch) and its feed: each block's copy events and the list
        # it stamps once they are done, in dispatch order
        self._waiter: threading.Thread | None = None
        self._watch_q: queue.SimpleQueue = queue.SimpleQueue()
        # what the executive waits on while its next block is not ready;
        # notified by the copy waiter's stamps, the prefetch thread's puts
        # and stop()
        self._wake = threading.Condition()
        self.n_blocks = 0
        # block ids: the next the source's read gets (the reading thread's)
        # and the next the executive takes (its own)
        self._next_read = 0
        self._next_take = 0
        # the records (BlockSpan) of the last drained blocks, oldest first
        self.block_spans: deque = deque(maxlen=4096)
        self.last_rf_block: np.ndarray | None = None
        # the drained block's baseband: a device tensor (n_rx, out_block),
        # the events after which it is valid (one a device, [] on the CPU)
        # and, with host_bb, its host copy (a complex64 tensor)
        self.drained_bb = None
        self.drained_bb_ready: list = []
        self.drained_bb_host = None
        # {stage: ms} over the drained blocks, and two counts of them:
        # idle_drain, those drained while the executive waited for its
        # next block; wire_native, those whose codes the C++ quantizer wrote
        self.stage_ms = dict.fromkeys(
            (*SUMMED_STAGES, "idle_drain", "wire_native"), 0.0)

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

    def _read_host(self):
        """The next block from the source with its record, numbered in
        read order: (float32 pairs, complex64, BlockSpan) or None at
        stream end."""
        span = BlockSpan(self._next_read)
        span.read0 = time.perf_counter_ns()
        with stage_range("read", span.id):
            pair = self._read_host_raw()
        span.arrival = time.perf_counter_ns()
        if pair is None:
            return None
        self._next_read += 1
        return (*pair, span)

    def _prepare(self, pair):
        """Stage a read block and issue its host->device copy: (device
        block, host complex64, BlockSpan) or None."""
        if pair is None:
            return None
        xp, x, span = pair
        dev = self.bank.device
        wire = cplx.WIRES[self.wire]
        with stage_range("quantize", span.id):
            q = staging(xp.shape, wire.torch_dtype, dev)
            if self._wire_pass is not None:
                self._wire_pass(np.ascontiguousarray(xp, np.float32),
                                q.data_ptr(), wire.scale)
            else:
                q.numpy()[...] = cplx.quantize_host(xp, self.wire)
        span.quantized = time.perf_counter_ns()
        with stage_range("pin+issue", span.id):
            xb = upload(q, dev)
        span.issued = time.perf_counter_ns()
        return xb, x, span

    def _pf_loop(self):
        while not self._stop.is_set():
            if not self._pf_active.wait(timeout=0.2):
                continue           # paused between run() calls
            try:
                pair = self._read_host()
                with self._issue_lock:
                    if self._stop.is_set():
                        return       # a read that outlasted stop()
                    item = self._prepare(pair)
            except BaseException as e:  # noqa: BLE001 — surfaced by
                # _read_block on the executive thread
                self._pf_error = e
                item = None
            while not self._stop.is_set():
                try:
                    self._pf_q.put(item, timeout=0.2)
                except queue.Full:
                    continue
                with self._wake:
                    self._wake.notify()
                break
            if item is None:
                return                         # stream end / error

    def _read_block(self):
        """Next (device block, host complex64, BlockSpan) or None at
        stream end; marks the block `taken`."""
        if self._held is not None:
            item, self._held = self._held, None
            return item
        item = self._take() if self.prefetch \
            else self._prepare(self._read_host())
        if item is not None:
            item[2].taken = time.perf_counter_ns()
            self._next_take = item[2].id + 1
        return item

    def _take(self):
        """The prefetch thread's next block, or None at stream end."""
        with stage_range("wait", self._next_take):
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

    def _watch(self, events) -> list:
        """Hand a dispatched block's copy events to the copy waiter,
        started at the first call (not after stop()); returns the list it
        appends its perf_counter_ns stamp to once they are done."""
        if self._waiter is None:
            with self._wake:
                if self._waiter is None and not self._stop.is_set():
                    self._waiter = threading.Thread(target=self._copy_loop,
                                                    daemon=True)
                    self._waiter.start()
        seen: list = []
        self._watch_q.put((events, seen))
        return seen

    def _copy_loop(self):
        """The copy waiter: synchronise each fed block's copy events (the
        GIL is released inside), then stamp the block and notify the
        executive. None ends it; so does a synchronize that raises, after
        its block's stamp: that block's drain waits on the same events
        and raises it on the executive's thread."""
        while (item := self._watch_q.get()) is not None:
            events, seen = item
            try:
                for ev in events:
                    ev.synchronize()
            finally:
                with self._wake:
                    seen.append(time.perf_counter_ns())
                    self._wake.notify()

    def _copies_first(self, seen: list) -> int | None:
        """Wait until the copy waiter has stamped `seen` (the oldest
        block's copies are done) or the prefetch queue holds an item (the
        next block, or the stream's end), whichever comes first, or
        stop(); each of them notifies `_wake` once it has happened, and
        nothing else ends the wait. Returns the block's `copies_seen`
        mark where its copies came first: the waiter's stamp, or this
        call's start where the stamp is older; else None."""
        t0 = time.perf_counter_ns()
        with self._wake:
            while self._pf_q.empty() and not self._stop.is_set():
                if seen:
                    return max(seen[0], t0)
                self._wake.wait()
        return None

    # ---- the hot loop ----

    def prepare(self):
        """Capture the bank's step for this executive's wire blocks, then
        run prepare_hooks (each a no-op once done): run() calls it before
        it starts the prefetch thread, and a caller may call it earlier,
        before other threads (a trace, services) start."""
        self.bank.prepare(cplx.WIRES[self.wire].torch_dtype,
                          self.bank.design.in_block)
        for hook in self.prepare_hooks:
            hook()

    def run(self, n_blocks: int | None = None,
            duration_s: float | None = None):
        self.prepare()
        d = self.bank.design
        deadline = time.monotonic() + duration_s if duration_s else None
        block_budget = d.in_block / d.fs_in
        next_deadline = None

        def finish(block, released_by=None, copies_seen=None):
            # block: a pending (entry, span, seen); released_by: the id of
            # the block whose take started this drain; copies_seen: the
            # idle wait's mark (an idle drain), else the drain's start
            nonlocal next_deadline
            entry, span, _ = block
            span.released_by = released_by
            span.drain0 = time.perf_counter_ns()
            span.copies_seen = span.drain0 if copies_seen is None \
                else copies_seen
            # waits for this block's host copies alone
            audio, self.drained_bb = drain(self.bank, entry, span)
            (_, self.drained_bb_host, self.drained_bb_ready), _ = entry
            with stage_range("push", span.id):
                for i, ring in enumerate(self.audio_rings):
                    ring.push(audio[i])
                if self.demod_writer is not None:
                    self.demod_writer.save_data(audio.T)
            span.pushed = time.perf_counter_ns()
            self.block_spans.append(span)
            if self.psd_callback is not None:
                with stage_range("callback", span.id):
                    self.psd_callback(self, audio)
            # the block's account, once it is delivered: it delays no delivery
            ms = span.stages_ms()
            ms["idle_drain"] = copies_seen is not None
            ms["wire_native"] = self._wire_pass is not None
            for k in self.stage_ms:
                self.stage_ms[k] += ms[k]
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
                    xb, x, span = item
                    if self.raw_writer is not None:
                        self.raw_writer.save_data(x)
                    self.last_rf_block = x
                    span.dispatch0 = time.perf_counter_ns()
                    with stage_range("dispatch", span.id):
                        audio_w = self.bank.step_device(xb)  # async
                        bb = self.bank._last_bb if self.want_bb else None
                        if bb is not None:
                            bb = self.bank.baseband_from_wire(bb)
                        # the host copies start now, behind this step only
                        copies = start_host_copy(
                            audio_w, bb if self.host_bb else None)
                        seen = self._watch(copies[2]) if self.prefetch \
                            else None
                        pending.append(((copies, bb), span, seen))
                    span.dispatch1 = time.perf_counter_ns()
                    # while the next block is not here (the prefetch
                    # queue holds neither it nor the stream's end), drain
                    # the oldest blocks in flight as their copies finish,
                    # not at a take pipeline_depth + 1 blocks later
                    while pending and self.prefetch:
                        mark = self._copies_first(pending[0][2])
                        if mark is None:
                            break
                        finish(pending.popleft(), copies_seen=mark)
                    # read the next block only if it will be dispatched
                    item = self._read_block() \
                        if wants_more(len(pending)) else None
                    if len(pending) > self.pipeline_depth:
                        # the next block was ready: block k-D,
                        # released by this take
                        finish(pending.popleft(),
                               item[2].id if item is not None else None)
                if item is not None and not wants_more(len(pending)):
                    self._held, item = item, None            # deadline hit
            while pending:
                finish(pending.popleft())
            return self.profiler
        finally:
            self._pf_active.clear()

    def stop(self):
        """End the run. Once it returns the prefetch thread issues nothing
        more to the card: a block it was issuing has been issued, and a
        read still in progress (a slow source's) ends without an issue.
        So another bank's capture may start at once (any other thread's
        device call fails one), and a process that exits finds no thread
        of the executive inside a device copy (it would abort in the
        interpreter's shutdown). Then wait (2 s at most each) for the
        prefetch thread to leave and for the copy waiter to finish the
        blocks fed to it and leave."""
        with self._wake:
            self._stop.set()
            self._wake.notify()
            w = self._waiter
        with self._issue_lock:
            pass
        t = self._pf_thread
        if t is not None and t is not threading.current_thread():
            t.join(timeout=2.0)
        if w is not None and w.is_alive():
            self._watch_q.put(None)
            w.join(timeout=2.0)

    def run_in_thread(self, **kw) -> threading.Thread:
        t = threading.Thread(target=self.run, kwargs=kw, daemon=True)
        t.start()
        return t
