"""The executive's drain while it waits, on the CPU: where the next block
is not ready when a block has been dispatched (a live stream), that
block drains at once, with the audio, rings and baseband of the serial
bank; where the next block is always ready (the host runs ahead),
pipeline_depth still caps the blocks in flight and the take of block
k + depth + 1 drains block k; bounded runs and a block held over from a
run's deadline deliver every block once, in read order."""

import collections
import sys
import threading
import time

import numpy as np
import pytest
import torch

from pysdr_tpu_torch.config import PipelineConfig, ReceiverConfig
from pysdr_tpu_torch.models.receiver import ReceiverBank
from pysdr_tpu_torch.runtime import executive
from pysdr_tpu_torch.runtime.executive import Executive
from pysdr_tpu_torch.tables import Mode
from tests.paced import PacedSynth

torch.set_num_threads(1)

CFG = PipelineConfig(fs_in=512e3, fs_out=48e3, out_block=1024,
                     foffset_hz=60e3, receivers=(
                         ReceiverConfig(fc_hz=10e6, mode=Mode.AM,
                                        agc_enabled=False),
                         ReceiverConfig(fc_hz=10.02e6, mode=Mode.USB)))


def ramp_block(k: int, n: int) -> np.ndarray:
    """Block k (from 1) of a stream whose amplitude grows with k."""
    t = np.arange(n) / CFG.fs_in
    return (0.05 * k * np.exp(2j * np.pi * 60e3 * t)
            * (1 + 0.3 * np.sin(2 * np.pi * 500 * t))).astype(np.complex64)


def paced_ramp(n: int | None = None):
    """The ramp at the stream's sample rate, gated on the delivery of the
    last block (the gate: one threading.Event a block id, which the
    executive's callback sets): (source, gate)."""
    gate = collections.defaultdict(threading.Event)
    return PacedSynth(CFG.fs_in, n, gate=gate,
                      blocks=lambda i, n: ramp_block(i + 1, n)), gate


class SlowCopy:
    """Stands in for a block's copy event on a card: synchronize() blocks
    until the copy is done, `after_s` after the block's dispatch; with
    None, once the thread that dispatched the block (the executive's)
    synchronises it, as the drain a take starts does, and another
    thread's call (the copy waiter's) waits for that, 30 s at most. It
    has no query(): the executive does not poll. It waits on an Event,
    not in time.sleep."""

    def __init__(self, after_s: float | None):
        self.owner = threading.current_thread()
        self.t_done = None if after_s is None \
            else time.perf_counter() + after_s
        self.done = threading.Event()
        self.entered = threading.Event()    # a thread other than the owner
        # is inside synchronize()

    def synchronize(self):
        mine = threading.current_thread() is self.owner
        if not mine:
            self.entered.set()
        if self.t_done is not None:
            while (left := self.t_done - time.perf_counter()) > 0:
                self.done.wait(left)
        elif mine:
            self.done.set()
        else:
            self.done.wait(30.0)


def slow_copies(monkeypatch, after_s):
    """Each block's copy events gain a SlowCopy(after_s), or, where
    after_s is callable, SlowCopy(after_s(block index)); returns them, in
    dispatch order."""
    made = []
    real = executive.start_host_copy
    after = after_s if callable(after_s) else (lambda i: after_s)

    def start(audio_w, bb=None):
        host, host_bb, events = real(audio_w, bb)
        made.append(SlowCopy(after(len(made))))
        return host, host_bb, [*events, made[-1]]
    monkeypatch.setattr(executive, "start_host_copy", start)
    return made


class Ramp:
    """The ramp, unpaced: the next block is ready as soon as the
    prefetch thread has prepared it."""
    k = 0

    def read_data(self, n, loop=True):
        self.k += 1
        return ramp_block(self.k, n)


def serial_blocks(n_blocks: int):
    """The serial bank's audio and baseband of the ramp's first blocks."""
    serial = ReceiverBank(CFG, emit_baseband=True, audio_wire="i16",
                          device="cpu")
    audio, bb = [], []
    for k in range(n_blocks):
        audio.append(serial.step(ramp_block(k + 1, serial.design.in_block)))
        bb.append(serial._last_bb.clone())
    return audio, bb


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_live_blocks_drain_at_once_with_the_serial_banks_audio(depth):
    """A paced stream to its end at pipeline depths 1-3: every block
    drains while the executive waits for the next (no take released it,
    idle_drain counts it), and the delivered audio, its host baseband,
    the drained baseband and the rings equal the serial bank's, block for
    block."""
    n = 8
    ref_audio, ref_bb = serial_blocks(n)
    src, gate = paced_ramp(n)
    got = []

    def tap(ex, audio):
        got.append((audio.copy(), ex.drained_bb, ex.drained_bb_host))
        gate[ex.block_spans[-1].id].set()

    ex = Executive(ReceiverBank(CFG, emit_baseband=True, audio_wire="i16",
                                device="cpu"), src, psd_callback=tap,
                   loop_source=False, pipeline_depth=depth, host_bb=True)
    ex.run()
    ex.stop()
    assert len(got) == n
    assert [s.id for s in ex.block_spans] == list(range(n))
    assert all(s.released_by is None for s in ex.block_spans)
    assert ex.stage_ms["idle_drain"] == n
    assert ex.stage_report()["idle_drain"] == 1.0
    for k, (audio, bb, bb_host) in enumerate(got):
        np.testing.assert_array_equal(audio, ref_audio[k])
        np.testing.assert_array_equal(bb.numpy(), ref_bb[k].numpy())
        np.testing.assert_array_equal(bb_host.numpy(), ref_bb[k].numpy())
    out = ex.bank.design.out_block
    for i, ring in enumerate(ex.audio_rings):
        np.testing.assert_array_equal(
            ring.pull(n * out), np.concatenate([a[i] for a in ref_audio]))


class ReadyBank(ReceiverBank):
    """A bank whose dispatch first waits until the executive's prefetch
    queue holds the next block (5 s at most), so the next block is
    always ready when a dispatch is done; counts the blocks in flight
    (dispatched, not yet delivered) at each dispatch."""

    ex = None
    dispatched = 0
    delivered = 0

    def step_device(self, x_wire):
        t_end = time.monotonic() + 5.0
        while self.ex._pf_q.empty() and time.monotonic() < t_end:
            time.sleep(1e-3)
        self.dispatched += 1
        self.in_flight.append(self.dispatched - self.delivered)
        return super().step_device(x_wire)


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_a_ready_next_block_keeps_the_depth_rule(depth):
    """With the next block always ready (an unpaced source, the dispatch
    gated on the prefetch queue), the take of block k + depth + 1
    releases block k's drain, never more than depth + 1 blocks are in
    flight (depth + 1 is reached), no block drains while idle, and the
    audio is the serial bank's."""
    n = 9
    ref_audio, _ = serial_blocks(n)
    bank = ReadyBank(CFG, emit_baseband=True, audio_wire="i16",
                     device="cpu")
    bank.in_flight = []
    got = []

    def tap(ex, audio):
        bank.delivered += 1
        got.append(audio.copy())

    ex = Executive(bank, Ramp(), psd_callback=tap, pipeline_depth=depth)
    bank.ex = ex
    ex.run(n_blocks=n)
    ex.stop()
    spans = list(ex.block_spans)
    assert [s.id for s in spans] == list(range(n))
    for s in spans:
        want = s.id + depth + 1
        assert s.released_by == (want if want < n else None), s.id
        if s.released_by is not None:
            assert s.drain0 >= spans[s.released_by].taken
    assert max(bank.in_flight) == depth + 1
    assert ex.stage_ms["idle_drain"] == 0
    for k, audio in enumerate(got):
        np.testing.assert_array_equal(audio, ref_audio[k])


def test_a_live_block_drains_once_its_copies_are_done(monkeypatch):
    """Copies that take 30 ms on a paced stream whose next block is not
    ready: the copy waiter sees them done and wakes the executive, which
    drains the block at once, before it takes the next block; no take
    released it, its wake (copies seen to drain) is short, and the audio
    is the serial bank's."""
    n = 5
    ref_audio, _ = serial_blocks(n)
    made = slow_copies(monkeypatch, 0.03)
    src, gate = paced_ramp(n)
    got = []

    def tap(ex, audio):
        got.append(audio.copy())
        gate[ex.block_spans[-1].id].set()

    ex = Executive(ReceiverBank(CFG, emit_baseband=True, audio_wire="i16",
                                device="cpu"), src, psd_callback=tap,
                   loop_source=False, pipeline_depth=2)
    ex.run()
    ex.stop()
    spans = list(ex.block_spans)
    assert [s.id for s in spans] == list(range(n)) and len(made) == n
    for s in spans:
        assert s.released_by is None
        assert s.drain0 >= made[s.id].t_done * 1e9
        assert s.copies_seen >= made[s.id].t_done * 1e9
        assert s.drain0 >= s.copies_seen
        if s.id + 1 < n:
            assert s.pushed <= spans[s.id + 1].taken
    assert ex.stage_ms["idle_drain"] == n
    assert ex.stage_ms["hold"] >= n * 20.0
    assert ex.stage_ms["wake"] / n < 20.0
    for k, audio in enumerate(got):
        np.testing.assert_array_equal(audio, ref_audio[k])


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_a_block_that_comes_while_the_copies_run_is_taken(monkeypatch,
                                                           depth):
    """Copies that are not done before the next block comes (an unpaced
    source): the executive stops waiting for them and takes that block, so
    the take of block k + depth + 1 releases block k's drain, no block
    drains while idle, and the audio is the serial bank's."""
    n = 9
    ref_audio, _ = serial_blocks(n)
    slow_copies(monkeypatch, None)
    got = []
    ex = Executive(ReceiverBank(CFG, emit_baseband=True, audio_wire="i16",
                                device="cpu"), Ramp(),
                   psd_callback=lambda ex, audio: got.append(audio.copy()),
                   pipeline_depth=depth)
    ex.run(n_blocks=n)
    ex.stop()
    spans = list(ex.block_spans)
    assert [s.id for s in spans] == list(range(n))
    for s in spans:
        want = s.id + depth + 1
        assert s.released_by == (want if want < n else None), s.id
        if s.released_by is not None:
            assert s.drain0 >= spans[s.released_by].taken
    assert ex.stage_ms["idle_drain"] == 0
    for k, audio in enumerate(got):
        np.testing.assert_array_equal(audio, ref_audio[k])


def test_bounded_runs_and_a_held_block_deliver_each_block_once():
    """run(n_blocks=...) calls and runs cut by their deadline, one of
    which ends holding a read block, while every block drains as soon as
    it is dispatched: each block is delivered once, in read order, with
    the serial bank's audio, and the held block starts the next run."""
    src, gate = paced_ramp()
    got = []

    def tap(ex, audio):
        i = ex.block_spans[-1].id
        got.append((i, audio.copy()))
        gate[i].set()

    ex = Executive(ReceiverBank(CFG, emit_baseband=True, audio_wire="i16",
                                device="cpu"), src, psd_callback=tap,
                   pipeline_depth=2)
    ex.run(n_blocks=2)
    ex.run(n_blocks=4)
    assert ex.n_blocks == 4
    for _ in range(50):         # a run that ends at its deadline while it
        ex.run(duration_s=0.05)     # waits for a read holds that block
        if ex._held is not None:
            break
    assert ex._held is not None
    held = ex._held[2].id
    assert held == ex.n_blocks
    ex.run(n_blocks=ex.n_blocks + 3)
    ex.stop()
    ids = [i for i, _ in got]
    assert ids == list(range(len(ids))) and held in ids
    assert [s.id for s in ex.block_spans] == ids
    assert all(s.released_by is None for s in ex.block_spans)
    assert ex.stage_ms["idle_drain"] == len(ids) == ex.n_blocks
    ref_audio, _ = serial_blocks(len(ids))
    for (i, audio), ref in zip(got, ref_audio):
        np.testing.assert_array_equal(audio, ref)


@pytest.mark.parametrize("slow_sync", [False, True])
def test_stop_ends_the_prefetch_thread_and_the_copy_waiter(monkeypatch,
                                                           slow_sync):
    """After stop(), neither the prefetch thread nor the copy waiter is
    alive: after a bounded run, and where stop() comes while the waiter
    is inside a slow synchronize() (copies of 0.4 s on a run in its own
    thread), which then ends the run with the block delivered."""
    made = slow_copies(monkeypatch, 0.4 if slow_sync else 0.0)
    got = []
    ex = Executive(ReceiverBank(CFG, device="cpu"), PacedSynth(CFG.fs_in),
                   psd_callback=lambda ex, audio: got.append(audio.copy()),
                   pipeline_depth=2)
    if slow_sync:
        t = ex.run_in_thread()
        deadline = time.monotonic() + 10.0
        while not made and time.monotonic() < deadline:
            time.sleep(1e-3)
        assert made[0].entered.wait(10.0)
        ex.stop()
        t.join(timeout=10.0)
        assert not t.is_alive()
        assert ex.n_blocks == len(made) >= 1
    else:
        ex.run(n_blocks=3)
        ex.stop()
        assert ex.n_blocks == 3
    assert ex._pf_thread is not None and not ex._pf_thread.is_alive()
    assert ex._waiter is not None and not ex._waiter.is_alive()
    assert len(got) == ex.n_blocks


class LateEnd(PacedSynth):
    """PacedSynth whose stream ends `end_s` after its last block, not at
    once."""

    end_s = 0.05

    def read_data(self, n, loop=False):
        if len(self.handed) == self.n:
            time.sleep(self.end_s)
            return np.zeros(0, np.complex64)
        return super().read_data(n, loop)


def test_a_stream_that_ends_while_the_copies_run_ends_the_run(monkeypatch):
    """The stream's end comes while the executive waits for the last
    block's copies (0.5 s): the end wakes it, and it drains that block
    (not released by a take, not an idle drain, wake 0) before its copies
    are done, delivers it and ends the run."""
    n = 3
    made = slow_copies(monkeypatch, lambda i: 0.5 if i == n - 1 else 0.0)
    gate = collections.defaultdict(threading.Event)
    src = LateEnd(CFG.fs_in, n, gate=gate,
                  blocks=lambda i, n: ramp_block(i + 1, n))
    got = []

    def tap(ex, audio):
        got.append(audio.copy())
        gate[ex.block_spans[-1].id].set()

    ex = Executive(ReceiverBank(CFG, emit_baseband=True, audio_wire="i16",
                                device="cpu"), src, psd_callback=tap,
                   loop_source=False, pipeline_depth=2)
    ex.run()
    ex.stop()
    spans = list(ex.block_spans)
    assert [s.id for s in spans] == list(range(n)) and len(got) == n
    last = spans[-1]
    assert last.released_by is None
    assert last.copies_seen == last.drain0
    assert last.drain0 < made[-1].t_done * 1e9 <= last.waited
    assert ex.stage_ms["idle_drain"] == n - 1
    ref_audio, _ = serial_blocks(n)
    for k, audio in enumerate(got):
        np.testing.assert_array_equal(audio, ref_audio[k])


def test_the_idle_wait_sleeps_on_no_timer(monkeypatch):
    """The executive has no poll period, and while it waits for a live
    block's copies (30 ms) it calls no time.sleep on its own thread."""
    assert not hasattr(executive, "IDLE_POLL_S")
    n = 4
    slow_copies(monkeypatch, 0.03)
    me = threading.current_thread()
    real_sleep = time.sleep
    slept = []

    def sleep(s):
        if threading.current_thread() is me:
            slept.append(s)
            raise AssertionError("time.sleep on the executive's thread")
        real_sleep(s)
    monkeypatch.setattr(executive.time, "sleep", sleep)
    src, gate = paced_ramp(n)
    ex = Executive(ReceiverBank(CFG, device="cpu"), src,
                   psd_callback=lambda ex, audio:
                   gate[ex.block_spans[-1].id].set(),
                   loop_source=False, pipeline_depth=2)
    ex.run()
    monkeypatch.undo()
    ex.stop()
    assert slept == []
    assert ex.n_blocks == n and ex.stage_ms["idle_drain"] == n


class Bursty:
    """The ramp in bursts of eight blocks read at once, each burst after a
    50 ms pause: in a pause the next block is not ready at a dispatch,
    inside a burst it is."""

    k = 0

    def read_data(self, n, loop=True):
        if self.k % 8 == 0:
            time.sleep(0.05)
        self.k += 1
        return ramp_block(self.k, n)


@pytest.mark.parametrize("depth", [1, 3])
def test_wakes_under_thread_switches_lose_no_block(monkeypatch, depth):
    """The prefetch thread, the copy waiter and the executive with a
    switch interval of 10 us, copies of 0-2 ms (seeded) and a bursty
    source: the run ends within its bound (a lost wake would hang it),
    both ends of the wait occur (some blocks drain idle, some at a take),
    and every block is delivered once, in read order, with the serial
    bank's audio."""
    n = 40
    ref_audio, _ = serial_blocks(n)
    rng = np.random.default_rng(depth)
    slow_copies(monkeypatch, lambda i: float(rng.uniform(0.0, 2e-3)))
    got = []
    ex = Executive(ReceiverBank(CFG, emit_baseband=True, audio_wire="i16",
                                device="cpu"), Bursty(),
                   psd_callback=lambda ex, audio: got.append(
                       (ex.block_spans[-1].id, audio.copy())),
                   pipeline_depth=depth)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        t = ex.run_in_thread(n_blocks=n)
        t.join(timeout=60.0)
        assert not t.is_alive()
    finally:
        sys.setswitchinterval(old)
        ex.stop()
    assert [i for i, _ in got] == list(range(n))
    assert 0 < ex.stage_ms["idle_drain"] < n
    for (_, audio), ref in zip(got, ref_audio):
        np.testing.assert_array_equal(audio, ref)
