"""The executive's per-block records on the CPU: each drained block's
BlockSpan carries the source's read order as its id, marks in order that
tile the block from arrival to pushed, the take that released its drain
(none for a block drained while the executive waited for its next one),
and the stages of stage_ms are the sums of the records; under a
torch.profiler every stage is a `pysdr.<stage>#<id>` range, and with no
profiler no range is entered."""

import json
import os
import threading
import time

import numpy as np
import pytest
import torch

from pysdr_tpu_torch.config import PipelineConfig, ReceiverConfig
from pysdr_tpu_torch.models.receiver import ReceiverBank
from pysdr_tpu_torch.runtime import native, profiler
from pysdr_tpu_torch.runtime.executive import Executive
from pysdr_tpu_torch.tables import Mode
from tests.paced import PacedSynth

torch.set_num_threads(1)

CFG = PipelineConfig(fs_in=512e3, fs_out=48e3, out_block=1024,
                     foffset_hz=60e3, receivers=(
                         ReceiverConfig(fc_hz=10e6, mode=Mode.AM),
                         ReceiverConfig(fc_hz=10.02e6, mode=Mode.USB)))
# the keys of stage_ms, which the benchmark's readers read by name
STAGE_MS_KEYS = {"read", "upload", "quantize", "pin+issue", "dispatch",
                 "drain", "handoff", "hold", "drain_wait", "decode",
                 "idle_drain", "wire_native"}


def _live_run(n, depth, prefetch, gate=False, wire="f32"):
    delivered = []
    done = [threading.Event() for _ in range(n)] if gate else None

    def tap(ex, audio):
        delivered.append((ex.block_spans[-1].id, time.perf_counter_ns()))
        if done is not None:
            done[delivered[-1][0]].set()

    src = PacedSynth(CFG.fs_in, n, gate=done)
    ex = Executive(ReceiverBank(CFG, device="cpu"), src, psd_callback=tap,
                   loop_source=False, pipeline_depth=depth,
                   prefetch=prefetch, wire=wire)
    ex.run()
    ex.stop()
    return ex, src, delivered


@pytest.mark.parametrize("depth,prefetch,wire,lib", [
    (1, True, "f32", True), (2, True, "i8", True), (3, True, "i16", True),
    (2, False, "i8", False), (2, True, "i16", False)])
def test_live_blocks_carry_records_that_tile_them(monkeypatch, depth,
                                                  prefetch, wire, lib):
    """A live-paced run to the stream's end: every delivered block has a
    record whose id is its delivery order and the source's read order;
    its marks are in order and its tiling stages tile arrival..pushed;
    stage_ms has the same keys on every wire, with the native pass or
    without (the library unavailable), each of its stages is the sum over
    the records, upload is quantize + pin+issue and drain is drain_wait +
    decode, and wire_native counts the blocks the native pass wrote. With
    prefetch, where the next block is not ready while a block is in
    flight (the source gated on the last block's delivery), each block
    drains before the take of block id + 1, no take released it and
    idle_drain counts every block; without, the take of block id +
    depth + 1 released each drain in the steady state."""
    n = 16
    if not lib:
        monkeypatch.setattr(native, "_load", lambda: None)
    ex, src, delivered = _live_run(n, depth, prefetch, gate=prefetch,
                                   wire=wire)
    spans = list(ex.block_spans)
    assert [i for i, _ in delivered] == list(range(n))
    assert [s.id for s in spans] == list(range(n))
    for s, (_, t_cb), t_src in zip(spans, delivered, src.handed):
        marks = [getattr(s, m) for m in profiler.BLOCK_MARKS]
        assert marks == sorted(marks), s.id
        # the source handed the block out inside its read; the callback
        # saw it pushed
        assert s.read0 <= t_src * 1e9 <= s.arrival + 1e3
        assert s.pushed <= t_cb
        st = s.stages_ms()
        assert [k for k, *_ in profiler.BLOCK_STAGES] == list(st)
        assert min(st.values()) >= 0.0
        tiles = [st[k] for k, _, _, tiling, _ in profiler.BLOCK_STAGES
                 if tiling]
        assert sum(tiles) == pytest.approx(
            (s.pushed - s.arrival) / 1e6, abs=1e-6)
        if prefetch:
            assert s.released_by is None, s.id
            if s.id + 1 < n:
                assert s.pushed <= spans[s.id + 1].taken, s.id
        else:
            want = s.id + depth + 1
            assert s.released_by == (want if want < n else None), s.id
    stage = ex.stage_ms
    assert set(stage) == STAGE_MS_KEYS
    native_pass = lib and wire != "f32" and native.available()
    assert stage["wire_native"] == (n if native_pass else 0)
    if prefetch:
        assert stage["idle_drain"] == n
    else:
        assert stage["idle_drain"] == 0
        steady = [s for s in spans if s.released_by is not None]
        assert len(steady) == n - depth - 1
        # the drain starts at the take of its releaser
        for s in steady:
            assert s.drain0 >= spans[s.released_by].taken
    for k in STAGE_MS_KEYS - {"idle_drain", "wire_native"}:
        assert stage[k] == pytest.approx(
            sum(s.stages_ms()[k] for s in spans), rel=1e-9, abs=1e-9), k
    assert stage["upload"] == pytest.approx(
        stage["quantize"] + stage["pin+issue"], rel=1e-9)
    assert stage["drain"] == pytest.approx(
        stage["drain_wait"] + stage["decode"], rel=1e-9)
    if not prefetch:                  # read and take on one thread
        assert stage["handoff"] < 1.0 * n


def test_ids_follow_the_read_order_across_runs():
    """A block read but not dispatched when a run ends keeps its id; the
    next run starts from it and numbering goes on; the records stay
    bounded."""
    ex = Executive(ReceiverBank(CFG, device="cpu"),
                   PacedSynth(CFG.fs_in, 10**6), pipeline_depth=2)
    ex.run(n_blocks=5)
    for _ in range(50):         # a run that ends at its deadline while it
        ex.run(duration_s=0.05)     # waits for a read holds that block
        if ex._held is not None:
            break
    assert ex._held is not None
    held = ex._held[2].id
    ex.run(n_blocks=ex.n_blocks + 4)
    ex.stop()
    ids = [s.id for s in ex.block_spans]
    assert ids == list(range(len(ids))) and held in ids
    assert ex.block_spans.maxlen == 4096


def _names(events):
    return [e.name for e in events if e.name.startswith("pysdr.")]


def test_profiler_sees_one_dispatch_range_a_block_around_the_step():
    """Under torch.profiler.profile, the executive's thread records one
    `pysdr.dispatch#<id>` range a block, the step's aten ops inside it,
    and each of its other stages with the block's id; the prefetch
    thread's ranges need a profiler of every thread (torch_trace)."""
    n = 6
    ex = Executive(ReceiverBank(CFG, device="cpu"), PacedSynth(CFG.fs_in, n),
                   psd_callback=lambda ex, audio: None, loop_source=False)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        ex.run()
    ex.stop()
    events = prof.events()
    names = _names(events)
    ids = [s.id for s in ex.block_spans]
    for stage in ("dispatch", "drain_wait", "decode", "push", "callback"):
        got = sorted(int(n.split("#")[1]) for n in names
                     if n.split("#")[0] == f"pysdr.{stage}")
        assert got == ids, stage
    assert any(n.startswith("pysdr.wait#") for n in names)
    for e in events:
        if e.name.startswith("pysdr.dispatch#"):
            inner = [c for c in e.cpu_children
                     if c.name.startswith("aten::")]
            assert inner, e.name
            for c in inner:
                assert e.time_range.start <= c.time_range.start
                assert c.time_range.end <= e.time_range.end


def test_torch_trace_holds_every_stage_of_both_threads(tmp_path):
    """--jax-trace's exporter records every thread: the Chrome trace has
    the prefetch thread's read, quantize and pin+issue ranges beside the
    executive's, each with the ids of the run's blocks."""
    n = 5
    ex = Executive(ReceiverBank(CFG, device="cpu"), PacedSynth(CFG.fs_in, n),
                   psd_callback=lambda ex, audio: None, loop_source=False)
    with profiler.torch_trace(str(tmp_path)):
        ex.run()
    ex.stop()
    path = os.path.join(tmp_path, f"trace_{os.getpid()}.json")
    with open(path) as f:
        names = {ev.get("name", "") for ev in json.load(f)["traceEvents"]}
    for stage in ("read", "quantize", "pin+issue", "dispatch", "drain_wait",
                  "decode", "push", "callback"):
        for i in range(n):
            assert f"pysdr.{stage}#{i}" in names, (stage, i)


def test_no_profiler_enters_no_range(monkeypatch):
    """With no profiler recording, the hot path enters no range (neither
    the executive's nor a record_function); with one, it does."""
    entered = []
    real = profiler._RANGE

    def counted(name):
        entered.append(name)
        return real(name)

    def refused(*a, **kw):
        raise AssertionError("record_function entered")
    monkeypatch.setattr(profiler, "_RANGE", counted)
    monkeypatch.setattr(torch.profiler, "record_function", refused)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refused)
    ex = Executive(ReceiverBank(CFG, device="cpu"), PacedSynth(CFG.fs_in, 4),
                   psd_callback=lambda ex, audio: None, loop_source=False)
    ex.run(n_blocks=2)
    assert entered == [] and len(ex.block_spans) == 2
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        ex.run()
    ex.stop()
    assert "pysdr.dispatch#2" in entered
