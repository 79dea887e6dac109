"""A chain's tap (harness.py): the App's own per-block output other than
the bank's audio, checked against the chain's reference from the
stream's start, timed into each block's delivery, and its counters read
through Run; and the delivery stamps of a cell whose App runs no
per-block callback, which stay as they were.

The tapped chain here is the tiny bank's receivers chain with a stand-in
decoder: the App runs its own per-block callback (`--memmon`), the tap
wraps it, sleeps a known time after it, as a decoder would take, and
records each receiver's rms over the block; the reference works the same
out from its audio.

    python -m pytest -q sdrbench/tests
"""

from __future__ import annotations

import dataclasses
import itertools
import math
import sys
import time
import types

import numpy as np
import pytest

from sdrbench import control, harness, reference, registry
from sdrbench.tests import tiny

HOOK_S = 0.005
RMS_FLOOR = 1e-3
SEED = 2**31 + 31


class _DecoderTap(harness.Tap):
    """Wraps the App's per-block callback: after it, a `HOOK_S` sleep and
    each receiver's rms of the block's audio, times `scale`."""

    def __init__(self, app, scale: float):
        super().__init__()
        self.entered: dict = {}
        self.calls = 0
        self.hook_ms = 0.0
        inner = app.ex.psd_callback

        def decoder(ex, audio):
            t = time.perf_counter()
            self.entered[self.block] = t
            inner(ex, audio)
            time.sleep(HOOK_S)
            a = np.asarray(audio).astype(np.complex128)
            self.record(scale * np.sqrt((np.abs(a) ** 2).mean(axis=1)))
            self.calls += 1
            self.hook_ms += 1e3 * (time.perf_counter() - t)
        app.ex.psd_callback = decoder

    def counters(self) -> dict:
        return {"calls": self.calls, "hook_ms": self.hook_ms}


def _make_tapped():
    receivers = registry.module("chains", "receivers")

    @dataclasses.dataclass(frozen=True)
    class Tapped(receivers.Receivers):
        scale: float = 1.0
        settle_blocks = 2

        def attach(self, app):
            return _DecoderTap(app, self.scale)

        def output(self, x, arith):
            audio, _ = self.audio(x, 0, arith)
            a = reference.audio_wire(audio, "f32").astype(np.complex128)
            rms = np.sqrt((np.abs(a.reshape(a.shape[0], -1, self.out_block))
                           ** 2).mean(axis=2))
            return {i: rms[:, i] for i in range(rms.shape[1])}

        def output_measures(self, prog, ref):
            worst = 0.0
            for i, r in ref.items():
                p = prog[i]
                if p is None:
                    return {"tap_rms_err": math.inf}
                worst = max(worst, float(np.max(
                    np.abs(p - r) / np.maximum(r, RMS_FLOOR))))
            return {"tap_rms_err": worst}

    def build(spec, fc_hz, block):
        base = receivers.build({k: v for k, v in spec.items()
                                if k != "scale"}, fc_hz, block)
        return Tapped(**dataclasses.asdict(base),
                      scale=spec.get("scale", 1.0))
    return types.SimpleNamespace(build=build)


@pytest.fixture(scope="module")
def tapped_chain():
    key = "sdrbench.chains.tapped"
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, key, _make_tapped())
        yield


def _tapped_cell(tmp_path, scale=1.0, limit=1e-3) -> harness.Cell:
    tr = dict(tiny.traffic("open"),
              argv=["--memmon", str(tmp_path / "memmon.txt")])
    cfg = dict(tiny.BANK, reference=dict(tiny.BANK["reference"],
                                         kind="tapped", scale=scale))
    checks = dict(harness.cell("bank4.live_1x").checks, tap_rms_err=limit)
    return harness.Cell("tiny.tapped", cfg, tr, checks)


@pytest.fixture(scope="module")
def tapped_run(tapped_chain, tmp_path_factory):
    """One tiny open-loop run of the tapped chain, and its tap."""
    taps = []

    def keep_tap(app):
        taps.append(app.ex.psd_callback.__self__.tap)
    c = _tapped_cell(tmp_path_factory.mktemp("tapped"))
    res = harness.run_cell(c, SEED, 0.6, False, "cpu", fault=keep_tap,
                           log=lambda *a: None)
    return res, taps[0]


class _OldDelivery:
    """Delivery as it was before the tap: one stamp at the callback's
    entry, the App's callback (if any) after it."""

    def __init__(self, ex, keeper):
        self.inner = ex.psd_callback
        self.keeper = keeper
        self.times = []
        self.in_window = lambda i, t: False
        ex.psd_callback = self

    def __call__(self, ex, audio):
        t = time.perf_counter()
        i = len(self.times)
        self.times.append(t)
        if self.in_window(i, t):
            self.keeper.offer(i, audio)
        if self.inner is not None:
            self.inner(ex, audio)


def test_delivery_without_an_app_callback_stamps_as_before(monkeypatch):
    """(a) Where the App runs no per-block callback, each block's
    delivery is one clock read at the callback's entry, the same stamps,
    sample and latency_p95_ms as before the tap."""
    seen = {}
    for kind in (_OldDelivery, harness.Delivery):
        clock = itertools.count(100.0, 0.0125)
        monkeypatch.setattr(time, "perf_counter", lambda: next(clock))
        ex = types.SimpleNamespace(psd_callback=None)
        dl = kind(ex, harness.Keeper(3, SEED))
        dl.in_window = lambda i, t: 4 <= i < 30
        for i in range(34):
            ex.psd_callback(ex, f"audio {i}")
        monkeypatch.undo()
        assert next(clock) == pytest.approx(100.0 + 34 * 0.0125)
        due = [100.0 + 0.01 * i for i in range(34)]
        run = harness.Run(loop="open", seconds=0.26, in_block=1000,
                          setup_s=1.0, t_open=100.0, t_close=100.26,
                          delivered=dl.times, due=due,
                          window_blocks=range(4, 30), blocks_run=34,
                          stage_ms={}, launches={}, host={},
                          trace_blocks=1, trace=None)
        seen[kind] = (dl.times, dl.keeper.blocks(),
                      harness.reader("latency_p95_ms")(run))
    assert seen[_OldDelivery] == seen[harness.Delivery]


def test_a_tapless_run_stamps_at_the_rings_and_counts_nothing():
    """(a, d) A tiny bank cell with no App callback and no tap: delivery
    is the rings' stamp alone, Run.tap_counters is empty and a reader of
    the tap's counters reads None."""
    callbacks = []

    def look(app):
        callbacks.append(app.ex.psd_callback)
    res = harness.run_cell(tiny.bank_cell(loop="open"), SEED, 0.6, False,
                           "cpu", fault=look, log=lambda *a: None)
    run = res["run"]
    assert callbacks[0].__func__ is harness.Delivery.rings
    assert run.tap_counters == {}
    assert _calls_a_block(run) is None
    assert harness.reader("latency_p95_ms")(run) > 0
    assert harness.correct(res), res["checks"]


def _calls_a_block(run):
    """A reader of the tap's counters, as a metrics/ file would be."""
    if not run.blocks_run or "calls" not in run.tap_counters:
        return None
    return run.tap_counters["calls"] / run.blocks_run


def test_an_app_callback_delays_every_delivery(tapped_run):
    """(b) The tap's decoder sleeps HOOK_S after the App's callback:
    every block is delivered at least that long after the callback was
    entered, and so after its audio reached the rings."""
    res, tap = tapped_run
    delivered = res["run"].delivered
    assert len(delivered) == len(tap.entered) > 0
    for i, t in enumerate(delivered):
        assert t - tap.entered[i] >= HOOK_S
    assert harness.reader("latency_p95_ms")(res["run"]) >= 1e3 * HOOK_S


def test_a_chains_own_number_decides_correct(tapped_run):
    """(c) The chain's own number reaches the checks with its limit, from
    the window's blocks after the settle point, and passes."""
    res, tap = tapped_run
    run = res["run"]
    value, limit = res["checks"]["tap_rms_err"]
    assert limit == 1e-3 and value is not None and value <= limit
    assert set(tap.outputs) == set(range(len(run.delivered)))
    assert harness.correct(res), res["checks"]


def test_a_corrupted_output_is_not_correct(tapped_chain, tmp_path):
    """(c) The same run with the tap's output scaled by 1.5 at the
    decoder fails the chain's own number alone: not correct."""
    res = harness.run_cell(_tapped_cell(tmp_path, scale=1.5), SEED, 0.6,
                           False, "cpu", log=lambda *a: None)
    checks = res["checks"]
    assert checks["tap_rms_err"][0] > 0.4
    assert all(v <= lim for k, (v, lim) in checks.items()
               if k != "tap_rms_err")
    assert not harness.correct(res)


def test_the_taps_counters_reach_a_reader(tapped_run):
    """(d) The tap's counters over the window, read where the executive's
    stage_ms is, reach a reader through Run."""
    res, _ = tapped_run
    run = res["run"]
    assert run.tap_counters["calls"] == run.blocks_run > 0
    assert _calls_a_block(run) == 1.0
    assert run.tap_counters["hook_ms"] >= 1e3 * HOOK_S * run.blocks_run


def test_a_number_with_nothing_to_compare_is_not_correct(tapped_chain,
                                                         tmp_path):
    """A tapped chain whose settle point lies past the window compares no
    output: its number reads None and the run is not correct."""
    c = _tapped_cell(tmp_path)
    chain = reference.chain_of(c.config["reference"], c.config["scene"]["fc"],
                               c.traffic["block"])
    assert harness.settled(chain, range(5)) == [2, 3, 4]
    checks = harness.compare(c, chain, None, {}, "cpu", log=lambda *a: None,
                             outputs={})
    assert checks["tap_rms_err"] == (None, 1e-3)
    assert not harness.passed(checks)


def test_the_control_reads_the_chains_own_numbers(tapped_chain, tmp_path):
    """(e) control.readings puts the chain's reference output under TF32
    in the program's place and reports the chain's own number beside the
    audio's, with its limit."""
    got = control.readings(_tapped_cell(tmp_path), SEED, 6, "cpu")
    value, limit = got["tap_rms_err"]
    assert limit == 1e-3 and value is not None and value > 0
    assert {"audio_rel_err", "audio_rel_err_median",
            "latch_unsettled"} <= set(got)
