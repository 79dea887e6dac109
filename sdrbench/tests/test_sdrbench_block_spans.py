"""The readers of the executive's per-block counters (hold, hand-off,
drain wait and decode) on a tiny traced open-loop run, and
the executive's block ids against the harness's block indices.

    python -m pytest -q sdrbench/tests
"""

from __future__ import annotations

import pytest

from sdrbench import harness
from sdrbench.tests import tiny

NEW = ("hold_ms.live", "handoff_ms.live", "drain_wait_ms.live",
       "decode_ms.live")


@pytest.mark.parametrize("make", [tiny.bank_cell, tiny.chan_cell])
def test_new_readers_read_a_traced_live_run(make):
    """Each new metric of the live cells reads a number on a tiny traced
    run, the drain's two parts add up to drain_ms, and block id i's
    record lies between the due time of the harness's block i and its
    delivery."""
    seen = {}

    def keep(app):
        seen["spans"] = app.ex.block_spans
    res = harness.run_cell(make(loop="open"), 2**31 + 17, 0.6, True, "cpu",
                           fault=keep, log=lambda *a: None)
    run = res["run"]
    got = {m: harness.reader(m)(run) for m in NEW}
    assert all(isinstance(v, float) and v >= 0.0 for v in got.values()), got
    drain = harness.reader("drain_ms.live")(run)
    assert got["drain_wait_ms.live"] + got["decode_ms.live"] == \
        pytest.approx(drain, rel=1e-2)
    spans = {s.id: s for s in seen["spans"]}
    for i in run.window_blocks:
        s = spans[i]
        assert run.due[i] * 1e9 <= s.arrival
        assert s.pushed <= run.delivered[i] * 1e9
    assert harness.correct(res), res["checks"]


def test_new_readers_read_nothing_from_a_program_without_the_counters():
    """A program without the counters (the parent of the executive's
    records) gives each new metric nothing to read, and no reader
    raises."""
    run = harness.Run(loop="open", seconds=1.0, in_block=1000, setup_s=1.0,
                      t_open=0.0, t_close=1.0, delivered=[], due=[],
                      window_blocks=range(0), blocks_run=40,
                      stage_ms={"read": 1.0, "upload": 2.0, "quantize": 1.0,
                                "pin+issue": 1.0, "dispatch": 3.0,
                                "drain": 4.0},
                      launches={}, host={}, trace_blocks=1, trace=None)
    for m in NEW:
        assert harness.reader(m)(run) is None, m
    assert harness.reader("drain_ms.live")(run) == pytest.approx(0.1)
