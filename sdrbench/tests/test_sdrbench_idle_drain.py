"""The reader of the share of blocks the executive drained while it
waited for its next block (idle_drain_share), on a tiny traced open-loop
run and on a program without the counter.

    python -m pytest -q sdrbench/tests
"""

from __future__ import annotations

import pytest

from sdrbench import harness
from sdrbench.tests import tiny


@pytest.mark.parametrize("make", [tiny.bank_cell, tiny.chan_cell])
def test_idle_drain_share_reads_a_traced_live_run(make):
    """On a tiny traced open-loop run, idle_drain_share.live reads a share
    in [0, 100] of the window's blocks, and hold_ms.live is under one
    block period: a block drains while the executive waits for the next,
    not at the take pipeline_depth + 1 blocks later."""
    res = harness.run_cell(make(loop="open"), 2**31 + 23, 0.6, True, "cpu",
                           log=lambda *a: None)
    run = res["run"]
    share = harness.reader("idle_drain_share.live")(run)
    assert isinstance(share, float) and 0.0 <= share <= 100.0, share
    period_ms = 1e3 * (run.due[1] - run.due[0])
    assert harness.reader("hold_ms.live")(run) < period_ms
    assert harness.correct(res), res["checks"]


def test_idle_drain_share_reads_nothing_without_the_counter():
    """A program without the counter (the parent of the idle drain) gives
    idle_drain_share.live nothing to read, and the reader does not
    raise."""
    run = harness.Run(loop="open", seconds=1.0, in_block=1000, setup_s=1.0,
                      t_open=0.0, t_close=1.0, delivered=[], due=[],
                      window_blocks=range(0), blocks_run=40,
                      stage_ms={"read": 1.0, "upload": 2.0, "quantize": 1.0,
                                "pin+issue": 1.0, "dispatch": 3.0,
                                "drain": 4.0, "hold": 5.0},
                      launches={}, host={}, trace_blocks=1, trace=None)
    assert harness.reader("idle_drain_share.live")(run) is None
