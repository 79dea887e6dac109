"""The reader of the executive's wake counter (wake_ms: copies seen done
to the drain's start) on a tiny traced open-loop run and on a program
without the counter.

    python -m pytest -q sdrbench/tests
"""

from __future__ import annotations

import pytest

from sdrbench import harness
from sdrbench.tests import tiny


@pytest.mark.parametrize("make", [tiny.bank_cell, tiny.chan_cell])
def test_wake_ms_reads_a_traced_live_run(make):
    """On a tiny traced open-loop run, wake_ms.live reads a number in
    [0, hold_ms.live]: the wake is the end of a block's hold."""
    res = harness.run_cell(make(loop="open"), 2**31 + 29, 0.6, True, "cpu",
                           log=lambda *a: None)
    run = res["run"]
    wake = harness.reader("wake_ms.live")(run)
    hold = harness.reader("hold_ms.live")(run)
    assert isinstance(wake, float) and 0.0 <= wake <= hold, (wake, hold)
    assert harness.correct(res), res["checks"]


def test_wake_ms_reads_nothing_without_the_counter():
    """A program without the counter (the parent of the copy waiter)
    gives wake_ms.live nothing to read, and the reader does not raise."""
    run = harness.Run(loop="open", seconds=1.0, in_block=1000, setup_s=1.0,
                      t_open=0.0, t_close=1.0, delivered=[], due=[],
                      window_blocks=range(0), blocks_run=40,
                      stage_ms={"read": 1.0, "upload": 2.0, "quantize": 1.0,
                                "pin+issue": 1.0, "dispatch": 3.0,
                                "drain": 4.0, "hold": 5.0, "idle_drain": 40},
                      launches={}, host={}, trace_blocks=1, trace=None)
    assert harness.reader("wake_ms.live")(run) is None
