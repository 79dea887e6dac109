"""The reader of the share of blocks whose integer RF wire the C++
one-pass quantizer wrote (wire_native_share), on tiny traced open-loop
runs and on a program without the counter.

    python -m pytest -q sdrbench/tests
"""

from __future__ import annotations

import pytest

from pysdr_tpu_torch.runtime import native
from sdrbench import harness
from sdrbench.tests import tiny


@pytest.mark.skipif(not native.available(), reason="native lib not built")
@pytest.mark.parametrize("make,share", [(tiny.chan_cell, 100.0),
                                        (tiny.bank_cell, 0.0)])
def test_wire_native_share_reads_a_traced_live_run(make, share):
    """chan64's chain (an i8 RF wire) reads 100 (within a block the
    prefetch thread prepared ahead of the window's drains): every block's
    codes came from the native pass; bank4's (an f32 wire) reads 0."""
    res = harness.run_cell(make(loop="open"), 2**31 + 29, 0.6, True, "cpu",
                           log=lambda *a: None)
    run = res["run"]
    assert harness.reader("wire_native_share.live")(run) == \
        pytest.approx(share, abs=100.0 / run.blocks_run)
    assert harness.correct(res), res["checks"]


def _run(stage_ms: dict, blocks_run: int = 40) -> harness.Run:
    return harness.Run(loop="open", seconds=1.0, in_block=1000, setup_s=1.0,
                       t_open=0.0, t_close=1.0, delivered=[], due=[],
                       window_blocks=range(0), blocks_run=blocks_run,
                       stage_ms=stage_ms, launches={}, host={},
                       trace_blocks=1, trace=None)


STAGES = {"read": 1.0, "upload": 2.0, "quantize": 1.0, "pin+issue": 1.0,
          "dispatch": 3.0, "drain": 4.0, "hold": 5.0, "idle_drain": 40.0}


def test_wire_native_share_reads_the_count_over_the_blocks():
    """100 x stage_ms["wire_native"] / the window's blocks."""
    read = harness.reader("wire_native_share.live")
    assert read(_run({**STAGES, "wire_native": 30.0})) == 75.0
    assert read(_run({**STAGES, "wire_native": 40.0})) == 100.0


def test_wire_native_share_reads_nothing_without_the_counter():
    """A program without the counter (the parent of the native pass)
    gives wire_native_share.live nothing to read, and the reader does not
    raise."""
    assert harness.reader("wire_native_share.live")(_run(STAGES)) is None
