"""display_wait_ms (ms, program counter): the part of the display's
updates (display_rf_ms, display_af_ms and display_bb_ms) that the panes
spent waiting on their pull's event, summed over the measured window's
blocks by the pan chain's tap (display_wait_ms, from
DisplayEngine.stage_ms), a block (the blocks the executive's run
drained). None where the run has no such counter."""


def read(run):
    key = "display_wait_ms"
    if not run.blocks_run or key not in run.tap_counters:
        return None
    return run.tap_counters[key] / run.blocks_run
