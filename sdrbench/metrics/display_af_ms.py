"""display_af_ms (ms, program counter): the display's "af" stage, the AF
panes' updates, one a receiver, summed, on the host's clock, summed over
the measured window's blocks by the pan chain's tap (display_af_ms, from
DisplayEngine.stage_ms), a block (the blocks the executive's run
drained). None where the run has no such counter."""


def read(run):
    key = "display_af_ms"
    if not run.blocks_run or key not in run.tap_counters:
        return None
    return run.tap_counters[key] / run.blocks_run
