"""rtty_channels_ms (ms, program counter): the RTTY decoder's "channels"
stage, the per-channel timing search and LTRS/FIGS state machine, summed
over the measured window's blocks by the chain's tap (rtty_channels_ms, from
the decoder's stage_ms), a block (the blocks the executive's run drained).
None where the run has no such counter."""


def read(run):
    key = "rtty_channels_ms"
    if not run.blocks_run or key not in run.tap_counters:
        return None
    return run.tap_counters[key] / run.blocks_run
