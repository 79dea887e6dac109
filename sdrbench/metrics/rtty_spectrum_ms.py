"""rtty_spectrum_ms (ms, program counter): the RTTY decoder's "spectrum"
stage, until the block's mean spectrum is on the host (the wait on its
events, the copies into the filterbank's input, the filterbank and the
pull), summed over the measured window's blocks by the chain's tap
(rtty_spectrum_ms, from the decoder's stage_ms), a block (the blocks the
executive's run drained). None where the run has no such counter."""


def read(run):
    key = "rtty_spectrum_ms"
    if not run.blocks_run or key not in run.tap_counters:
        return None
    return run.tap_counters[key] / run.blocks_run
