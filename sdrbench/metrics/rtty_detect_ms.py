"""rtty_detect_ms (ms, program counter): the RTTY decoder's "detect" stage,
detection or rescan over the block's mean spectrum (a rescan every 4th block
with frames), summed over the measured window's blocks by the chain's tap
(rtty_detect_ms, from the decoder's stage_ms), a block (the blocks the
executive's run drained). None where the run has no such counter."""


def read(run):
    key = "rtty_detect_ms"
    if not run.blocks_run or key not in run.tap_counters:
        return None
    return run.tap_counters[key] / run.blocks_run
