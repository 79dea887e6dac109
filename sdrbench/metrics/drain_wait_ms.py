"""drain_wait_ms (ms, program counter): the executive's
stage_ms["drain_wait"] over the measured window, a block (the blocks its
run drained): the drain's wait on the block's host-copy events, the part
of drain_ms that is not the decode. None where the program keeps no such
counter."""


def read(run):
    if not run.blocks_run or "drain_wait" not in run.stage_ms:
        return None
    return run.stage_ms["drain_wait"] / run.blocks_run
