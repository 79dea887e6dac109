"""hold_ms (ms, program counter): the executive's stage_ms["hold"] over
the measured window, a block (the blocks its run drained): a dispatched
block's wait for its drain, which the take of the block pipeline_depth + 1
after it starts. None where the program keeps no such counter."""


def read(run):
    if not run.blocks_run or "hold" not in run.stage_ms:
        return None
    return run.stage_ms["hold"] / run.blocks_run
