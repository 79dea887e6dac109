"""wake_ms (ms, program counter): the executive's stage_ms["wake"] over
the measured window, a block (the blocks its run drained): in a block
drained while the executive waited for its next block, the time from
the copy waiter seeing its copies done to the drain's start; 0 in a
block whose drain a take started. None where the program keeps no such
counter."""


def read(run):
    if not run.blocks_run or "wake" not in run.stage_ms:
        return None
    return run.stage_ms["wake"] / run.blocks_run
