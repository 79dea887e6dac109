"""handoff_ms (ms, program counter): the executive's stage_ms["handoff"]
over the measured window, a block (the blocks its run drained): from the
prefetch thread's issue of a block to the executive's take of it (the
queue's put and the waiting get's wake-up). None where the program keeps
no such counter."""


def read(run):
    if not run.blocks_run or "handoff" not in run.stage_ms:
        return None
    return run.stage_ms["handoff"] / run.blocks_run
