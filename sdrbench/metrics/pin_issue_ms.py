"""pin_issue_ms (ms, program counter): the executive's
stage_ms["pin+issue"] over the measured window, a block (the blocks its
run drained)."""


def read(run):
    if not run.blocks_run:
        return None
    return run.stage_ms["pin+issue"] / run.blocks_run
