"""idle_drain_share (%, program counter): of the blocks the measured
window's run drained, the share the executive drained while it waited
for its next block (stage_ms["idle_drain"], a count): a block drained as
soon as its copies were done, not at the take of the block
pipeline_depth + 1 after it. None where the program keeps no such
counter."""


def read(run):
    if not run.blocks_run or "idle_drain" not in run.stage_ms:
        return None
    return 100.0 * run.stage_ms["idle_drain"] / run.blocks_run
