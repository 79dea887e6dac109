"""decode_ms (ms, program counter): the executive's stage_ms["decode"]
over the measured window, a block (the blocks its run drained): the
drain's audio_from_wire, the part of drain_ms after the event wait. None
where the program keeps no such counter."""


def read(run):
    if not run.blocks_run or "decode" not in run.stage_ms:
        return None
    return run.stage_ms["decode"] / run.blocks_run
