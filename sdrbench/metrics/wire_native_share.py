"""wire_native_share (%, program counter): of the blocks the measured
window's run drained, the share whose integer RF wire codes the C++
one-pass quantizer wrote straight into the pinned staging tensor
(stage_ms["wire_native"], a count, written by the executive's prefetch
thread): 0 where the executive fell back to numpy's quantize_host and a
copy, or the wire is f32. None where the program keeps no such
counter."""


def read(run):
    if not run.blocks_run or "wire_native" not in run.stage_ms:
        return None
    return 100.0 * run.stage_ms["wire_native"] / run.blocks_run
