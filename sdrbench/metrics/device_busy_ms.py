"""device_busy_ms (ms, device trace): the seconds in which an operation
ran on the device over the traced stretch (the union of the profiler's
device activity), a block."""


def read(run):
    if run.trace is None or run.trace.busy_s <= 0:
        return None
    return 1e3 * run.trace.busy_s / run.trace_blocks
