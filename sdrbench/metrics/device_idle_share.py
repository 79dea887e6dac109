"""device_idle_share (share, device trace): the share of the measured,
untraced window in which the device ran nothing: 1 minus the device's
busy ms a block, from the traced stretch (device_busy_ms), times the
blocks delivered in the window, over the window's ms. The traced
stretch's own busy over its wall (the result's device.busy_s over
device.window_s) counts the profiler's cost in its wall; this does not."""


def read(run):
    if run.trace is None or run.trace.busy_s <= 0:
        return None
    span = run.t_close - run.t_open
    n = sum(1 for t in run.delivered if run.t_open < t <= run.t_close)
    if span <= 0 or not n:
        return None
    return 1.0 - run.trace.busy_s / run.trace_blocks * n / span
