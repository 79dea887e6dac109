"""sr_latch_roofline (%, device trace): the bounds of the sr_latch launches of
the traced stretch's steps (sdrbench/roofline.py, from the cell's
shapes: its chain's launches) over the device time of sr_latch_kernel in
the trace."""

from sdrbench import roofline


def read(run):
    if run.trace is None:
        return None
    return roofline.share_pct("sr_latch", run.launches,
                              {"sr_latch": run.trace.timing("sr_latch")})
