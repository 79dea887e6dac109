"""linrec_roofline (%, device trace): the bounds of the linrec launches of
the traced stretch's steps (sdrbench/roofline.py, from the cell's
shapes: its chain's launches) over the device time of linrec_kernel in
the trace."""

from sdrbench import roofline


def read(run):
    if run.trace is None:
        return None
    return roofline.share_pct("linrec", run.launches,
                              {"linrec": run.trace.timing("linrec")})
