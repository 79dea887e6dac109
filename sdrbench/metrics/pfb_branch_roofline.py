"""pfb_branch_roofline (%, device trace): the bounds of the pfb_branch
launches of the traced stretch's steps (sdrbench/roofline.py, from the
cell's shapes: its chain's launches) over the device time of
pfb_branch_kernel in the trace."""

from sdrbench import roofline


def read(run):
    if run.trace is None:
        return None
    return roofline.share_pct("pfb_branch", run.launches,
                              {"pfb_branch": run.trace.timing("pfb_branch")})
