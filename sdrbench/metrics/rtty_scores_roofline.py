"""rtty_scores_roofline (%, device trace): the bounds of the rtty_scores
launches of the traced stretch (the rtty chain's launch table: a launch a
block at the decoder's frames a block, channels and carried tail) over
the device time of rtty_scores_kernel in the trace. None where the
stretch ran none."""

from sdrbench import roofline


def read(run):
    if run.trace is None:
        return None
    return roofline.share_pct("rtty_scores", run.launches,
                              {"rtty_scores": run.trace.timing("rtty_scores")})
