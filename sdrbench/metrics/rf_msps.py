"""rf_msps (Msamp/s, host clock): the RF samples of every block whose
audio reached the audio rings inside the window, over the window's
seconds. A stall inside the window shows as blocks that never arrived."""


def read(run):
    n = sum(1 for t in run.delivered if run.t_open < t <= run.t_close)
    return n * run.in_block / run.seconds / 1e6
