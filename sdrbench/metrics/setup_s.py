"""setup_s (s, host clock): from the process's start to the opening of
the measured window: imports, the scene and its capture, the App, the
kernels' build where there is none, the step's capture, the warm-up."""


def read(run):
    return run.setup_s
