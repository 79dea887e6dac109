"""Longevity soak of the port (the twin of tests/test_soak.py's
test_soak_no_timing_drift_no_leak, with its thresholds): the port's App
on the CPU, display and PSD taps on, for 40 warm-up and 360 more blocks,
through the serial bank and through a 2 x 1 --mesh adapter (the CPU
device twice). The bank's step and each shard's body run over static
buffers made once, and the executive takes a fresh host tensor a block:
per-block time must not drift upward, and RSS must not keep growing
after warm-up. The card's soak of the graphed bank is chip_smoke.py
phase 11."""

import resource
import time

import pytest
import torch

from pysdr_tpu_torch import app as app_mod

torch.set_num_threads(1)


def _rss_mb() -> float:
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024.0


@pytest.mark.filterwarnings("ignore:stream segment")
@pytest.mark.parametrize("mesh", [[], ["--mesh", "2,1"]])
def test_soak_no_timing_drift_no_leak(mesh):
    args = app_mod.build_parser().parse_args(
        ["--device", "cpu", "--fs", "0.512", "--block", "2048", "--psd",
         "--psd-every", "4", *mesh])
    a = app_mod.App(args)
    ex = a.ex
    a.start_services()
    try:
        n_warm, n_run = 40, 360
        ex.run(n_blocks=n_warm)
        rss0 = _rss_mb()
        t0 = time.perf_counter()
        ex.run(n_blocks=n_warm + n_run // 2)
        t_first = time.perf_counter() - t0
        t0 = time.perf_counter()
        ex.run(n_blocks=n_warm + n_run)
        t_second = time.perf_counter() - t0
        rss1 = _rss_mb()
    finally:
        a.stop_services()
    assert ex.n_blocks == n_warm + n_run
    # per-block time stable: the second half must not run >=1.5x slower
    assert t_second < 1.5 * t_first + 0.25, (t_first, t_second)
    # memory flat after warm-up (ru_maxrss is a high-water mark, so any
    # increase means new peak allocations mid-soak)
    assert rss1 - rss0 < 200.0, (rss0, rss1)
    # waterfall frames exist and stayed bounded in size
    fr = a.display.frames.get("RF")
    assert fr is not None and fr.waterfall_u8.shape[0] <= 256
