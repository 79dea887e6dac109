"""Hand-written CUDA kernels of the port, their build and wrappers.

Nothing here touches CUDA or nvcc at import time; the library is built
by the first launch (kernels.build.library)."""

from __future__ import annotations

from pysdr_tpu_torch.kernels import pfb, rtty, scan

# (wrapper, source in the repo, the JAX code it replaces)
KERNELS = (
    (scan.linrec, "pysdr_tpu_torch/csrc/scan.cu",
     "pysdr_tpu/ops/scanops.py:23"),
    (scan.sr_latch, "pysdr_tpu_torch/csrc/scan.cu",
     "pysdr_tpu/ops/scanops.py:66"),
    (pfb.pfb_branch, "pysdr_tpu_torch/csrc/pfb.cu",
     "pysdr_tpu/ops/channelizer.py:85"),
    (rtty.rtty_scores, "pysdr_tpu_torch/csrc/rtty.cu",
     "pysdr_tpu/models/rtty.py:117"),
)


def reset_launch_counts() -> None:
    for fn, _, _ in KERNELS:
        fn.launches = 0


def launch_counts() -> dict:
    return {fn.__name__: fn.launches for fn, _, _ in KERNELS}


def add_launches(counts: dict) -> None:
    """Add {wrapper name: launches} to the wrappers' counts: a replayed
    graph's tally (build.capture_tally) at each replay."""
    for fn, _, _ in KERNELS:
        fn.launches += counts.get(fn.__name__, 0)
