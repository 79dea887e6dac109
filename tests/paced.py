"""A source for the executive's tests that hands out blocks at a
stream's sample rate, as a radio does."""

import time

import numpy as np

from pysdr_tpu_torch.io.synth import SignalSpec, SynthSource


class PacedSynth:
    """Block i is handed out no earlier than (i + 1) block periods after
    the first read; the stream ends after `n` blocks (None: endless). The
    blocks are a SynthSource's AM tone at `fs`, or `blocks(i, n)`'s. With
    `gate` (a threading.Event a block, indexed by the block's id, which
    the caller sets when the block is delivered), block i + 1, and the
    stream's end after the last block, is also handed out no earlier than
    block i's delivery (2 s at most): so the next block is not ready
    while block i is in flight, on a loaded host too."""

    def __init__(self, fs: float, n: int | None = None, gate=None,
                 blocks=None):
        self.inner = SynthSource([SignalSpec(60e3, "am", 0.3, 400.0)], fs,
                                 noise_rms=0.01)
        self.fs, self.n = fs, n
        self.gate, self.blocks = gate, blocks
        self.t0 = None
        self.handed: list[float] = []

    def read_data(self, n, loop=False):
        if self.t0 is None:
            self.t0 = time.perf_counter()
        i = len(self.handed)
        if self.gate is not None and i:
            self.gate[i - 1].wait(timeout=2.0)
        if self.n is not None and i >= self.n:
            return np.zeros(0, np.complex64)
        wait = self.t0 + (i + 1) * n / self.fs - time.perf_counter()
        if wait > 0:
            time.sleep(wait)
        x = self.blocks(i, n) if self.blocks else self.inner.read_data(n)
        self.handed.append(time.perf_counter())
        return x
