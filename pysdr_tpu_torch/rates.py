"""Rational sample-rate planning.

Equivalent of the reference's `sig_proc.up_dn` and its offline sweep tool
(reference srates.py:28-74, params.py:405-406): given an RF input rate and a
desired audio output rate, find the minimal rational (UP, DOWN) such that
fs_out = fs_in * UP / DOWN, and derive TPU-friendly block sizes.

The reference validates e.g. 2.048 MHz -> 48 kHz = 3/128 and
8 MHz -> 192 kHz = 3/125 (srates.py:35-74); tests/test_resample.py
reproduces that table and checks the plan invariants.

The port's own copy of pysdr_tpu/rates.py, with its imports rewritten to
pysdr_tpu_torch: the port imports nothing of the JAX package.
"""

from __future__ import annotations

import dataclasses
from fractions import Fraction


def up_dn(fs_in: float, fs_out: float) -> tuple[int, int]:
    """Minimal rational resampling factors: fs_out = fs_in * up / down.

    Mirrors `sig_proc.up_dn(fs1, fs2)` usage (reference params.py:405,
    srates.py:32). Rates are rounded to the nearest Hz before reduction.
    """
    frac = Fraction(int(round(fs_out)), int(round(fs_in)))
    return frac.numerator, frac.denominator


@dataclasses.dataclass(frozen=True)
class RatePlan:
    """A fully derived rate/block plan for one resampling stage.

    The reference derives OUT_CHUNK_SIZE=1024 and
    IN_CHUNK_SIZE = 1024*DOWN/UP (params.py:440-444). On TPU we keep the
    same invariants (input block divisible by DOWN so the polyphase phase
    pattern is block-periodic) but default to much larger blocks: the real
    frame-time constraint is the host audio sink, not the compute.
    """

    fs_in: float
    fs_out: float
    up: int
    down: int
    in_block: int   # input samples per block (multiple of `down`)
    out_block: int  # output samples per block = in_block * up / down

    @property
    def ratio(self) -> float:
        return self.up / self.down

    @property
    def block_seconds(self) -> float:
        """Real-time budget per block (reference profiler.py:32 analogue)."""
        return self.out_block / self.fs_out


def rate_plan(fs_in: float, fs_out: float, out_block: int = 1024) -> RatePlan:
    """Build a RatePlan with an output block of at least `out_block` samples.

    Guarantees: in_block % down == 0 and out_block % up == 0, so each block
    starts at polyphase phase 0 and streaming state is block-invariant.
    """
    up, down = up_dn(fs_in, fs_out)
    # Smallest number of output samples that is a multiple of `up` and
    # >= requested out_block; the input block is then an exact multiple
    # of `down`.
    n_units = max(1, -(-out_block // up))  # ceil
    out_b = n_units * up
    in_b = n_units * down
    fs_out_exact = fs_in * up / down
    return RatePlan(fs_in=fs_in, fs_out=fs_out_exact, up=up, down=down,
                    in_block=in_b, out_block=out_b)


def sweep_table(fs_list=None, fs_out_list=(48e3, 96e3, 192e3)):
    """Offline sweep like reference srates.py:28-33: plan for every pair."""
    if fs_list is None:
        fs_list = [0.25e6, 1.024e6, 1.6e6, 2.048e6, 2.8e6, 3.2e6,
                   2e6, 4e6, 5e6, 6e6, 7e6, 8e6, 9e6, 10e6]
    rows = []
    for fs in fs_list:
        for fo in fs_out_list:
            u, d = up_dn(fs, fo)
            rows.append((fs, fo, u, d))
    return rows


if __name__ == "__main__":
    # offline rate-plan table, like the reference's srates.py tool
    # (srates.py:28-74): python -m pysdr_tpu_torch.rates
    print(f"{'fs_in':>12} {'fs_out':>9} {'up':>5} {'down':>6}")
    for fs, fo, u, d in sweep_table():
        print(f"{fs:12.0f} {fo:9.0f} {u:5d} {d:6d}")
