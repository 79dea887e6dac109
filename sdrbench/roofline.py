"""The least time the card could take for the program's hand-written
kernels, from the shapes each cell launches.

A kernel's bound is the larger of its bytes over the memory rate and its
float32 operations over the float32 rate outside the tensor cores: each
input byte read once, each output byte written once (the arithmetic of
the port's kernel smoke checks). The peaks are NVIDIA's for the H100
SXM at its 700 W power limit; the run records the card's own limit
beside them (`power_limit_w`).
"""

from __future__ import annotations

import subprocess

HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
AGC_WINDOW = 64
WIRE_BYTES = {"f32": 4, "i16": 2, "i8": 1}


def bound_s(n_bytes: float, n_ops: float) -> float:
    return max(n_bytes / HBM_BYTES_PER_S, n_ops / F32_OPS_PER_S)


def linrec(batch: int, n: int, k: int, a_bytes: int) -> tuple[int, int]:
    """(bytes, operations): b in and y out, y_prev in and y_last out, the
    poles (`a_bytes`); one multiply-add a sample."""
    return 8 * batch * n * k + 8 * batch * k + a_bytes, 2 * batch * n * k


def sr_latch(batch: int, n: int) -> tuple[int, int]:
    """Two command bytes in and a float gate out a sample, g_prev and
    gate_last; one operation a sample."""
    return 6 * batch * n + 8 * batch, batch * n


def pfb_branch(m: int, n_ch: int, k: int, wire: str) -> tuple[int, int]:
    """The wire block in, the history and taps in, v and the new history
    out; a complex-by-real multiply-add (4 operations) a tap and output."""
    return (2 * m * n_ch * WIRE_BYTES[wire] + 2 * (k - 1) * n_ch * 8
            + n_ch * k * 4 + m * n_ch * 8, 4 * m * n_ch * k)


def step_launches(n_rx: int, out_block: int, pfb: tuple | None = None
                  ) -> dict[str, list[tuple[int, int]]]:
    """{kernel: [(bytes, operations) of each launch]} of one bank step:
    the demod's two fused scan passes (4 and 2 columns, per-column poles),
    the AGC's window-rate one-pole (a scalar pole), the squelch latch, and
    with `pfb` = (rows, channels, taps, wire) the filterbank's branch
    filter."""
    n_win = -(-out_block // AGC_WINDOW)
    out = {"linrec": [linrec(n_rx, out_block, 4, 16),
                      linrec(n_rx, out_block, 2, 8),
                      linrec(n_rx, n_win, 1, 0)],
           "sr_latch": [sr_latch(n_rx, out_block)]}
    if pfb is not None:
        out["pfb_branch"] = [pfb_branch(*pfb)]
    return out


def share_pct(kernel: str, launches: dict, timing: dict) -> float | None:
    """A kernel's share of its roofline over a traced stretch, in %: the
    bounds of the launches it made (`launches`, one step's, repeated for
    every step the stretch ran) over their device time. None where the
    stretch ran no launch of it. timing[kernel] = (launches seen, device
    seconds)."""
    per_step = launches.get(kernel)
    seen, dev_s = timing.get(kernel, (0, 0.0))
    if not per_step or not seen or dev_s <= 0:
        return None
    steps = seen / len(per_step)
    return 100.0 * steps * sum(bound_s(*b) for b in per_step) / dev_s


def power_limit_w() -> float | None:
    """The card's power limit in W, as nvidia-smi reports it."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=20, check=True).stdout
        return float(out.split()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None
