"""FSK: an RTTY station keying seeded Baudot characters without a pause,
continuous-phase FSK at 45.4545 baud, mark SHIFT_HZ / 2 above its
offset and space as far below (the port's test synthesizer's sense).

A character is 8 bits (start on space, 5 data bits LSB first, 2 stop
bits on mark), the decoder's character. The capture holds a whole number
of characters and is replayed in a loop, so the station keys the same
characters every loop: the first a LTRS shift code, then letters and
space in LTRS and figures and space in FIGS, each shift entered by its
code. Its phase advance over the loop, its carrier's included, is a
whole number of cycles (its frequency moved by under half a cycle a
loop), so no bit and no phase breaks where the loop closes.

The seed draws the characters and each station's phase at t = 0; how
many characters a station keys, where its bits fall and its offsets are
the same for every seed."""

import numpy as np
import torch

# station_plan draws audio tones for every kind; an FSK station keys none,
# and starts at the first tone's phase
AUDIO_HZ = (-85.0, 85.0)
BIT_S = 0.022                   # 45.4545 baud (RTTY_Params: 45.45)
SHIFT_HZ = 170.0
BITS_PER_CHAR = 8
LTRS, FIGS = 31, 27
# ITA2 codes of the characters a station sends in each shift
LETTERS = (3, 25, 14, 9, 1, 13, 26, 20, 6, 11, 15, 18, 28, 12, 24, 22, 23,
           10, 5, 16, 7, 30, 19, 29, 21, 17, 4)       # A-Z, space
FIGURES = (22, 23, 19, 1, 10, 16, 21, 7, 6, 24, 3, 29, 25, 28, 12, 4)
# 0-9 - / ? . , space
SHIFT_P = 0.2                   # the chance a character changes shift


def bit_samples(fs: float) -> int:
    """Samples a bit; a whole number at the rates the cells use
    (45,056 at 2.048 MHz, 2112 at 96 kHz)."""
    n = fs * BIT_S
    if abs(n - round(n)) > 1e-6:
        raise ValueError(f"{fs} Hz holds no whole number of samples a bit")
    return int(round(n))


def char_count(n: int, fs: float) -> int:
    """The characters a capture of n samples holds, which must be a whole
    number."""
    per = BITS_PER_CHAR * bit_samples(fs)
    if n % per:
        raise ValueError(f"{n} samples are no whole number of "
                         f"{per}-sample characters")
    return n // per


def characters(n_chars: int, gen, dev) -> list[int]:
    """The ITA2 codes a station keys, drawn from the seeded generator:
    a LTRS code, then characters of the current shift, each with the
    chance SHIFT_P of a shift code to the other shift first (one code of
    the n_chars either way)."""
    u = torch.rand((n_chars, 2), generator=gen, device=dev,
                   dtype=torch.float64).cpu().numpy()
    codes, figs = [LTRS], False
    for a, b in u[1:]:
        if a < SHIFT_P:
            figs = not figs
            codes.append(FIGS if figs else LTRS)
        else:
            table = FIGURES if figs else LETTERS
            codes.append(table[min(int(b * len(table)), len(table) - 1)])
    return codes


def bits(codes) -> np.ndarray:
    """+1 (mark) / -1 (space) a bit, 8 a character."""
    out = []
    for c in codes:
        out += [-1] + [1 if (c >> k) & 1 else -1 for k in range(5)] + [1, 1]
    return np.asarray(out, np.float64)


def baseband(s, n, fs, gen, dev):
    per_bit = bit_samples(fs)
    keyed = bits(characters(char_count(n, fs), gen, dev))
    dev_hz = torch.from_numpy(keyed * (SHIFT_HZ / 2)).to(dev)
    # whole cycles over the loop, the carrier's (scene.carrier) included
    cycles = float(keyed.sum()) * (SHIFT_HZ / 2) * per_bit / fs \
        + s["offset_hz"] * n / fs
    trim = (round(cycles) - cycles) * fs / n
    f = (dev_hz + trim).repeat_interleave(per_bit)
    # the phase before each sample, from the station's phase at t = 0
    cyc = torch.cumsum(torch.cat([f.new_zeros(1), f[:-1]]), 0) / fs \
        + s["tone_phases"][0] / (2 * np.pi)
    return torch.polar(torch.ones_like(cyc), 2 * np.pi * torch.remainder(
        cyc, 1.0))
