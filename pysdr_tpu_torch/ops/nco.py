"""Numerically exact NCO (counterpart of pysdr_tpu/ops/nco.py).

A frequency is an integer numerator k of cycles/sample over DENOM = 2^22;
phase indices are exact modular integers, so phase never drifts. torch
has int64, so `(p0 + k*i) % DENOM` is computed directly (k, i < 2^24 keep
every product far below 2^63) and matches the reference's int32
hierarchical split bit for bit. k and p0 may be python ints or int64
tensors of any shape (a leading channel batch); outputs append the
sample axis.
"""

from __future__ import annotations

import numpy as np
import torch

DENOM_BITS = 22
DENOM = 1 << DENOM_BITS
_TWO_PI = 2.0 * np.pi


def snap_freq(freq_hz: float, fs: float) -> int:
    """Snap a frequency to the NCO grid; returns k in [0, DENOM)."""
    return int(round(freq_hz / fs * DENOM)) % DENOM


def snapped_freq_hz(k, fs: float):
    """Inverse of snap_freq: the realizable frequency in Hz of k (a
    python int or an array of them; k above DENOM/2 is negative)."""
    k = np.asarray(k)
    ks = np.where(k > DENOM // 2, k - DENOM, k)
    return ks / DENOM * fs


def _i64(v, device=None) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.int64, device=device)


def phase_indices(k, p0, n: int) -> torch.Tensor:
    """(p0 + k*i) mod DENOM for i in [0, n), int64 (..., n)."""
    k = _i64(k)
    p0 = _i64(p0, k.device)
    i = torch.arange(n, dtype=torch.int64, device=k.device)
    return (p0[..., None] + k[..., None] * i) % DENOM


def advance(k, p0, n: int) -> torch.Tensor:
    """Phase index after n samples: (p0 + k*n) mod DENOM, for any n."""
    k = _i64(k)
    return (_i64(p0, k.device) + k * (int(n) % DENOM)) % DENOM


def mul_mod(k, c: int) -> torch.Tensor:
    """(k * c) mod DENOM for a python int c."""
    return (_i64(k) * (int(c) % DENOM)) % DENOM


def phasor_table(k, p0, n: int, sign: float = -1.0) -> torch.Tensor:
    """exp(sign * j 2π (p0 + k i)/DENOM) for i in [0, n), complex64."""
    th = phase_indices(k, p0, n).to(torch.float32) \
        * np.float32(_TWO_PI / DENOM)
    return torch.complex(torch.cos(th), np.float32(sign) * torch.sin(th))


def lo_angles(k, p0, n: int) -> torch.Tensor:
    """A block of LO phase angles in radians, float32 (..., n): the exact
    phase indices (< 2^22, so exact in float32) times 2π/DENOM."""
    return phase_indices(k, p0, n).to(torch.float32) \
        * np.float32(_TWO_PI / DENOM)


def _pick_factor(n: int) -> int:
    """Largest power-of-two B <= 2048 dividing n (1 if n is odd)."""
    B = 1
    while B < 2048 and n % (B * 2) == 0:
        B *= 2
    return B


def _lo_block(k: torch.Tensor, p0, n: int, sign: float) -> torch.Tensor:
    """The LO block (..., n), formed as an outer product of two phasor
    tables on the exact phase grid (i = a*B + b): O(n/B + B)
    transcendentals instead of one cos+sin per sample."""
    B = _pick_factor(n)
    if B < 8 or n // B < 2:
        return phasor_table(k, p0, n, sign)
    hi = phasor_table(mul_mod(k, B), p0, n // B, sign)
    lo = phasor_table(k, torch.zeros_like(k), B, sign)
    return (hi[..., :, None] * lo[..., None, :]).reshape(*k.shape, n)


def tone(k, p0, n: int) -> torch.Tensor:
    """Complex LO block exp(+j 2π (p0 + k i)/DENOM), complex64 (..., n)."""
    return _lo_block(_i64(k), p0, n, 1.0)


def mix_down(x: torch.Tensor, k, p0):
    """y[i] = x[i] * exp(-j 2π (p0 + k i)/DENOM). Returns (y, new_p0)."""
    k = _i64(k, x.device)
    n = x.shape[-1]
    return x * _lo_block(k, p0, n, -1.0), advance(k, p0, n)
