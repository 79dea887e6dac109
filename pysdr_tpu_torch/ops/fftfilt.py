"""Overlap-save FFT convolution (counterpart of pysdr_tpu/ops/fftfilt.py).

y[i] = sum_t taps[t] * xp[i + T - 1 - t] over xp = [hist | x]; the new
history is the last T-1 input samples. One circular FFT of the next power
of two >= n + T - 1 per block, over a leading channel batch.
"""

from __future__ import annotations

import torch


def _next_pow2(n: int) -> int:
    return 1 << max(n - 1, 0).bit_length()


def fft_fir_block(x: torch.Tensor, hist: torch.Tensor, taps_c: torch.Tensor):
    """x complex64 (..., n); hist (..., T-1); taps_c complex64 (..., T)
    or (T,) shared. Returns (y complex64 (..., n), new_hist)."""
    n = x.shape[-1]
    t = taps_c.shape[-1]
    xp = torch.cat([hist, x], dim=-1)
    nfft = _next_pow2(n + t - 1)
    y_full = torch.fft.ifft(torch.fft.fft(xp, n=nfft)
                            * torch.fft.fft(taps_c, n=nfft))
    y = y_full[..., t - 1:t - 1 + n]
    new_hist = xp[..., n:] if t > 1 else hist
    return y, new_hist
