"""Critically sampled polyphase filterbank (PFB) channelizer (counterpart
of pysdr_tpu/ops/channelizer.py).

    v[m, r] = sum_k h[r + k*N] * x[(m-k)*N + r]      (branch filtering)
    y[m, c] = sum_r v[m, r] * exp(-j 2*pi c r / N)   (= FFT over r)

so channel c is x mixed down by c*fs/N and decimated by N. The branch
filter takes the RF wire block as it crossed from the host and
dequantizes it in its load: on a CUDA tensor the hand-written kernel
(csrc/pfb.cu, kernels.pfb), on a CPU tensor the plain twin
`branch_filter_ref`, with no fallback from one to the other. The channel
transform is `torch.fft.fft` over the branches: the JAX package's DFT
matmul was chosen for the TPU's matrix unit, and cuFFT computes the same
y[m, c] in natural (fftfreq) order.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from pysdr_tpu.ops import fir
from pysdr_tpu_torch.ops import cplx


@dataclasses.dataclass(frozen=True)
class ChannelizerDesign:
    fs_in: float
    n_channels: int
    taps_per_branch: int = 12
    atten_db: float = 70.0

    @property
    def fs_channel(self) -> float:
        return self.fs_in / self.n_channels

    def prototype(self) -> np.ndarray:
        """Lowpass prototype, cutoff at half the channel spacing, unity DC
        gain."""
        n, k = self.n_channels, self.taps_per_branch
        return fir.lowpass(n * k, 0.5 * self.fs_channel, self.fs_in,
                           self.atten_db)

    def center_freqs_hz(self) -> np.ndarray:
        """Channel center frequencies (fftfreq order: 0, +, ..., -)."""
        return np.fft.fftfreq(self.n_channels, 1.0 / self.fs_in)


def pack_branch_weights(h: np.ndarray, n_channels: int) -> np.ndarray:
    """(N*K,) prototype -> per-branch taps (N, K): h_pp[r, k] = h[r + k*N].
    Host numpy."""
    k = len(h) // n_channels
    return np.ascontiguousarray(
        np.asarray(h, np.float32).reshape(k, n_channels).T)


def history_len(design: ChannelizerDesign) -> int:
    """Input samples carried across blocks: (K-1)*N."""
    return (design.taps_per_branch - 1) * design.n_channels


def dft_matrix(n_channels: int, cols: np.ndarray | None = None):
    """DFT matrix W[r, c] = exp(-2j pi c r / N) as two float32 (N, C)
    real/imag factors (the JAX package's channel transform; here only a
    test oracle, the port's transform is an FFT)."""
    if cols is None:
        cols = np.arange(n_channels)
    r = np.arange(n_channels)[:, None]
    w = np.exp(-2j * np.pi * r * np.asarray(cols)[None, :] / n_channels)
    return (np.ascontiguousarray(w.real, dtype=np.float32),
            np.ascontiguousarray(w.imag, dtype=np.float32))


def branch_filter_ref(x: torch.Tensor, hist: torch.Tensor,
                      weights: torch.Tensor):
    """Plain torch twin of the pfb_branch kernel, the reference's formula:
    v[m, r] = sum_k h_pp[r, k] * xb[m + K-1-k, r] over the (M+K-1, N)
    view xb of [hist | x]. x complex64 (n,), hist ((K-1)*N,), weights
    float32 (N, K). Returns (v complex64 (n//N, N), new_hist)."""
    n = x.shape[0]
    nch, kk = weights.shape
    xp = torch.cat([hist, x])
    xb = xp.reshape(-1, nch)
    m = xb.shape[0] - (kk - 1)
    v = xb[kk - 1:kk - 1 + m] * weights[:, 0]
    for t in range(1, kk):
        v = v + xb[kk - 1 - t:kk - 1 - t + m] * weights[:, t]
    return v, xp[n:]


def branch_filter(x_wire: torch.Tensor, hist: torch.Tensor,
                  weights: torch.Tensor):
    """Branch filter of one RF wire block: float32 / int16 / int8 (n, 2)
    pairs, or complex64 (n,). A CPU tensor takes the plain twin; any other
    goes to the CUDA kernel, whose wrapper raises if it cannot launch.
    Returns (v complex64 (n//N, N), new_hist complex64 ((K-1)*N,))."""
    if x_wire.is_complex():
        x_wire = torch.view_as_real(x_wire)
    if x_wire.shape[0] % weights.shape[0]:
        raise ValueError(f"block of {x_wire.shape[0]} samples is not a "
                         f"multiple of N={weights.shape[0]}")
    if x_wire.device.type == "cpu":
        x = torch.view_as_complex(cplx.dequantize(x_wire).contiguous())
        return branch_filter_ref(x, hist, weights)
    from pysdr_tpu_torch.kernels import pfb
    return pfb.pfb_branch(x_wire.contiguous(), hist, weights)


def channel_transform(v: torch.Tensor) -> torch.Tensor:
    """v (M, N) complex64 -> (M, N) channel streams, column c the channel
    at c*fs/N (fftfreq order)."""
    return torch.fft.fft(v, dim=-1)


def channelize_block(x: torch.Tensor, hist: torch.Tensor,
                     weights: torch.Tensor):
    """Split one block into N channel streams. x: a wire block or complex64
    (n,); hist complex64 ((K-1)*N,); weights float32 (N, K).
    Returns (y (n//N, N) complex64 — row m, channel c in fftfreq order,
    new_hist)."""
    v, new_hist = branch_filter(x, hist, weights)
    return channel_transform(v), new_hist
