"""Polyphase resample, and fused NCO mix + polyphase resample of a
channel bank (counterpart of pysdr_tpu/ops/resample.py: pack_weights,
pack_weight_bank, history_len, resample_block batched over channels,
mixed_resample_bank).

Polyphase output y[j*up + u] = sum_s xp[j*down + s] * W[u, s] over the
window s < L = down + Kp - 1. The window decomposes over s = t*down + d
into q = ceil(L/down) row-shifted views X[t:t+m] of the (m+q, down)
reshape of [hist | x], so the resample is q skinny matmuls and the (m, L)
frame matrix is never built. The exact integer-phase LO factors on that
grid as A[j]·C[t]·B[d], so mixing folds into complex per-channel weights
and every channel rides the N dimension of the same matmuls.
"""

from __future__ import annotations

import numpy as np
import torch

from pysdr_tpu_torch.ops import nco


def taps_per_phase(ntaps: int, up: int) -> int:
    return -(-ntaps // up)


def pack_weights(h: np.ndarray, up: int, down: int) -> np.ndarray:
    """Prototype taps h (ntaps,) -> polyphase weights (up, 1, L) float32:
    W[u, 0, off_u + Kp - 1 - t] = h[p_u + up*t], p_u = (u*down) % up,
    off_u = (u*down) // up. Host numpy."""
    h = np.asarray(h, np.float32)
    kp = taps_per_phase(h.shape[0], up)
    h_pad = np.zeros(up * kp, np.float32)
    h_pad[:h.shape[0]] = h
    h_pp = h_pad.reshape(kp, up).T            # h_pp[p, t] = h[p + up*t]
    W = np.zeros((up, 1, down + kp - 1), np.float32)
    for u in range(up):
        s = (u * down) // up + kp - 1 - np.arange(kp)
        W[u, 0, s] = h_pp[(u * down) % up]
    return W


def pack_weight_bank(bank: np.ndarray, up: int, down: int) -> np.ndarray:
    """Filter bank (n_bw, ntaps) -> (n_bw, up, 1, L)."""
    return np.stack([pack_weights(h, up, down) for h in bank])


def history_len(ntaps: int, up: int) -> int:
    """Input-rate history carried across blocks: Kp - 1."""
    return taps_per_phase(ntaps, up) - 1


def resample_block(x: torch.Tensor, hist: torch.Tensor,
                   weights: torch.Tensor, *, up: int, down: int):
    """Resample every channel's block by up/down with its own weight row.

    x complex64 (B, n), n % down == 0; hist complex64 (B, Kp-1) each
    channel's input tail; weights float32 (B, up, 1, L) from pack_weights.
    Returns (y complex64 (B, n*up//down), new_hist (B, Kp-1)). Real and
    imaginary parts ride a batch axis of the same q slab matmuls."""
    B, n = x.shape
    if n % down:
        raise ValueError(f"block {n} is not a multiple of down={down}")
    _, up_w, _, L = weights.shape
    if up_w != up:
        raise ValueError(f"weights carry {up_w} phases, expected {up}")
    q = -(-L // down)
    m = n // down
    kp1 = hist.shape[-1]
    xp = torch.cat([hist, x], dim=-1)                       # (B, n+Kp-1)
    X = torch.view_as_real(xp).permute(0, 2, 1)             # (B, 2, n+Kp-1)
    X = torch.nn.functional.pad(X, (0, (m + q) * down - n - kp1))
    X = X.reshape(B, 2, m + q, down)
    w = torch.nn.functional.pad(weights[:, :, 0, :], (0, q * down - L))
    wt = w.reshape(B, up, q, down).permute(0, 2, 3, 1)[:, :, None]
    y = X[:, :, 0:m] @ wt[:, 0]                     # (B, 2, m, up)
    for t in range(1, q):
        y = y + X[:, :, t:t + m] @ wt[:, t]
    y = torch.complex(y[:, 0], y[:, 1]).reshape(B, m * up)
    return y, (xp[:, n:] if kp1 else hist)


def mixed_resample_bank(x: torch.Tensor, hist: torch.Tensor,
                        weights: torch.Tensor, k: torch.Tensor,
                        p0: torch.Tensor, *, up: int, down: int):
    """Mix every channel down by its NCO and resample by up/down, from
    the shared raw block.

    x complex64 (n,), n % down == 0; hist complex64 (Kp-1,) raw tail of
    the previous block; weights float32 (n_rx, up, 1, L); k, p0 int64
    (n_rx,) NCO numerators and phase indices at hist[0].
    Returns complex64 (n_rx, n*up//down).
    """
    n = x.shape[0]
    if n % down:
        raise ValueError(f"block {n} is not a multiple of down={down}")
    n_rx, up_w, _, L = weights.shape
    if up_w != up:
        raise ValueError(f"weights carry {up_w} phases, expected {up}")
    q = -(-L // down)
    m = n // down
    xp = torch.cat([hist, x, x.new_zeros((m + q) * down - n - hist.shape[0])])
    X = torch.view_as_real(xp)                      # (N, 2) float32
    Xr = X[:, 0].contiguous().reshape(m + q, down)
    Xi = X[:, 1].contiguous().reshape(m + q, down)

    kd = nco.mul_mod(k, down)
    B = nco.phasor_table(k, torch.zeros_like(k), down)     # (n_rx, down)
    C = nco.phasor_table(kd, torch.zeros_like(kd), q)      # (n_rx, q)
    A = nco.phasor_table(kd, p0, m)                        # (n_rx, m)

    w = torch.nn.functional.pad(weights[:, :, 0, :], (0, q * down - L))
    wq = w.reshape(n_rx, up, q, down)
    Wc = wq * (C[:, None, :, None] * B[:, None, None, :])  # complex
    nu = n_rx * up
    Wt = Wc.permute(2, 3, 0, 1).reshape(q, down, nu)
    R = torch.cat([Wt.real, Wt.imag], dim=2).contiguous()  # (q, down, 2nu)
    Sr = Xr[0:m] @ R[0]
    Si = Xi[0:m] @ R[0]
    for t in range(1, q):
        Sr = Sr + Xr[t:t + m] @ R[t]
        Si = Si + Xi[t:t + m] @ R[t]
    # (Xr + jXi) @ (Wr + jWi): re = XrWr - XiWi, im = XrWi + XiWr
    y = torch.complex(Sr[:, :nu] - Si[:, nu:], Sr[:, nu:] + Si[:, :nu])
    y = y.reshape(m, n_rx, up) * A.T[:, :, None]
    return y.permute(1, 0, 2).reshape(n_rx, m * up)
