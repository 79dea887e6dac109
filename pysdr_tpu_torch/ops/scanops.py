"""First-order recurrences along time (counterpart of
pysdr_tpu/ops/scanops.py).

    y[n] = a[n] * y[n-1] + b[n]          (linrec, one_pole)
    last non-hold set/reset command wins  (sr_latch)

The JAX package evaluates these with `jax.lax.associative_scan`; torch
has no scan primitive. CUDA tensors go to the hand-written kernels in
pysdr_tpu_torch/csrc/scan.cu (kernels.scan), CPU tensors to the plain
versions here (`linrec_ref`, `sr_latch_ref`). There is no fallback from
one to the other: a tensor on any device other than the CPU takes the
kernel, and its wrapper raises if it cannot launch.

Layout is the reference's: time on axis -2 with k independent columns on
the last axis, plus an optional leading channel batch — a, b (n,),
(n, k) or (B, n, k). Streaming state is the last y, folded into the next
block, so chunked == whole-signal up to float reassociation.
"""

from __future__ import annotations

import numpy as np
import torch


def _as_bnk(x: torch.Tensor) -> torch.Tensor:
    if x.dim() == 1:
        return x[None, :, None]
    if x.dim() == 2:
        return x[None]
    if x.dim() == 3:
        return x
    raise ValueError(f"expected (n,), (n, k) or (B, n, k), got {x.shape}")


def linrec_ref(a: torch.Tensor, b: torch.Tensor, y_prev: torch.Tensor):
    """Plain torch twin of the linrec kernel: a log-depth doubling
    (Hillis-Steele) scan over the pairs (a, b) along axis -2.
    a, b: float32 (B, n, k); y_prev (B, k). Returns (y, y_last)."""
    A = a.clone()
    Bv = b.clone()
    Bv[:, 0, :] += A[:, 0, :] * y_prev
    n = a.shape[1]
    d = 1
    while d < n:
        Bn = Bv.clone()
        An = A.clone()
        Bn[:, d:, :] = A[:, d:, :] * Bv[:, :-d, :] + Bv[:, d:, :]
        An[:, d:, :] = A[:, d:, :] * A[:, :-d, :]
        A, Bv = An, Bn
        d *= 2
    return Bv, Bv[:, -1, :]


def sr_latch_ref(set_: torch.Tensor, reset: torch.Tensor,
                 g_prev: torch.Tensor):
    """Plain torch twin of the sr_latch kernel: cummax over the indices
    of non-hold commands. set_, reset: bool (B, n); g_prev float32 (B,).
    Returns (gate float32 (B, n), gate_last (B,))."""
    cmd = torch.where(set_, 1, torch.where(reset, -1, 0)).to(torch.int8)
    n = cmd.shape[-1]
    idx = torch.arange(n, device=cmd.device).expand_as(cmd)
    last = torch.where(cmd != 0, idx, -1).cummax(dim=-1).values
    eff = torch.gather(cmd, -1, last.clamp(min=0))
    init = torch.where(g_prev > 0.5, 1, -1).to(torch.int8)[:, None]
    eff = torch.where(last >= 0, eff, init)
    gate = (eff > 0).to(torch.float32)
    return gate, gate[:, -1]


def linrec(a, b: torch.Tensor, y_prev):
    """Evaluate y[n] = a[n]*y[n-1] + b[n] per column; y[-1] = y_prev.
    b float32 (n,), (n, k) or (B, n, k); a a float32 tensor of b's shape
    (a per-column constant expanded along n is taken as it is, without a
    copy) or a python float for every sample; y_prev broadcastable to
    (B, k). Returns (y, y_last) in b's layout."""
    shape = b.shape
    b3 = _as_bnk(b)
    B, _, k = b3.shape
    yp = torch.as_tensor(y_prev, dtype=b.dtype, device=b.device) \
        .expand(B, k)
    a3 = _as_bnk(a) if isinstance(a, torch.Tensor) else a
    if b.device.type == "cpu":
        if not isinstance(a3, torch.Tensor):
            a3 = b3.new_tensor(a3).expand(b3.shape)
        y, last = linrec_ref(a3, b3, yp)
    else:
        from pysdr_tpu_torch.kernels import scan
        y, last = scan.linrec(a3, b3, yp.contiguous())
    if len(shape) == 1:
        return y.reshape(shape), last.reshape(())
    if len(shape) == 2:
        return y[0], last[0]
    return y, last


def one_pole(x: torch.Tensor, alpha, y_prev):
    """One-pole lowpass y[n] = alpha*x[n] + (1-alpha)*y[n-1]. x in linrec's
    layout; alpha a python scalar, or a float32 tensor (k,) per column on
    x's device. A scalar stays a kernel argument: made into a device
    tensor it would be a blocking host-to-device copy every call. A
    tensor's 1-alpha goes to the kernel expanded, at stride 0 along n."""
    if isinstance(alpha, torch.Tensor):
        return linrec((1.0 - alpha).expand(x.shape), alpha * x, y_prev)
    alpha = np.float32(alpha)
    return linrec(float(np.float32(1.0) - alpha), x * float(alpha), y_prev)


def sr_latch(set_: torch.Tensor, reset: torch.Tensor, g_prev):
    """Set/reset hysteresis latch (set wins when both fire).
    set_, reset: bool (n,) or (B, n); g_prev float32 () or (B,).
    Returns (gate float32, gate_last) in the input's layout."""
    shape = set_.shape
    s2 = set_.reshape(-1, shape[-1])
    r2 = reset.reshape(-1, shape[-1])
    gp = torch.as_tensor(g_prev, dtype=torch.float32,
                         device=set_.device).reshape(-1).expand(s2.shape[0])
    if set_.device.type == "cpu":
        gate, last = sr_latch_ref(s2, r2, gp)
    else:
        from pysdr_tpu_torch.kernels import scan
        gate, last = scan.sr_latch(s2.contiguous(), r2.contiguous(),
                                   gp.contiguous())
    return gate.reshape(shape), last.reshape(shape[:-1])
