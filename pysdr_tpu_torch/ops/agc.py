"""Automatic gain control (counterpart of pysdr_tpu/ops/agc.py).

Feedforward max-tracking AGC: the envelope is a 64-sample window max
smoothed by a window-rate one-pole (the scan kernel on CUDA), with
instant attack inside the window; gain = ref / max(envelope, floor),
clamped to max_gain. Batched over a leading channel axis.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from pysdr_tpu_torch.ops import scanops

WINDOW = 64   # attack window (samples); sub-ms at 48 kHz


@dataclasses.dataclass(frozen=True)
class AGCParams:
    ref: float = 0.5          # target envelope
    decay: float = 0.001      # envelope one-pole alpha (attack is instant
                              # within the WINDOW)
    floor: float = 1e-6       # gain clamp = ref/floor
    max_gain: float = 1e4


def agc_block(x: torch.Tensor, env_prev: torch.Tensor, p: AGCParams,
              enabled=True):
    """Apply AGC to a block. x float32 or complex64 (B, n); env_prev
    float32 (B,); enabled bool or bool (B,). Returns (y, env_last,
    gain_last)."""
    mag = torch.abs(x).to(torch.float32)
    n = mag.shape[-1]
    pad = (-n) % WINDOW
    m = F.pad(mag, (0, pad)).reshape(*mag.shape[:-1], -1, WINDOW) \
        .amax(dim=-1)                                      # (B, n_win)
    # exact pole conversion to the window rate: WINDOW per-sample steps of
    # (1-decay) equal one window step of (1-decay)^WINDOW
    alpha_w = 1.0 - (1.0 - p.decay) ** WINDOW
    env_c, env_last = scanops.one_pole(m[..., None], alpha_w,
                                       env_prev[..., None])
    env_c = torch.maximum(env_c[..., 0], m)          # instant attack
    env = env_c[..., None].expand(*env_c.shape, WINDOW) \
        .reshape(*env_c.shape[:-1], -1)[..., :n]
    gain = p.ref / torch.clamp(env, min=p.floor)
    gain = torch.clamp(gain, max=p.max_gain)
    enabled = torch.as_tensor(enabled, device=x.device)
    en = enabled[..., None] if enabled.dim() else enabled
    gain = torch.where(en, gain, 1.0)
    y = x * gain
    # carry the SMOOTHED envelope, not the attacked one: the instant
    # attack applies to the gain only, so chunked processing equals one
    # whole-signal call (block invariance)
    return y, torch.where(enabled, env_last[..., 0], env_prev), gain[..., -1]
