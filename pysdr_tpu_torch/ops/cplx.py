"""Wire formats (counterpart of the wire half of pysdr_tpu/ops/cplx.py).

RF blocks cross host->device as raw CS8/CS16 sample pairs (1/4 / 1/2 the
bytes of float32 pairs) and are dequantized on the device; audio comes
back as f32, linear i16 (4x headroom) or mu-law i8. Complex tensors are
used freely on either side of the transfer, so the TPU backend's
packing helpers have no counterpart here.
"""

from __future__ import annotations

import numpy as np
import torch

WIRE_SCALES = {"i8": 127.0, "i16": 32767.0}
WIRE_DTYPES = {"i8": np.int8, "i16": np.int16, "f32": np.float32}

AUDIO_WIRE_HEADROOM = 4.0
_MU = 255.0


def dequantize(x_p: torch.Tensor) -> torch.Tensor:
    """int8/int16 (..., 2) wire block -> float32; float32 passes through."""
    if x_p.dtype == torch.int8:
        return x_p.to(torch.float32) * np.float32(1.0 / 127.0)
    if x_p.dtype == torch.int16:
        return x_p.to(torch.float32) * np.float32(1.0 / 32767.0)
    return x_p


def quantize_audio_wire(xp: torch.Tensor, wire: str) -> torch.Tensor:
    """float32 audio pairs -> the audio wire dtype, on the tensor's device."""
    if wire == "f32":
        return xp
    if wire == "i8":
        y = torch.clamp(xp * np.float32(1.0 / AUDIO_WIRE_HEADROOM), -1.0, 1.0)
        c = torch.sign(y) * torch.log1p(_MU * torch.abs(y)) \
            * np.float32(1.0 / np.log1p(_MU))
        return torch.round(c * 127.0).to(torch.int8)
    if wire != "i16":
        raise ValueError(f"unknown audio wire {wire!r}")
    s = np.float32(32767.0 / AUDIO_WIRE_HEADROOM)
    return torch.clamp(torch.round(xp * s), -32767.0, 32767.0) \
        .to(torch.int16)


def _mulaw_decode_lut() -> np.ndarray:
    q = np.arange(-128, 128, dtype=np.float32) / 127.0
    x = np.sign(q) * ((1.0 + _MU) ** np.abs(np.clip(q, -1, 1)) - 1.0) / _MU
    return (x * AUDIO_WIRE_HEADROOM).astype(np.float32)


_MULAW_LUT = _mulaw_decode_lut()


def dequantize_audio_host(q: np.ndarray) -> np.ndarray:
    """Host: audio wire block -> float32 pairs; f32 passes through."""
    if q.dtype == np.int8:
        return _MULAW_LUT[q.astype(np.int16) + 128]
    if q.dtype == np.int16:
        return q.astype(np.float32) \
            * np.float32(AUDIO_WIRE_HEADROOM / 32767.0)
    return q


def quantize_host(xp: np.ndarray, wire: str) -> np.ndarray:
    """Host: float32 (..., 2) pairs -> wire dtype (full scale |x| = 1.0;
    beyond it clips like an ADC)."""
    if wire == "f32":
        return xp
    s = WIRE_SCALES[wire]
    return np.clip(np.rint(xp * s), -s, s).astype(WIRE_DTYPES[wire])
