"""WAV audio sink/source (stdlib `wave` + numpy).

The reference plays audio through PyAudio/PortAudio ring buffers
(receiver.py:837-874) and converts captures with sigs/sdr2wav.m; in this
framework the audio sink for offline/bench runs is a wav file (the realtime
path is runtime/executive + runtime/audio).

The port's own copy of pysdr_tpu/io/wav.py: the port imports nothing of
the JAX package.
"""

from __future__ import annotations

import wave

import numpy as np


def write_wav(path: str, audio, fs: float, stereo_from_complex: bool = True):
    """audio: float (n,) real, (n,) complex (L+jR, the framework's stereo
    packing — see ops/demod.py), or (n, 2)."""
    a = np.asarray(audio)
    if np.iscomplexobj(a):
        a = np.stack([a.real, a.imag], -1) if stereo_from_complex \
            else a.real[:, None]
    elif a.ndim == 1:
        a = a[:, None]
    if a.size == 0:                      # run ended before any audio
        a = np.zeros((0, max(1, a.shape[-1] if a.ndim == 2 else 1)),
                     np.float32)
    peak = (np.max(np.abs(a)) if a.size else 0.0) or 1.0
    if peak > 1.0:
        a = a / peak
    pcm = (np.clip(a, -1, 1) * 32767.0).astype("<i2")
    with wave.open(path, "wb") as w:
        w.setnchannels(a.shape[1])
        w.setsampwidth(2)
        w.setframerate(int(round(fs)))
        w.writeframes(pcm.tobytes())


def read_wav(path: str):
    with wave.open(path, "rb") as w:
        fs = w.getframerate()
        n = w.getnframes()
        nch = w.getnchannels()
        width = w.getsampwidth()
        raw = w.readframes(n)
    if width != 2:
        raise ValueError(f"{path}: only 16-bit PCM wav is supported "
                         f"(file has {8 * width}-bit samples)")
    a = np.frombuffer(raw, "<i2").astype(np.float32) / 32767.0
    return a.reshape(-1, nch), float(fs)
