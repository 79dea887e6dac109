"""The RF scene a cell replays: stations over white noise, made on the
device from the seed, written once as a .dat capture.

A configuration's `scene` gives the capture's length, rate and center,
the noise level and the stations: a list at fixed offsets, and/or one
station at the center of each of a seeded share of a channel grid. The
seed draws every station's level, audio and keying, which channels
carry one, and the noise; the sizes and the layout of the work are the
same for every seed. A station's kind is a module stations/<kind>.py:
its `AUDIO_HZ` band for the tones and its `baseband(s, n, fs, gen, dev)`.

The capture is the container the program replays (magic b'PSDRTPU1',
u32 header length, JSON header, raw little-endian samples) in a format
captures/<name>.json gives: complex float samples (`dtype` alone), or
interleaved integer I, Q pairs, value = (code - offset) / full_scale,
codes rounded and clipped to [min, max].
"""

from __future__ import annotations

import json
import struct

import numpy as np
import torch

from sdrbench import registry

MAGIC = b"PSDRTPU1"
AUDIO_TONES = 3


def _seed(seed: int) -> int:
    return int(seed) % (1 << 63)


def capture_format(name: str) -> dict:
    return registry.load_json("captures", name)


def station_kind(kind: str):
    return registry.module("stations", kind)


def station_plan(scene: dict, seed: int) -> list[dict]:
    """Every station's kind, offset from the capture's center, level and
    audio, drawn on the host from the seed."""
    rng = np.random.default_rng(_seed(seed))
    lo, hi = scene["level"]
    stations = [dict(s) for s in scene.get("stations", [])]
    grid = scene.get("channel_stations")
    if grid:
        n = grid["n_channels"]
        spacing = scene["fs"] / n
        chosen = np.sort(rng.choice(n, int(round(n * grid["share"])),
                                    replace=False))
        for c in chosen:
            off = c * spacing if c < n // 2 else (c - n) * spacing
            stations.append({"kind": grid["kind"], "offset_hz": float(off),
                             "channel": int(c)})
    for s in stations:
        s["level"] = float(rng.uniform(lo, hi))
        lo_hz, hi_hz = station_kind(s["kind"]).AUDIO_HZ
        s["tones_hz"] = rng.uniform(lo_hz, hi_hz, AUDIO_TONES).tolist()
        w = rng.uniform(0.2, 1.0, AUDIO_TONES)
        s["tone_amps"] = (w / w.sum()).tolist()
        s["tone_phases"] = rng.uniform(0, 2 * np.pi, AUDIO_TONES).tolist()
        s["cw_offset_hz"] = float(rng.uniform(0.0, 100.0))
    return stations


def tones(s, n, fs, dev):
    """The station's tones' amplitudes (T,), frequencies (T,) and phase
    arguments (T, n), float64."""
    t = torch.arange(n, dtype=torch.float64, device=dev) / fs
    f = torch.tensor(s["tones_hz"], dtype=torch.float64, device=dev)
    a = torch.tensor(s["tone_amps"], dtype=torch.float64, device=dev)
    p = torch.tensor(s["tone_phases"], dtype=torch.float64, device=dev)
    return a, f, 2 * np.pi * f[:, None] * t[None, :] + p[:, None]


def carrier(n0, n, off_hz, fs, dev):
    """exp(j 2 pi off n / fs) in float64, the phase reduced exactly."""
    i = torch.arange(n0, n0 + n, dtype=torch.float64, device=dev)
    cyc = torch.remainder(i * off_hz, fs) / fs
    return torch.polar(torch.ones_like(cyc), 2 * np.pi * cyc)


def make_scene(scene: dict, seed: int, device) -> torch.Tensor:
    """The capture's samples, complex64 (n,) on `device`."""
    dev = torch.device(device)
    n, fs = int(scene["samples"]), float(scene["fs"])
    gen = torch.Generator(device=dev)
    gen.manual_seed(_seed(seed))
    sig = torch.randn((n, 2), generator=gen, device=dev,
                      dtype=torch.float32) * np.float32(scene["noise_rms"])
    x = torch.view_as_complex(sig).to(torch.complex128)
    for s in station_plan(scene, seed):
        bb = station_kind(s["kind"]).baseband(s, n, fs, gen, dev)
        x = x + s["level"] * bb * carrier(0, n, s["offset_hz"], fs, dev)
    return x.to(torch.complex64)


def to_capture(x: torch.Tensor, fmt: dict) -> np.ndarray:
    """complex64 samples -> the capture's raw numpy samples."""
    dtype = getattr(torch, fmt["dtype"])
    if "full_scale" not in fmt:
        return x.to(dtype).cpu().numpy()
    q = torch.clamp(torch.round(torch.view_as_real(x) * fmt["full_scale"]
                                + fmt["offset"]), fmt["min"], fmt["max"])
    return q.to(dtype).reshape(-1).cpu().numpy()


def write_capture(path: str, raw: np.ndarray, fmt: dict, fs: float,
                  fc: float) -> None:
    hdr = json.dumps({"fs": fs, "fc": fc, "nchan": 1, "dtype": fmt["dtype"],
                      "tag": "raw_iq", "timestamp": 0.0}).encode()
    with open(path, "wb") as f:
        f.write(MAGIC + struct.pack("<I", len(hdr)) + hdr)
        f.write(np.ascontiguousarray(raw).tobytes())


def _values(fmt: dict) -> int:
    """Raw values a sample: an I, Q pair of integers, or one complex."""
    return 2 if "full_scale" in fmt else 1


def capture_samples(raw: np.ndarray, fmt: dict) -> int:
    return raw.shape[0] // _values(fmt)


def span(raw: np.ndarray, fmt: dict, start: int, n: int) -> np.ndarray:
    """Samples [start, start + n) of the capture replayed in a loop, in
    its raw form."""
    total = capture_samples(raw, fmt)
    idx = (start + np.arange(n, dtype=np.int64)) % total
    k = _values(fmt)
    return raw.reshape(-1, k)[idx].reshape(-1) if k > 1 else raw[idx]
