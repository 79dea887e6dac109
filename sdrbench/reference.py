"""The plain reference of the benchmark's receiver chains.

It works out, from the RF scene's raw samples and the configuration as
run, the audio every receiver or channel hands to the audio rings:

    file samples -> RF wire (quantize, dequantize) ->
      receivers: exact-phase LO mix -> upfirdn polyphase resample
      channels:  polyphase filterbank -> DFT over the branches ->
                 exact-phase fine mix -> upfirdn polyphase resample
    -> demod (AM |x|, NFM discriminator, USB, CW with its BFO) -> AF FIR
    -> squelch power envelopes and hysteresis latch -> click smoother ->
    DC blocker -> AGC (64-sample windows from each block's start) ->
    audio wire (f32, linear i16, mu-law i8) and its host decode.

Plain torch, float32 (TF32 off), on whatever device the tensors are on.
Every filter is designed here again from its definition (Kaiser windowed
sinc), every state is this module's own, and every dot product goes
through `Arith`, so the control can compute the same chain with the
operands of its products rounded to TF32. It imports nothing of the
program under test.

The chains themselves, a bank of receivers and a channelizer, are
modules of their own (chains/); this module holds what they share.

A span is computed from zero state. Every state of these chains but the
squelch latch forgets its start within a few thousand audio samples,
and the latch follows the last set or reset command, so a span that
starts a second of audio before the compared block gives that block's
audio exactly as a run from the stream's start would, once each latch
has met a command before the block (`demod` says whether it had).
"""

from __future__ import annotations

import dataclasses
from fractions import Fraction

import numpy as np
import torch
import torch.nn.functional as F

from sdrbench import registry

DENOM = 1 << 22                 # NCO grid: a frequency is k / DENOM cycles
VIDEO_ATTEN_DB = 60.0           # the resamplers' anti-alias filters
AF_TAPS = 256
AF_BW_HZ = {"AM": 5e3, "NFM": 5e3, "USB": 3e3, "LSB": 3e3, "CW": 500.0}
SSB_LOW_HZ = 50.0
CW_BFO_HZ = 700.0
NFM_DEVIATION_HZ = 5e3
SQUELCH_ALPHA = 0.001
SQUELCH_HYST = 0.5
DC_POLE = 0.9985
DC_MODES = ("AM", "USB", "LSB", "CW")
AGC_WINDOW = 64
AGC_REF, AGC_DECAY, AGC_FLOOR, AGC_MAX_GAIN = 0.5, 0.001, 1e-6, 1e4
AUDIO_HEADROOM = 4.0
MU = 255.0
SCAN_CHUNK = 128


# ---------------------------------------------------------------- design

def kaiser_beta(atten_db: float) -> float:
    if atten_db > 50:
        return 0.1102 * (atten_db - 8.7)
    if atten_db >= 21:
        return 0.5842 * (atten_db - 21) ** 0.4 + 0.07886 * (atten_db - 21)
    return 0.0


def lowpass(ntaps: int, cutoff_hz: float, fs: float, atten_db: float = 60.0,
            scale: float = 1.0) -> np.ndarray:
    """Kaiser windowed sinc, unity DC gain times `scale`, float32."""
    m = np.arange(ntaps) - (ntaps - 1) / 2.0
    fc = cutoff_hz / fs
    h = 2 * fc * np.sinc(2 * fc * m) * np.kaiser(ntaps, kaiser_beta(atten_db))
    h /= h.sum()
    return (h * scale).astype(np.float32)


def complex_bandpass(f1_hz: float, f2_hz: float, fs: float, ntaps: int,
                     atten_db: float = 60.0) -> np.ndarray:
    """One-sided bandpass [f1, f2]: the lowpass of half the width moved to
    the band's center, complex64."""
    lp = lowpass(ntaps, (f2_hz - f1_hz) / 2.0, fs, atten_db).astype(np.float64)
    fc = 0.5 * (f1_hz + f2_hz) / fs
    return (lp * np.exp(2j * np.pi * fc * np.arange(ntaps))).astype(
        np.complex64)


def resampler_taps(fs_in: float, up: int, down: int,
                   taps_per_phase: int) -> np.ndarray:
    """The anti-alias lowpass of an up/down resampler at fs_in * up, gain
    `up`, passing 0.92 of the lower of the two Nyquist rates."""
    nyq = min(fs_in * up / (2.0 * down), fs_in / 2.0)
    return lowpass(up * taps_per_phase, 0.92 * nyq, fs_in * up,
                   VIDEO_ATTEN_DB, scale=float(up))


def up_down(fs_in: float, fs_out: float) -> tuple[int, int]:
    f = Fraction(int(round(fs_out)), int(round(fs_in)))
    return f.numerator, f.denominator


def snap(freq_hz: float, fs: float) -> int:
    """A frequency on the NCO grid: k in [0, DENOM)."""
    return int(round(freq_hz / fs * DENOM)) % DENOM


def af_taps(mode: str, fs: float) -> np.ndarray:
    bw = min(AF_BW_HZ[mode], 0.45 * fs)
    if mode == "CW":
        return complex_bandpass(CW_BFO_HZ - bw / 2, CW_BFO_HZ + bw / 2, fs,
                                AF_TAPS)
    if mode == "USB":
        return complex_bandpass(SSB_LOW_HZ, bw, fs, AF_TAPS)
    if mode == "LSB":
        return complex_bandpass(-bw, -SSB_LOW_HZ, fs, AF_TAPS)
    return lowpass(AF_TAPS, bw, fs).astype(np.complex64)


# ------------------------------------------------------------ arithmetic

def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest value with TF32's 10 mantissa bits."""
    i = x.contiguous().view(torch.int32)
    return ((i + 0x1000) & ~0x1FFF).view(torch.float32)


@dataclasses.dataclass(frozen=True)
class Arith:
    """How the chain's products are taken: float32 (TF32 off, the
    configuration's precision), or with every operand of a matrix
    product rounded to TF32 first (the control)."""
    tf32: bool = False

    def r(self, x: torch.Tensor) -> torch.Tensor:
        return round_tf32(x) if self.tf32 else x

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self.r(a) @ self.r(b)

    def cmm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """Complex (..., T) frames times complex (T,) taps."""
        ar, ai = a.real.contiguous(), a.imag.contiguous()
        br, bi = b.real.contiguous(), b.imag.contiguous()
        return torch.complex(self.mm(ar, br) - self.mm(ai, bi),
                             self.mm(ar, bi) + self.mm(ai, br))


# ----------------------------------------------------------------- scans

def _powers(a: float, n: int, device) -> torch.Tensor:
    """P[i, j] = a^(i-j) for i >= j, else 0 (float32, n x n)."""
    d = torch.arange(n, device=device)
    e = (d[:, None] - d[None, :]).to(torch.float64)
    return torch.where(e >= 0, torch.tensor(a, dtype=torch.float64,
                                            device=device) ** e.clamp(min=0),
                       0.0).to(torch.float32)


def one_pole_scan(a: float, b: torch.Tensor, y0: torch.Tensor,
                  ar: Arith) -> torch.Tensor:
    """y[n] = a * y[n-1] + b[n] along the last axis of b (R, n), float32,
    y[-1] = y0 (R,): chunks of SCAN_CHUNK solved as matrix products, the
    chunks' carries by the same recurrence at a^SCAN_CHUNK."""
    R, n = b.shape
    c = min(SCAN_CHUNK, n)
    pw = (torch.tensor(a, dtype=torch.float64, device=b.device)
          ** torch.arange(1, c + 1, device=b.device, dtype=torch.float64)
          ).to(torch.float32)
    P = _powers(a, c, b.device)
    if n <= c:
        return ar.mm(b, P.T) + y0[:, None] * pw
    k = -(-n // c)
    loc = ar.mm(F.pad(b, (0, k * c - n)).reshape(R * k, c), P.T) \
        .reshape(R, k, c)
    carry = one_pole_scan(a ** c, loc[..., -1].contiguous(), y0, ar)
    prev = torch.cat([y0[:, None], carry[:, :-1]], dim=1)
    return (loc + prev[..., None] * pw).reshape(R, k * c)[:, :n]


def latch(set_: torch.Tensor, reset: torch.Tensor, g0: float = 1.0):
    """Set/reset latch, set winning: the last command decides, g0 before
    the first. Returns (gate float32 (R, n), the index of the last
    command at each sample, -1 before the first (R, n))."""
    n = set_.shape[-1]
    cmd = torch.where(set_, 1, torch.where(reset, -1, 0))
    idx = torch.arange(n, device=set_.device).expand_as(cmd)
    last = torch.where(cmd != 0, idx, -1).cummax(dim=-1).values
    eff = torch.gather(cmd, -1, last.clamp(min=0))
    eff = torch.where(last >= 0, eff, 1 if g0 > 0.5 else -1)
    return (eff > 0).to(torch.float32), last


# --------------------------------------------------------------- filters

def fir(x: torch.Tensor, taps: torch.Tensor, ar: Arith) -> torch.Tensor:
    """y[i] = sum_t taps[t] x[i-t], zero before the span; x complex (R, n),
    taps complex (T,). Rows go in groups whose frames stay near 2^26
    values."""
    R, n = x.shape
    t = taps.shape[0]
    step = max(1, (1 << 26) // (n * t))
    out = []
    for r0 in range(0, R, step):
        xp = F.pad(torch.view_as_real(x[r0:r0 + step]).movedim(-1, 0),
                   (t - 1, 0))
        fr = xp[0].unfold(-1, t, 1)
        fi = xp[1].unfold(-1, t, 1)
        out.append(ar.cmm(torch.complex(fr, fi), taps.flip(0)))
    return torch.cat(out)


def lo(k: int, start: int, n: int, sign: float, device) -> torch.Tensor:
    """exp(sign j 2 pi (k (start + i) mod DENOM) / DENOM), complex64 (n,)."""
    i = torch.arange(n, dtype=torch.int64, device=device) + start
    ph = ((i % DENOM) * k % DENOM).to(torch.float64) * (2 * np.pi / DENOM)
    return torch.polar(torch.ones_like(ph), sign * ph).to(torch.complex64)


def resample(z: torch.Tensor, h: torch.Tensor, up: int, down: int,
             ar: Arith) -> torch.Tensor:
    """upfirdn: y[m] = sum_n z[n] h[m down - n up], zero before the span;
    z complex (R, n) with n % down == 0, h float32. Phase u of the output
    (m = j up + u) takes taps h[p + up t], p = u down mod up, at inputs
    j down + u down // up - t."""
    R, n = z.shape
    m = n // down
    kp = -(-h.shape[0] // up)
    hp = F.pad(h, (0, up * kp - h.shape[0]))
    zp = F.pad(torch.view_as_real(z).movedim(-1, 0), (kp - 1, 0))
    out = []
    for u in range(up):
        p, off = (u * down) % up, (u * down) // up
        g = hp[p::up].flip(0)
        fr = zp[0, :, off:].unfold(-1, kp, down)[:, :m]
        fi = zp[1, :, off:].unfold(-1, kp, down)[:, :m]
        out.append(torch.complex(ar.mm(fr, g), ar.mm(fi, g)))
    return torch.stack(out, dim=-1).reshape(R, m * up)


def filterbank(x: torch.Tensor, h: torch.Tensor, n_ch: int,
               ar: Arith) -> torch.Tensor:
    """Critically sampled polyphase filterbank, zero before the span:
    v[m, r] = sum_k h[r + k N] x[(m - k) N + r], then channel c of row m
    is sum_r v[m, r] exp(-2 pi j c r / N). x complex (n,), n % N == 0.
    Returns the channel streams (N, n // N)."""
    k = h.shape[0] // n_ch
    m = x.shape[0] // n_ch
    xr = ar.r(F.pad(torch.view_as_real(x).T.contiguous(),
                    ((k - 1) * n_ch, 0))).reshape(2, -1, n_ch)
    hk = ar.r(h.reshape(k, n_ch))               # hk[j, r] = h[r + j N]
    v = torch.zeros((2, m, n_ch), dtype=torch.float32, device=x.device)
    for j in range(k):                          # rows m - j of x's (M, N)
        v += xr[:, k - 1 - j:k - 1 - j + m] * hk[j]
    return torch.fft.fft(torch.complex(v[0], v[1]), dim=-1).T


# ----------------------------------------------------------------- wires

def rf_wire(raw: np.ndarray, fmt: dict, wire: str) -> np.ndarray:
    """The file's raw samples in capture format `fmt` (captures/*.json)
    -> the float32 (n, 2) pairs the device computes on: the reader's
    conversion ((code - offset) / full_scale for integer pairs), the
    host's wire quantize (full scale 127 or 32767, clipped) and the
    device's dequantize."""
    if "full_scale" in fmt:
        x = (raw.reshape(-1, 2).astype(np.float32)
             - np.float32(fmt["offset"])) * np.float32(1.0 / fmt["full_scale"])
    else:
        x = np.ascontiguousarray(raw, np.complex64).view(np.float32) \
            .reshape(-1, 2)
    if wire == "f32":
        return x
    s = {"i8": 127.0, "i16": 32767.0}[wire]
    q = np.clip(np.rint(x * s), -s, s).astype(
        {"i8": np.int8, "i16": np.int16}[wire])
    return q.astype(np.float32) * np.float32(1.0 / s)


def _mulaw_table() -> np.ndarray:
    q = np.arange(-128, 128, dtype=np.float32) / 127.0
    x = np.sign(q) * ((1.0 + MU) ** np.abs(np.clip(q, -1, 1)) - 1.0) / MU
    return (x * AUDIO_HEADROOM).astype(np.float32)


def audio_wire(audio: torch.Tensor, wire: str) -> np.ndarray:
    """Complex audio (R, n) -> the host's decoded audio after the wire,
    complex64 numpy (R, n)."""
    xp = torch.view_as_real(audio.to(torch.complex64)).contiguous()
    if wire == "i8":
        y = torch.clamp(xp * np.float32(1.0 / AUDIO_HEADROOM), -1.0, 1.0)
        c = torch.sign(y) * torch.log1p(MU * torch.abs(y)) \
            * np.float32(1.0 / np.log1p(MU))
        q = torch.round(c * 127.0).to(torch.int8).cpu().numpy()
        out = _mulaw_table()[q.astype(np.int16) + 128]
    elif wire == "i16":
        s = np.float32(32767.0 / AUDIO_HEADROOM)
        q = torch.clamp(torch.round(xp * s), -32767.0, 32767.0) \
            .to(torch.int16).cpu().numpy()
        out = q.astype(np.float32) * np.float32(AUDIO_HEADROOM / 32767.0)
    elif wire == "f32":
        out = xp.cpu().numpy()
    else:
        raise ValueError(f"unknown audio wire {wire!r}")
    return np.ascontiguousarray(out).view(np.complex64)[..., 0]


# ----------------------------------------------------------------- demod

def demod(bb: torch.Tensor, mode: str, fs: float, start: int,
          out_block: int, squelch_db: float, ar: Arith, check_from: int):
    """Baseband (R, n) at fs, all rows in `mode`, the span's first sample
    at audio index `start` (a multiple of out_block) -> (audio complex
    (R, n), whether each row's squelch latch had met a command before
    sample `check_from` of the span (R,))."""
    R, n = bb.shape
    dev = bb.device
    taps = torch.from_numpy(af_taps(mode, fs)).to(dev)
    if mode == "AM":
        z = bb.abs().to(torch.complex64)
    elif mode == "NFM":
        prev = F.pad(bb, (1, 0))[:, :-1]
        prod = bb * prev.conj()
        fm = torch.atan2(prod.imag, prod.real)
        z = (fm * np.float32(fs / (2.0 * np.pi * NFM_DEVIATION_HZ))) \
            .to(torch.complex64)
    elif mode in ("USB", "LSB"):
        z = bb
    elif mode == "CW":
        z = bb * lo(snap(CW_BFO_HZ, fs), start, n, 1.0, dev)
    else:
        raise ValueError(f"no reference for mode {mode!r}")
    y = fir(z, taps, ar)
    mono = y.real
    zero = torch.zeros(R, device=dev)
    # squelch: in-band and total power envelopes, hysteresis latch
    a_sq = np.float32(SQUELCH_ALPHA)
    a1 = float(np.float32(1.0) - a_sq)
    env_in = one_pole_scan(a1, (y.abs() ** 2) * a_sq, zero, ar)
    env_tot = one_pole_scan(a1, (z.abs() ** 2) * a_sq, zero, ar)
    sq_lin = 0.0 if squelch_db <= -149 else 10 ** (squelch_db / 10)
    settled = torch.ones(R, dtype=torch.bool, device=dev)
    if sq_lin > 0:
        thr = torch.tensor(np.float32(sq_lin), device=dev)
        ratio = env_in / torch.clamp(env_tot - env_in, min=1e-9)
        gate, last = latch(ratio > thr, ratio < SQUELCH_HYST * thr)
        if check_from > 0:
            settled = last[:, check_from - 1] >= 0
    else:
        gate = torch.ones_like(mono)
    # click smoother on the gate, DC blocker on the audio
    a_click = np.float32(min(1.0, 1000.0 / fs))
    g = one_pole_scan(float(np.float32(1.0) - a_click),
                      gate * float(a_click), torch.ones(R, device=dev), ar)
    left = mono
    if mode in DC_MODES:
        d = left - F.pad(left, (1, 0))[:, :-1]
        left = one_pole_scan(float(np.float32(DC_POLE)), d, zero, ar)
    audio = left * g
    # AGC: 64-sample windows from each block's start, the window maxima
    # smoothed at the window rate, instant attack inside a window
    nb = n // out_block
    nw = -(-out_block // AGC_WINDOW)
    mag = audio.abs().reshape(R, nb, out_block)
    wmax = F.pad(mag, (0, nw * AGC_WINDOW - out_block)) \
        .reshape(R, nb, nw, AGC_WINDOW).amax(-1).reshape(R, nb * nw)
    a_w = np.float32(1.0 - (1.0 - AGC_DECAY) ** AGC_WINDOW)
    env = one_pole_scan(float(np.float32(1.0) - a_w), wmax * float(a_w),
                        zero, ar)
    env = torch.maximum(env, wmax).reshape(R, nb, nw)
    env = env.repeat_interleave(AGC_WINDOW, -1)[..., :out_block] \
        .reshape(R, n)
    gain = torch.clamp(AGC_REF / torch.clamp(env, min=AGC_FLOOR),
                       max=AGC_MAX_GAIN)
    return torch.complex(audio * gain, torch.zeros_like(audio)), settled


# ------------------------------------------------------------ the chains

def chain_of(spec: dict, fc_hz: float, block: int):
    """The reference chain of a configuration's `reference` entry, for a
    capture centered at fc_hz and the traffic's `--block`: the kind's
    module chains/<kind>.py builds it. A chain has `fs_in`, `fs_out`,
    `in_block`, `out_block` (the program's block sizes, which the
    harness holds it to), `audio(x, block0, arith, check_from)` and
    `launches(wire)`, one step's hand-kernel launches for the
    rooflines.

    A chain may also have a tap, for the App's own per-block output other
    than the audio, such as a decoder's text (harness.py's docstring
    gives the whole contract; without these the chain runs as above):
    `attach(app)`, called before the step is captured, returns a
    `harness.Tap` that records that output by delivered block, warm-up
    included, and whose `counters()` the harness reads at the window's
    ends into `Run.tap_counters`; `output(x, arith)`, the reference's
    output of every block of x, the RF wire from the stream's start
    (block 0), so that state kept across blocks is the reference's own
    from the start; `settle_blocks`, the first block compared (default
    0); and `output_measures(prog, ref)`, the chain's own compared
    numbers, which a checks file names with their limits beside the
    audio's and which control.py reads with `output` under TF32 in the
    program's place."""
    return registry.module("chains", spec["kind"]).build(spec, fc_hz, block)
