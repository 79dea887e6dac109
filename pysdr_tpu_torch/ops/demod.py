"""Demodulator bank: AM, AM-synch, USB/LSB, CW, NFM, WFM, WFM stereo, IQ,
RTTY (counterpart of pysdr_tpu/ops/demod.py).

Batched over a leading channel axis (the reference vmaps one channel).
Every mode's frontend is computed and blended by a per-channel mode id, so
a mode change is data. The recurrences run as two fused column scans
(ops/scanops, the CUDA kernels on the card): pass A holds the L/R
de-emphasis one-poles and the two squelch power envelopes, pass B the
gate click smoother and the DC blocker. The audio-rate FIRs are
overlap-save FFTs (ops/fftfilt).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from pysdr_tpu_torch import tables
from pysdr_tpu_torch.ops import agc as agc_ops
from pysdr_tpu_torch.ops import fftfilt, fir, nco, resample, scanops
from pysdr_tpu_torch.tables import Mode

C64 = torch.complex64
F32 = torch.float32


@dataclasses.dataclass
class DemodState:
    """Per-channel streaming state; every field has a leading channel axis."""
    af_hist: torch.Tensor       # complex64 (B, Ta-1) AF filter history
    carrier_hist: torch.Tensor  # complex64 (B, Tc-1) AM-synch carrier filter
    pilot_hist: torch.Tensor    # complex64 (B, Tp-1) WFM stereo pilot filter
    lr_hist: torch.Tensor       # complex64 (B, Ta-1) WFM stereo L-R filter
    disc_last: torch.Tensor     # complex64 (B, 1) FM discriminator boundary
    bfo_phase: torch.Tensor     # int64 (B,) CW BFO NCO phase
    deemph: torch.Tensor        # float32 (B, 2) L/R de-emphasis state
    dc: torch.Tensor            # float32 (B, 2) DC blocker (x_prev, y_prev)
    agc_env: torch.Tensor       # float32 (B,) AGC envelope
    sq_gate: torch.Tensor       # float32 (B,) squelch latch (0/1)
    sq_env: torch.Tensor        # float32 (B, 3) in-band env, out-of-band
                                #   env, smoothed gate
    mute_hold: torch.Tensor     # float32 (B,) auto-mute hold samples left


@dataclasses.dataclass
class DemodParams:
    """Per-channel parameters; every field has a leading channel axis."""
    mode: torch.Tensor          # int64 (B,) tables.Mode value
    af_taps: torch.Tensor       # complex64 (B, Ta) AF filter row
    bfo_k: torch.Tensor         # int64 (B,) CW beat NCO numerator @ fs_out
    fm_scale: torch.Tensor      # float32 (B,) discriminator scaling
    squelch_lin: torch.Tensor   # float32 (B,) linear threshold (0 = off)
    af_gain: torch.Tensor       # float32 (B,)
    agc_on: torch.Tensor        # bool (B,)
    mute_gain: torch.Tensor     # float32 (B,) 0.0 = muted, else 1.0
    auto_mute_on: torch.Tensor  # bool (B,)
    auto_mute_lin: torch.Tensor  # float32 (B,) baseband power threshold

    @classmethod
    def stack(cls, rows: list["DemodParams"]) -> "DemodParams":
        return cls(**{f.name: torch.stack([getattr(r, f.name)
                                           for r in rows])
                      for f in dataclasses.fields(cls)})


@dataclasses.dataclass(frozen=True)
class DemodDesign:
    """Static demod configuration shared by all channels."""
    fs_out: float
    af_taps: int = 256
    carrier_taps: int = 256
    carrier_bw_hz: float = 100.0
    pilot_taps: int = 256
    agc: agc_ops.AGCParams = agc_ops.AGCParams()
    deemphasis_s: float = tables.WFM_DEEMPHASIS_S
    dc_pole: float = 0.9985
    squelch_alpha: float = 0.001
    squelch_hyst: float = 0.5
    mute_hold_s: float = 0.25
    # the audio-rate FIRs as overlap-save FFTs; False: the direct form
    fft_af: bool = True

    def carrier_filter(self) -> np.ndarray:
        """Narrow one-sided LP around DC for carrier recovery."""
        return fir.complex_bandpass(-self.carrier_bw_hz, self.carrier_bw_hz,
                                    self.fs_out, self.carrier_taps)

    def pilot_filter(self) -> np.ndarray:
        """One-sided bandpass at +19 kHz (WFM stereo pilot); all zeros
        when fs_out cannot hold it."""
        f0 = tables.WFM_PILOT_HZ
        if self.fs_out / 2 <= f0 + 1e3:
            return np.zeros(self.pilot_taps, np.complex64)
        return fir.complex_bandpass(f0 - 500.0, f0 + 500.0, self.fs_out,
                                    self.pilot_taps)

    def deemph_alpha(self) -> float:
        return float(1.0 - np.exp(-1.0 / (self.fs_out * self.deemphasis_s)))


def init_state(design: DemodDesign, n_ch: int,
               device: torch.device | str = "cpu") -> DemodState:
    def z(*shape, dtype=F32):
        return torch.zeros((n_ch, *shape), dtype=dtype, device=device)
    sq_env = z(3)
    sq_env[:, 2] = 1.0
    return DemodState(
        af_hist=z(design.af_taps - 1, dtype=C64),
        carrier_hist=z(design.carrier_taps - 1, dtype=C64),
        pilot_hist=z(design.pilot_taps - 1, dtype=C64),
        lr_hist=z(design.af_taps - 1, dtype=C64),
        disc_last=z(1, dtype=C64),
        bfo_phase=z(dtype=torch.int64),
        deemph=z(2), dc=z(2), agc_env=z(),
        sq_gate=torch.ones(n_ch, dtype=F32, device=device),
        sq_env=sq_env, mute_hold=z())


def make_params(design: DemodDesign, mode: Mode, af_bw_hz: float = 0.0,
                bfo_hz: float = tables.CW_BFO_HZ, af_gain: float = 1.0,
                squelch_db: float = -150.0, agc_on: bool = True,
                deviation_hz: float | None = None, muted: bool = False,
                auto_mute: bool = False,
                auto_mute_db: float = -10.0) -> DemodParams:
    """Host construction of one channel's parameters (0-d CPU tensors,
    af_taps (Ta,)); DemodParams.stack batches channels."""
    fs = design.fs_out
    if af_bw_hz <= 0:
        af_bw_hz = tables.MODE_DEFAULT_AF_BW.get(mode, 0.0) or 0.45 * fs
    af_bw_hz = min(af_bw_hz, 0.45 * fs)
    if mode == Mode.CW:
        taps = fir.complex_bandpass(bfo_hz - af_bw_hz / 2,
                                    bfo_hz + af_bw_hz / 2, fs,
                                    design.af_taps)
    elif mode == Mode.USB:
        taps = fir.complex_bandpass(50.0, af_bw_hz, fs, design.af_taps)
    elif mode == Mode.LSB:
        taps = fir.complex_bandpass(-af_bw_hz, -50.0, fs, design.af_taps)
    else:
        taps = fir.lowpass(design.af_taps, af_bw_hz, fs).astype(np.complex64)
    if deviation_hz is None:
        deviation_hz = (tables.WFM_DEVIATION_HZ
                        if mode in (Mode.WFM, Mode.WFM2)
                        else tables.NFM_DEVIATION_HZ)
    fm_scale = fs / (2.0 * np.pi * deviation_hz)
    # in-band/out-of-band power-envelope ratio: 10 dB per decade
    squelch_lin = 0.0 if squelch_db <= -149 else 10 ** (squelch_db / 10)

    def f32(v):
        return torch.tensor(np.float32(v))
    return DemodParams(
        mode=torch.tensor(int(mode), dtype=torch.int64),
        af_taps=torch.from_numpy(np.asarray(taps, np.complex64).copy()),
        bfo_k=torch.tensor(nco.snap_freq(bfo_hz, fs), dtype=torch.int64),
        fm_scale=f32(fm_scale), squelch_lin=f32(squelch_lin),
        af_gain=f32(af_gain), agc_on=torch.tensor(bool(agc_on)),
        mute_gain=f32(0.0 if muted else 1.0),
        auto_mute_on=torch.tensor(bool(auto_mute)),
        auto_mute_lin=f32(10 ** (auto_mute_db / 10)))


@functools.lru_cache(maxsize=None)
def scan_constants(design: DemodDesign, device: torch.device):
    """The fused scan passes' constants, made on `device` once per design:
    pass A's per-column one-pole alphas (4,), the click smoother's alpha
    (a python float), pass B's per-column poles (2,). Built from host
    values at every step they would be a blocking host-to-device copy."""
    alpha_de = np.float32(design.deemph_alpha())
    alpha_sq = np.float32(design.squelch_alpha)
    alpha_click = np.float32(min(1.0, 1000.0 / design.fs_out))
    alphas_a = torch.tensor([alpha_de, alpha_de, alpha_sq, alpha_sq],
                            dtype=F32, device=device)
    a_b = torch.tensor([np.float32(1.0) - alpha_click, design.dc_pole],
                       dtype=F32, device=device)
    return alphas_a, float(alpha_click), a_b


def _af_fir(x, hist, taps_c, design: DemodDesign):
    if not design.fft_af:
        return resample.fir_block_cmpx(x, hist, taps_c)
    return fftfilt.fft_fir_block(x, hist, taps_c)


def _discriminate(iq: torch.Tensor, last1: torch.Tensor):
    """fm[n] = angle(x[n] * conj(x[n-1])) in rad/sample.
    Returns (fm float32 (B, n), new_last1 (B, 1))."""
    ext = torch.cat([last1, iq], dim=-1)
    prod = ext[..., 1:] * torch.conj(ext[..., :-1])
    return torch.atan2(prod.imag, prod.real), ext[..., -1:]


def demod_block(iq: torch.Tensor, state: DemodState, p: DemodParams,
                design: DemodDesign, carrier_taps: torch.Tensor,
                pilot_taps: torch.Tensor):
    """Demodulate one audio-rate block for every channel.

    iq complex64 (B, n) baseband at fs_out; carrier_taps / pilot_taps
    complex64 (T,) shared by the bank. Returns (audio complex64 (B, n),
    new_state)."""
    n = iq.shape[-1]
    mode = p.mode[:, None]
    fm_scale = p.fm_scale[:, None]

    # --- frontends (all computed; elementwise + 2 small FIRs) ---
    env = torch.abs(iq)                                      # AM
    carrier, carrier_hist = _af_fir(iq, state.carrier_hist, carrier_taps,
                                    design)                  # AM-synch
    unit = carrier / (torch.abs(carrier) + 1e-9)
    z_ams = (iq * torch.conj(unit)).real
    bfo = nco.tone(p.bfo_k, state.bfo_phase, n)              # CW beat
    bfo_phase = nco.advance(p.bfo_k, state.bfo_phase, n)
    z_cw = iq * bfo
    fm, disc_last = _discriminate(iq, state.disc_last)       # NFM/WFM
    z_fm = fm * fm_scale

    # WFM stereo: pilot-locked 38 kHz subcarrier; sin(2*pilot phase) is
    # -Im(punit^2) for the analytic pilot e^{j(phi - pi/2)}
    pilot, pilot_hist = _af_fir(fm.to(C64), state.pilot_hist, pilot_taps,
                                design)
    punit = pilot / (torch.abs(pilot) + 1e-9)
    c38 = -(punit * punit).imag
    lr_raw = (2.0 * fm * c38 * fm_scale).to(C64)
    lr_f, lr_hist = _af_fir(lr_raw, state.lr_hist, p.af_taps, design)
    lr = lr_f.real

    is_fm_wide = (mode == Mode.WFM) | (mode == Mode.WFM2)
    is_ssb = (mode == Mode.USB) | (mode == Mode.LSB)
    is_iq = (mode == Mode.IQ) | (mode == Mode.RTTY)
    is_wfm2 = mode == Mode.WFM2

    z = torch.where(mode == Mode.AM, env.to(C64),
        torch.where(mode == Mode.AM_SYNC, z_ams.to(C64),
        torch.where(is_ssb | is_iq, iq,
        torch.where(mode == Mode.CW, z_cw, z_fm.to(C64)))))

    # --- shared AF filter (complex taps row selects USB/LSB/lowpass) ---
    y, af_hist = _af_fir(z, state.af_hist, p.af_taps, design)
    y = torch.where(is_iq, z, y)       # IQ passthrough keeps raw baseband
    mono = y.real

    # --- fused recurrences, pass A (4 columns): de-emphasis L/R and the
    # in-band / total squelch power envelopes
    alphasA, alpha_click, aB = scan_constants(design, iq.device)
    left_in = torch.where(is_wfm2, mono + lr, mono)
    right_in = torch.where(is_wfm2, mono - lr, mono)
    colsA = torch.stack([left_in, right_in, torch.abs(y) ** 2,
                         torch.abs(z) ** 2], dim=-1)
    prevA = torch.cat([state.deemph, state.sq_env[:, :2]], dim=-1)
    scanA, lastA = scanops.one_pole(colsA, alphasA, prevA)
    left = torch.where(is_fm_wide, scanA[..., 0], left_in)
    right = torch.where(is_fm_wide, scanA[..., 1], right_in)
    deemph = torch.where(is_fm_wide, lastA[:, :2], state.deemph)
    env_in, env_tot = scanA[..., 2], scanA[..., 3]

    # --- squelch hysteresis gate: open above T, close below hyst*T ---
    sq_lin = p.squelch_lin[:, None]
    ratio = env_in / torch.clamp(env_tot - env_in, min=1e-9)
    gate, gate_last = scanops.sr_latch(ratio > sq_lin,
                                       ratio < design.squelch_hyst * sq_lin,
                                       state.sq_gate)
    sq_off = p.squelch_lin <= 0.0
    gate = torch.where(sq_off[:, None], 1.0, gate)
    gate_last = torch.where(sq_off, 1.0, gate_last)

    # --- fused recurrences, pass B (2 columns): ~1 ms gate click
    # smoothing + the DC blocker y[n] = x[n]-x[n-1] + r*y[n-1]
    lm1 = torch.cat([state.dc[:, :1], left[:, :-1]], dim=-1)
    colsB_a = aB.expand(*left.shape, 2)
    colsB_b = torch.stack([gate * alpha_click, left - lm1], dim=-1)
    prevB = torch.stack([state.sq_env[:, 2], state.dc[:, 1]], dim=-1)
    scanB, lastB = scanops.linrec(colsB_a, colsB_b, prevB)
    g_sm, l_dc = scanB[..., 0], scanB[..., 1]
    dc_on = ((mode == Mode.AM) | (mode == Mode.AM_SYNC) | is_ssb
             | (mode == Mode.CW))
    dc = torch.where(dc_on, torch.stack([left[:, -1], lastB[:, 1]], dim=-1),
                     state.dc)
    left = torch.where(dc_on, l_dc, left)

    audio = torch.complex(left, torch.where(
        is_wfm2, right, torch.where(is_iq, y.imag, 0.0))) * g_sm
    sq_env = torch.stack([lastA[:, 2], lastA[:, 3], lastB[:, 0]], dim=-1)

    # --- AGC + gain ---
    audio, agc_env, _ = agc_ops.agc_block(
        audio, state.agc_env, design.agc, enabled=p.agc_on & ~is_iq[:, 0])
    audio = audio * p.af_gain[:, None]

    # --- per-RX mute + strong-signal auto-mute with a hold counter ---
    bb_pwr = torch.mean(torch.abs(iq) ** 2, dim=-1)
    strong = p.auto_mute_on & (bb_pwr > p.auto_mute_lin)
    hold = torch.where(strong, float(design.mute_hold_s * design.fs_out),
                       torch.clamp(state.mute_hold - n, min=0.0))
    auto_muted = p.auto_mute_on & (strong | (state.mute_hold > 0.0))
    audio = audio * (p.mute_gain * torch.where(auto_muted, 0.0, 1.0))[:, None]

    new_state = DemodState(
        af_hist=af_hist, carrier_hist=carrier_hist, pilot_hist=pilot_hist,
        lr_hist=lr_hist, disc_last=disc_last, bfo_phase=bfo_phase,
        deemph=deemph, dc=dc, agc_env=agc_env, sq_gate=gate_last,
        sq_env=sq_env, mute_hold=hold)
    return audio, new_state
