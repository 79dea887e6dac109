"""FIR filter design (host-side, numpy) and filter-bank construction.

The reference designs its filters in scipy inside the external `sig_proc` lib
and hot-swaps them from pre-built banks on bandwidth changes
(`dec.filter_bank`, `demod.filter_bank_real/_cmpx` — reference
gui.py:1672-1765, receiver.py:864-874). We keep that design: banks are built
once on the host as stacked float32 arrays; a bandwidth change selects a bank
row (a traced index — no recompile). Filters are Kaiser windowed-sinc, which
matches scipy.signal.firwin(..., window=('kaiser', beta)) to float tolerance.

The port's own copy of pysdr_tpu/ops/fir.py, with its imports rewritten to
pysdr_tpu_torch: the port imports nothing of the JAX package.
"""

from __future__ import annotations

import numpy as np


def kaiser_beta(atten_db: float) -> float:
    """Kaiser beta for a given stopband attenuation (Kaiser's formula)."""
    if atten_db > 50:
        return 0.1102 * (atten_db - 8.7)
    if atten_db >= 21:
        return 0.5842 * (atten_db - 21) ** 0.4 + 0.07886 * (atten_db - 21)
    return 0.0


def lowpass(ntaps: int, cutoff_hz: float, fs: float, atten_db: float = 60.0,
            scale: float = 1.0) -> np.ndarray:
    """Linear-phase windowed-sinc lowpass, unity DC gain, float32 (ntaps,)."""
    assert 0 < cutoff_hz < fs / 2, (cutoff_hz, fs)
    beta = kaiser_beta(atten_db)
    m = np.arange(ntaps) - (ntaps - 1) / 2.0
    fc = cutoff_hz / fs
    h = 2 * fc * np.sinc(2 * fc * m) * np.kaiser(ntaps, beta)
    h /= h.sum()  # unity DC gain
    return (h * scale).astype(np.float32)


def bandpass(f1_hz: float, f2_hz: float, fs: float, ntaps: int,
             atten_db: float = 60.0) -> np.ndarray:
    """Real bandpass (difference of lowpasses) — reference `dsp.bpf`
    equivalent (receiver.py:861-862 aux 800-1300 Hz speaker path)."""
    beta = kaiser_beta(atten_db)
    m = np.arange(ntaps) - (ntaps - 1) / 2.0
    w = np.kaiser(ntaps, beta)
    h = (2 * (f2_hz / fs) * np.sinc(2 * f2_hz / fs * m)
         - 2 * (f1_hz / fs) * np.sinc(2 * f1_hz / fs * m)) * w
    # normalize to unity gain at band center
    fc = 0.5 * (f1_hz + f2_hz) / fs
    gain = np.abs(np.sum(h * np.exp(-2j * np.pi * fc * np.arange(ntaps))))
    return (h / gain).astype(np.float32)


def complex_bandpass(f1_hz: float, f2_hz: float, fs: float, ntaps: int,
                     atten_db: float = 60.0) -> np.ndarray:
    """One-sided complex bandpass: lowpass shifted to [f1, f2] (f1<f2, either
    sign). This is the SSB/CW channel filter — the reference's
    `filter_bank_cmpx` one-sided filters (receiver.py:873-874): for USB pass
    [+fl, +fh], for LSB pass [-fh, -fl]; the negative sideband is rejected.
    Returns complex64 (ntaps,)."""
    bw = f2_hz - f1_hz
    assert bw > 0
    lp = lowpass(ntaps, bw / 2.0, fs, atten_db).astype(np.float64)
    fc = 0.5 * (f1_hz + f2_hz) / fs
    n = np.arange(ntaps)
    return (lp * np.exp(2j * np.pi * fc * n)).astype(np.complex64)


def _resampler_prototype(up: int, down: int, fs_in: float, cutoff_hz: float,
                         taps_per_phase: int, atten_db: float = 60.0):
    """Anti-alias lowpass for a rational up/down resampler, operating at the
    upsampled rate fs_in*up, with gain `up` to compensate zero-stuffing.
    Length is padded to up*taps_per_phase."""
    ntaps = up * taps_per_phase
    fs_up = fs_in * up
    # Reject BOTH alias products beyond the output Nyquist AND the
    # zero-stuffing images beyond the input Nyquist (the latter bites
    # whenever up > down, e.g. a 32 kHz channel upsampled to 48 kHz:
    # without the fs_in/2 cap, input images at 16-22 kHz pass into the
    # audio band unattenuated)
    nyq = min(fs_in * up / (2.0 * down), fs_in / 2.0)
    fc = min(cutoff_hz, 0.92 * nyq) if cutoff_hz > 0 else 0.92 * nyq
    h = lowpass(ntaps, fc, fs_up, atten_db, scale=float(up))
    return h


def video_filter_bank(fs_in: float, up: int, down: int, video_bws_hz,
                      taps_per_phase: int = 0,
                      atten_db: float = 60.0) -> np.ndarray:
    """Stacked resampler filters, one per video bandwidth: (n_bw, up*Kp).

    Equivalent of the reference decimator's `filter_bank` keyed by the
    VIDEO_BWs menu (gui.py:1672-1714): entry i passes ±video_bw/2 (or the
    full output band for 'Max'==0.0) while rejecting resampling images.
    taps_per_phase=0 picks ~8*down/up taps per phase (≈ 8*down total at the
    input rate), a quality similar to scipy resample_poly's default.
    """
    if taps_per_phase == 0:
        taps_per_phase = max(16, int(np.ceil(8 * down / up)))
    bank = [
        _resampler_prototype(up, down, fs_in, bw / 2.0 if bw > 0 else 0.0,
                             taps_per_phase, atten_db)
        for bw in video_bws_hz
    ]
    return np.stack(bank).astype(np.float32)


def af_filter_bank_real(fs_out: float, af_bws_hz, ntaps: int = 256,
                        atten_db: float = 60.0) -> np.ndarray:
    """Real audio lowpass bank (n_bw, ntaps) for AM/FM audio — the
    reference `filter_bank_real` (receiver.py:873). 'Max' (0.0) entries are
    a near-Nyquist lowpass rather than a delta: a delta at (ntaps-1)//2
    has INTEGER group delay while every designed row has the symmetric
    (ntaps-1)/2 = half-sample-offset delay for even ntaps, so swapping
    to/from 'Max' mid-stream would shift the audio by half a sample —
    designing 'Max' like the other rows keeps all bank rows
    phase-interchangeable."""
    rows = []
    for bw in af_bws_hz:
        if bw <= 0 or bw >= fs_out / 2:
            h = lowpass(ntaps, 0.98 * fs_out / 2, fs_out, atten_db)
        else:
            h = lowpass(ntaps, bw, fs_out, atten_db)
        rows.append(h)
    return np.stack(rows).astype(np.float32)


def af_filter_bank_cmpx(fs_out: float, af_bws_hz, ntaps: int = 256,
                        atten_db: float = 60.0, f_low_hz: float = 150.0,
                        lsb: bool = False) -> np.ndarray:
    """Complex one-sided audio bank (n_bw, ntaps) for SSB/CW — the reference
    `filter_bank_cmpx` (receiver.py:874). Row i passes [f_low, bw] (USB) or
    [-bw, -f_low] (LSB)."""
    rows = []
    for bw in af_bws_hz:
        bw_eff = bw if 0 < bw < fs_out / 2 else 0.45 * fs_out
        f1, f2 = (-bw_eff, -f_low_hz) if lsb else (f_low_hz, bw_eff)
        rows.append(complex_bandpass(f1, f2, fs_out, ntaps, atten_db))
    return np.stack(rows).astype(np.complex64)


def freq_response(h: np.ndarray, fs: float, nfft: int = 4096):
    """(freqs_hz, |H| dB) — for tests and the internals-dump verification
    harness (reference sigs/internals.m:14-60)."""
    H = np.fft.fftshift(np.fft.fft(h, nfft))
    f = np.fft.fftshift(np.fft.fftfreq(nfft, 1.0 / fs))
    mag = 20 * np.log10(np.maximum(np.abs(H), 1e-12))
    return f, mag
