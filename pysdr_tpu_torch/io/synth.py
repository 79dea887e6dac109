"""Synthetic IQ signal sources — the hardware-free "fake device".

Equivalent of the reference's `-fake` RTL_SDR_DRIVER (reference
utils.py:71-273) which synthesizes a Soapy-shaped stream for hardware-free
runs and CI (README.md:298-300). Here signals are generated directly as
modulated complex baseband: the test corpus generator for the record/replay
oracle (SURVEY.md §4) and the load generator for bench.py.

The port's own copy of pysdr_tpu/io/synth.py, with its imports rewritten to
pysdr_tpu_torch: the port imports nothing of the JAX package.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class SignalSpec:
    """One emitter inside the passband."""
    offset_hz: float            # frequency offset from SDR center
    mode: str = "am"            # am | fm | usb | lsb | cw | tone | noise
    amplitude: float = 1.0
    audio_hz: float = 1000.0    # modulating tone
    deviation_hz: float = 5e3   # fm deviation
    mod_index: float = 0.5      # am depth


def render(specs, fs: float, n: int, noise_rms: float = 0.0,
           seed: int = 0, t0: float = 0.0) -> np.ndarray:
    """Render a block of complex64 IQ containing all emitters. `t0` lets
    successive blocks be phase-continuous (pass t0 = k*n/fs)."""
    rng = np.random.default_rng(seed + int(t0 * 1e6) % (1 << 31))
    t = t0 + np.arange(n) / fs
    x = np.zeros(n, np.complex128)
    for s in specs:
        carrier = np.exp(2j * np.pi * s.offset_hz * t)
        if s.mode == "tone" or s.mode == "cw":
            base = 1.0
        elif s.mode == "am":
            base = 1.0 + s.mod_index * np.sin(2 * np.pi * s.audio_hz * t)
        elif s.mode == "fm":
            ph = s.deviation_hz / s.audio_hz * np.sin(
                2 * np.pi * s.audio_hz * t)
            base = np.exp(1j * ph)
        elif s.mode in ("usb", "lsb"):
            sign = 1.0 if s.mode == "usb" else -1.0
            base = np.exp(sign * 2j * np.pi * s.audio_hz * t)
        elif s.mode == "noise":
            base = (rng.standard_normal(n) + 1j * rng.standard_normal(n)) \
                / np.sqrt(2)
        else:
            raise ValueError(s.mode)
        x += s.amplitude * base * carrier
    if noise_rms > 0:
        x += noise_rms / np.sqrt(2) * (rng.standard_normal(n)
                                       + 1j * rng.standard_normal(n))
    return x.astype(np.complex64)


class SynthSource:
    """Block-pull source with the same read lifecycle as DatReader —
    phase-continuous across blocks.

    Also models the device-facing control surface the reference's fake
    RTL driver mimics (~25 Soapy methods, reference utils.py:122-273;
    applied by setupSDR, utils.py:292-353) with FUNCTIONAL effect where
    one exists without hardware: RF gain scales the stream, the PPM
    frequency correction shifts the received passband by -fc*ppm*1e-6
    (an uncorrected front-end shows signals low by exactly that), and
    the antenna selection is carried as state."""

    def __init__(self, specs, fs: float, noise_rms: float = 0.0,
                 seed: int = 0, fc: float = 0.0, rf_gain_db: float = 0.0,
                 ppm: float = 0.0, antenna: str = "RX"):
        self.specs, self.fs, self.noise_rms = tuple(specs), fs, noise_rms
        self.seed, self.fc = seed, fc
        self._fc0 = fc                # construction-time center: spec
        self.rf_gain_db = rf_gain_db  # offsets are relative to this
        self.ppm = ppm
        self.antenna = antenna
        self._n_read = 0

    @property
    def srate(self):
        return self.fs

    # -- Soapy-shaped setters (reference RTL_SDR_DRIVER surface) --

    def set_gain(self, db: float):
        self.rf_gain_db = float(db)

    def get_gain(self) -> float:
        return self.rf_gain_db

    def set_freq_correction(self, ppm: float):
        self.ppm = float(ppm)

    def get_freq_correction(self) -> float:
        return self.ppm

    def set_antenna(self, name: str):
        self.antenna = name

    def get_antenna(self) -> str:
        return self.antenna

    def set_freq(self, fc_hz: float):
        """Retune the simulated front-end (the reference fake driver's
        setFrequency, utils.py:122-273): the emitters stay at their
        absolute frequencies, so their offsets inside the passband shift
        by -(new_fc - old_fc)."""
        self.fc = float(fc_hz)

    def read_data(self, n: int, loop: bool = True):
        t0 = self._n_read / self.fs
        specs = self.specs
        if self.fc != self._fc0:
            shift = self._fc0 - self.fc
            specs = tuple(dataclasses.replace(
                s, offset_hz=s.offset_hz + shift) for s in specs)
        x = render(specs, self.fs, n, self.noise_rms, self.seed,
                   t0=t0)
        if self.ppm:
            df = -self.fc * self.ppm * 1e-6
            t = t0 + np.arange(n) / self.fs
            x = (x * np.exp(2j * np.pi * df * t)).astype(np.complex64)
        if self.rf_gain_db:
            x = (x * 10.0 ** (self.rf_gain_db / 20.0)).astype(np.complex64)
        self._n_read += n
        return x
