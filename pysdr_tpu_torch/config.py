"""Run-time configuration.

Equivalent of the reference's `RUN_TIME_PARAMS` (reference params.py:38-534)
— but where the reference threads one giant mutable `P` object through every
layer and mutates it from GUI callbacks, here config is split into:

  * PipelineConfig / ReceiverConfig — frozen host-side dataclasses (pure
    data, picklable; the analogue of `copy_fields`, params.py:511-534);
  * the traced per-channel arrays built from them (NCO numerators, bank
    indices, gains) — see models/receiver.py — which can change every block
    without recompiling;
  * static compile keys (rates, block sizes, tap counts) that select the
    compiled executable.

Derived-rate logic mirrors params.py:399-472: rational UP/DOWN planning,
block sizing, FOFFSET auto-centering across receivers, and the FOFFSET snap
to an exact NCO bin (utils.py:277-289).

The port's own copy of pysdr_tpu/config.py, with its imports rewritten to
pysdr_tpu_torch: the port imports nothing of the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from pysdr_tpu_torch import rates, tables
from pysdr_tpu_torch.tables import Mode

# Default tuner offset: the reference parks the SDR center this far from the
# main RX so the DC spike / LO leakage sits outside the channel
# (params.py:311-315 auto-centering).
DEFAULT_FOFFSET_HZ = 0.0


@dataclasses.dataclass(frozen=True)
class ReceiverConfig:
    """One channel of the bank (reference: one of up to MAX_RX=6 RXs)."""
    fc_hz: float                     # RF center frequency of this channel
    mode: Mode = Mode.AM
    video_bw_hz: float = 0.0         # 0.0 = Max (menu tables.VIDEO_BWS_HZ)
    af_bw_hz: float = 0.0            # 0.0 = mode default
    af_gain: float = 1.0
    agc_enabled: bool = True
    squelch_db: float = -150.0       # effectively off
    bfo_hz: float = tables.CW_BFO_HZ # CW beat note
    muted: bool = False              # per-RX mute (reference P.MUTED[irx],
                                     # receiver.py:168-197)
    auto_mute: bool = False          # mute on strong sigs during TX/SO2V
                                     # (reference ENABLE_AUTO_MUTE,
                                     # receiver.py:237-245)
    auto_mute_db: float = -10.0      # baseband power threshold (dBFS)
    src: int = -1                    # RX chaining (reference -src,
                                     # receiver.py:825-835): when >= 0,
                                     # this RX's NCO offset derives from
                                     # RX[src]'s dial (fc_i - fc_src)
                                     # instead of the device center


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """Whole-pipeline static configuration."""
    fs_in: float = 2.048e6           # RF sample rate
    fs_out: float = 48e3             # audio rate (48/96/192k, params.py:130)
    out_block: int = 16384           # audio samples per block (>=1024; TPU
                                     # prefers large blocks; 1024 matches the
                                     # reference real-time chunk)
    foffset_hz: float = DEFAULT_FOFFSET_HZ
    transverter_hz: float = 0.0      # up/down-converter ahead of the SDR:
                                     # device tunes dial + this (reference
                                     # +125 MHz Ham-It-Up, gui.py:1940-1944)
    video_taps_per_phase: int = 0    # 0 = auto (~8*down/up)
    af_taps: int = 256
    receivers: tuple[ReceiverConfig, ...] = ()

    def __post_init__(self):
        if not self.receivers:
            object.__setattr__(self, "receivers",
                               (ReceiverConfig(fc_hz=self.fs_in / 4),))

    @property
    def n_rx(self) -> int:
        return len(self.receivers)

    @property
    def plan(self) -> rates.RatePlan:
        return rates.rate_plan(self.fs_in, self.fs_out, self.out_block)

    @property
    def sdr_center_hz(self) -> float:
        """Device tuner frequency: main RX center minus FOFFSET, shifted
        by the transverter offset (reference gui.py:1938-1944
        `setFrequency(f2-FOFFSET [+125 MHz])`). All in-passband math
        (NCO offsets) works on dial frequencies and is unaffected."""
        return (self.receivers[0].fc_hz - self.foffset_hz
                + self.transverter_hz)

    def channel_offsets_hz(self) -> list[float]:
        """Per-channel NCO offsets inside the passband:
        frq_i = FOFFSET + FC[i] - FC[0] (reference receiver.py:829-835)."""
        fc0 = self.receivers[0].fc_hz
        return [self.foffset_hz + r.fc_hz - fc0 for r in self.receivers]

    def sampling_mode(self, tuner_min_hz: float = 24e6) -> str:
        """Device sampling mode an RTL-class front-end would need at this
        center: 'direct' (Q-branch direct sampling) below the tuner's
        minimum, else 'quadrature' — the auto-switch the reference applies
        on retune (reference receiver.py:671-680). Pure source-layer
        modeling here (no live hardware on a TPU host); the replay/synth
        sources carry it as an attribute for parity with setupSDR."""
        return "direct" if self.sdr_center_hz < tuner_min_hz \
            else "quadrature"


def auto_foffset(fcs_hz: Sequence[float], fs_in: float,
                 min_offset_hz: float = 20e3) -> float:
    """Center the set of requested channels in the passband while keeping
    the main channel at least min_offset from DC (params.py:311-315)."""
    fc0 = fcs_hz[0]
    lo, hi = min(fcs_hz), max(fcs_hz)
    center = 0.5 * (lo + hi)
    # Device center lands at fc0 - foffset (sdr_center_hz) and channel i
    # sits at passband position foffset + fc_i - fc0, so centering the
    # span needs foffset = fc0 - center. (The reference's
    # FOFFSET = fo - max(fc) at params.py:311-315 is the same thing
    # under its ascending-FRQS launcher convention. The previous
    # `center - fc0` here was the MIRROR of the midpoint — harmless for
    # kHz-scale spans, but a 4 MHz FT8 multi-band layout pushed
    # channels outside the passband.)
    foff = fc0 - center
    if abs(foff) < min_offset_hz:
        foff = min_offset_hz if foff >= 0 else -min_offset_hz
    span = hi - lo
    assert span + 2 * min_offset_hz < fs_in, \
        f"channels span {span} Hz exceeds passband {fs_in}"
    return foff


def validate(cfg: PipelineConfig) -> None:
    """Sanity checks mirroring the reference's setup validation
    (utils.py:292-353 offset-within-tuner-BW check). A chained RX
    (src >= 0) is judged by its offset from its source RX's dial."""
    half = cfg.fs_in / 2
    for rc, off in zip(cfg.receivers, cfg.channel_offsets_hz()):
        if 0 <= rc.src < len(cfg.receivers):
            off = rc.fc_hz - cfg.receivers[rc.src].fc_hz
        assert abs(off) < half, f"channel offset {off} outside ±{half}"
    assert cfg.fs_out <= cfg.fs_in
