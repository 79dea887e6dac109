"""Reference chain `channels` (`--channelize N`): N uniform channels over
fs_in, all in one mode: a critically sampled polyphase filterbank, the
DFT over its branches, an exact-phase fine mix, an upfirdn resample to
the audio rate and the mode's demod."""

from __future__ import annotations

import dataclasses

import torch

from sdrbench import roofline
from sdrbench.reference import (Arith, demod, filterbank, lo, lowpass,
                                resample, resampler_taps, snap, up_down)

PFB_ATTEN_DB = 70.0             # the filterbank's prototype
PFB_TAPS_PER_BRANCH = 12
CHANNEL_TAPS_PER_PHASE = 16     # channel rate -> audio rate


@dataclasses.dataclass(frozen=True)
class Channels:
    fs_in: float
    n_channels: int
    mode: str
    fs_out: float
    block: int
    squelch_db: float = -150.0
    fine_offset_hz: float = 0.0

    @property
    def fs_ch(self) -> float:
        return self.fs_in / self.n_channels

    @property
    def rates(self):
        return up_down(self.fs_ch, self.fs_out)

    @property
    def out_block(self) -> int:
        return -(-self.block // self.rates[0]) * self.rates[0]

    @property
    def in_block(self) -> int:
        up, down = self.rates
        return self.out_block // up * down * self.n_channels

    def audio(self, x: torch.Tensor, block0: int, ar: Arith,
              check_from: int = 0):
        n_ch = self.n_channels
        up, down = self.rates
        proto = torch.from_numpy(lowpass(
            n_ch * PFB_TAPS_PER_BRANCH, 0.5 * self.fs_ch, self.fs_in,
            PFB_ATTEN_DB)).to(x.device)
        s = filterbank(x, proto, n_ch, ar)                 # (N, M)
        m0 = block0 * self.in_block // n_ch
        s = s * lo(snap(self.fine_offset_hz, self.fs_ch), m0, s.shape[1],
                   -1.0, x.device)
        h = torch.from_numpy(resampler_taps(
            self.fs_ch, up, down, CHANNEL_TAPS_PER_PHASE)).to(x.device)
        bb = resample(s, h, up, down, ar)
        return demod(bb, self.mode, self.fs_out, block0 * self.out_block,
                     self.out_block, self.squelch_db, ar, check_from)

    def launches(self, wire: str) -> dict:
        return roofline.step_launches(
            self.n_channels, self.out_block,
            (self.in_block // self.n_channels, self.n_channels,
             PFB_TAPS_PER_BRANCH, wire))


def build(spec: dict, fc_hz: float, block: int) -> Channels:
    return Channels(block=block, **{k: v for k, v in spec.items()
                                    if k != "kind"})
