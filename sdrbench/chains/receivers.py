"""Reference chain `receivers`: N receivers in one passband (`--fc`
list, `--modes`), each an exact-phase LO mix to its dial, an upfirdn
polyphase resample to the audio rate and its mode's demod."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from sdrbench import roofline
from sdrbench.reference import (Arith, demod, lo, resample, resampler_taps,
                                snap, up_down)


@dataclasses.dataclass(frozen=True)
class Receivers:
    """Offsets from the passband's center, modes, rates, blocks."""
    fs_in: float
    offsets_hz: tuple
    modes: tuple
    fs_out: float
    block: int
    squelch_db: float = -150.0

    @property
    def rates(self):
        return up_down(self.fs_in, self.fs_out)

    @property
    def out_block(self) -> int:
        """`--block` rounded up to a whole number of resampler periods."""
        return -(-self.block // self.rates[0]) * self.rates[0]

    @property
    def in_block(self) -> int:
        up, down = self.rates
        return self.out_block // up * down

    def audio(self, x: torch.Tensor, block0: int, ar: Arith,
              check_from: int = 0):
        """x complex64 (n,) the RF from block `block0`'s first sample, a
        whole number of blocks. Returns (audio (R, n_out), settled): see
        reference.demod."""
        up, down = self.rates
        tpp = max(16, int(np.ceil(8 * down / up)))
        h = torch.from_numpy(resampler_taps(self.fs_in, up, down, tpp)) \
            .to(x.device)
        s0 = block0 * self.in_block
        outs, sett = [], []
        for off, mode in zip(self.offsets_hz, self.modes):
            z = x * lo(snap(off, self.fs_in), s0, x.shape[0], -1.0, x.device)
            bb = resample(z[None], h, up, down, ar)
            a, s = demod(bb, mode, self.fs_out, block0 * self.out_block,
                         self.out_block, self.squelch_db, ar, check_from)
            outs.append(a)
            sett.append(s)
        return torch.cat(outs), torch.cat(sett)

    def launches(self, wire: str) -> dict:
        return roofline.step_launches(len(self.modes), self.out_block)


def build(spec: dict, fc_hz: float, block: int) -> Receivers:
    """Receivers are given by their dials (`fc_mhz`), as on the command
    line."""
    kw = {k: v for k, v in spec.items() if k not in ("kind", "fc_mhz")}
    return Receivers(offsets_hz=tuple(f * 1e6 - fc_hz
                                      for f in spec["fc_mhz"]),
                     modes=tuple(kw.pop("modes")), block=block, **kw)
