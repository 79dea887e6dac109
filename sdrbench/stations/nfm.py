"""NFM: the tones as frequency deviation, PEAK_DEV_HZ at full scale."""

import torch

from sdrbench.scene import tones

AUDIO_HZ = (200.0, 3000.0)
PEAK_DEV_HZ = 3e3


def baseband(s, n, fs, gen, dev):
    a, f, arg = tones(s, n, fs, dev)
    # the phase is the integral of the instantaneous frequency
    ph = (-(a * PEAK_DEV_HZ / f)[:, None] * torch.cos(arg)).sum(0)
    return torch.polar(torch.ones_like(ph), ph)
