"""USB: the tones shifted up, one complex exponential each."""

import torch

from sdrbench.scene import tones

AUDIO_HZ = (300.0, 2700.0)


def baseband(s, n, fs, gen, dev):
    a, _, arg = tones(s, n, fs, dev)
    return (a[:, None] * torch.polar(torch.ones_like(arg), arg)).sum(0)
