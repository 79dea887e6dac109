"""AM: a carrier modulated 80 % by the station's tones."""

import torch

from sdrbench.scene import tones

AUDIO_HZ = (200.0, 3000.0)


def baseband(s, n, fs, gen, dev):
    a, _, arg = tones(s, n, fs, dev)
    env = 1.0 + 0.8 * (a[:, None] * torch.sin(arg)).sum(0)
    return torch.complex(env, torch.zeros_like(env))
