"""CW: a carrier s["cw_offset_hz"] off the dial, keyed on and off in
seeded units of 60 ms (20 words a minute) with raised 5 ms edges."""

import torch

from sdrbench.scene import carrier

AUDIO_HZ = (200.0, 3000.0)
UNIT_S = 0.06
EDGE_S = 0.005


def baseband(s, n, fs, gen, dev):
    unit = int(round(UNIT_S * fs))
    keys = torch.randint(0, 2, (n // unit + 2,), generator=gen,
                         device=dev).to(torch.float64)
    key = keys.repeat_interleave(unit)[:n]
    # raised edges: a moving average over EDGE_S
    w = int(round(EDGE_S * fs))
    c = torch.cumsum(torch.cat([key.new_zeros(w), key]), 0)
    key = (c[w:] - c[:-w]) / w
    return torch.complex(key, torch.zeros_like(key)) * carrier(
        0, n, s["cw_offset_hz"], fs, dev)
