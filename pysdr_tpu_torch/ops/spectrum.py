"""PSD / waterfall engine on the device (counterpart of
pysdr_tpu/ops/spectrum.py).

Welch periodogram with windowing and 50% overlap, the waterfall as a
rolling (rows, nfft) tensor, median background, peak picking, dynamic-
range clamp and uint8 quantization. Plain torch (`torch.fft`, a stable
sort for the top-k); only the final uint8 image and float rows cross to
the host. `waterfall_push_` and `waterfall_shift_` write into the
waterfall they are given, so it keeps its address: the display's CUDA
graph reads and writes that tensor at every replay
(models/display.ThreeBox). The functional forms stay for comparisons.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class SpectrumDesign:
    fs: float
    nfft: int = 1024
    overlap: float = 0.5
    window: str = "hann"

    @property
    def hop(self) -> int:
        return max(1, int(self.nfft * (1.0 - self.overlap)))

    def freqs_hz(self, fc: float = 0.0) -> np.ndarray:
        return np.fft.fftshift(np.fft.fftfreq(self.nfft, 1.0 / self.fs)) + fc

    def window_array(self) -> np.ndarray:
        n = self.nfft
        if self.window == "hann":
            w = np.hanning(n)
        elif self.window == "kaiser":
            w = np.kaiser(n, 8.6)
        else:
            w = np.ones(n)
        return (w / np.sqrt(np.mean(w ** 2))).astype(np.float32)


def periodogram(x: torch.Tensor, window: torch.Tensor, *, nfft: int,
                hop: int) -> torch.Tensor:
    """Welch-style PSD of one block, averaged over its segments,
    fftshifted, in dB: x complex64 (n,), window float32 (nfft,) on x's
    device. Returns (nfft,) float32. A block shorter than nfft is
    zero-padded to one segment."""
    n = x.shape[0]
    if n < nfft:
        x = torch.cat([x, x.new_zeros(nfft - n)])
    spec = torch.fft.fft(x.unfold(0, nfft, hop) * window, dim=-1)
    p = ((spec.real ** 2 + spec.imag ** 2) / nfft).mean(dim=0)
    p = torch.fft.fftshift(p, dim=-1)
    return 10.0 * torch.log10(torch.clamp(p, min=1e-20))


def waterfall_push(wf: torch.Tensor, row: torch.Tensor) -> torch.Tensor:
    """Roll the waterfall and insert the newest PSD row at index 0."""
    return torch.cat([row[None, :], wf[:-1]], dim=0)


def waterfall_push_(wf: torch.Tensor, row: torch.Tensor) -> torch.Tensor:
    """waterfall_push written into wf itself. Returns wf."""
    return wf.copy_(waterfall_push(wf, row))


def waterfall_shift(wf: torch.Tensor, bins: int) -> torch.Tensor:
    """Frequency-shift realignment on retune (bins > 0 shifts right)."""
    return torch.roll(wf, int(bins), dims=1)


def waterfall_shift_(wf: torch.Tensor, bins: int) -> torch.Tensor:
    """waterfall_shift written into wf itself. Returns wf."""
    return wf.copy_(waterfall_shift(wf, bins))


def background_median(psd_row: torch.Tensor) -> torch.Tensor:
    """Median background estimate (the mean of the two middle values for
    an even length, like numpy and jnp.median)."""
    return torch.quantile(psd_row, 0.5)


def find_peaks(psd_row: torch.Tensor, height_db, *, max_peaks: int = 32,
               min_dist: int = 8):
    """Local maxima at least height_db high and min_dist bins apart.
    Returns (indices int32 (max_peaks,) -1 padded, values float32
    (max_peaks,) -inf padded), sorted by height, descending; equal
    heights keep the lower index first."""
    pad = psd_row.new_full((min_dist,), -torch.inf)
    windows = torch.cat([pad, psd_row, pad]).unfold(0, 2 * min_dist + 1, 1)
    # strict-left / loose-right: exactly one flag per equal-valued plateau
    left_max = windows[:, :min_dist].amax(dim=1)
    right_max = windows[:, min_dist + 1:].amax(dim=1)
    is_max = (psd_row > left_max) & (psd_row >= right_max)
    ok = is_max & (psd_row >= height_db)
    score = torch.where(ok, psd_row, -torch.inf)
    vals, idx = torch.sort(score, descending=True, stable=True)
    vals, idx = vals[:max_peaks], idx[:max_peaks]
    idx = torch.where(torch.isfinite(vals), idx, -1)
    return idx.to(torch.int32), vals


def clamp_dynamic_range(wf: torch.Tensor, dr_db) -> torch.Tensor:
    """Dynamic-range clamp max(zz, zmax - PAN_DR)."""
    return torch.maximum(wf, wf.max() - dr_db)


def to_image_u8(wf: torch.Tensor, dr_db=60.0) -> torch.Tensor:
    """Quantize a waterfall to uint8 rows for the host viewer."""
    zmax = wf.max()
    z = torch.clamp((wf - (zmax - dr_db)) / dr_db, 0.0, 1.0)
    return (z * 255.0).to(torch.uint8)
