"""Headless three-box display: time pane + PSD + waterfall (counterpart of
pysdr_tpu/models/display.py).

The PSD, the rolling waterfall and the peak picking run on the bank's
device (ops/spectrum); the waterfall stays there as a (rows, nfft)
tensor, and only the uint8 image, the PSD row and the peak list cross to
the host. The host pieces (Spot, SpotList, the colormap LUTs, render_rgb
and the PNG writer) are copies of the reference's: its module imports jax.
"""

from __future__ import annotations

import dataclasses
import struct
import zlib
from typing import NamedTuple

import numpy as np
import torch

from pysdr_tpu_torch.device import resolve_device
from pysdr_tpu_torch.ops import spectrum


# --------------------------------------------------------------------------
# Spots (bandmap overlay)
# --------------------------------------------------------------------------

@dataclasses.dataclass
class Spot:
    """One bandmap spot."""
    freq_hz: float
    label: str
    color: str = "yellow"
    mode: str = ""


class SpotList:
    """Host-side spot overlay: add/remove/recolor/snap."""

    def __init__(self):
        self._spots: list[Spot] = []

    def add(self, freq_hz: float, label: str, color: str = "yellow",
            mode: str = "") -> Spot:
        s = Spot(freq_hz, label, color, mode)
        self._spots.append(s)
        return s

    def remove_all(self):
        self._spots.clear()

    def replace_all(self, spots):
        self._spots = list(spots)

    def recolor(self, label: str, color: str) -> int:
        """Recolor every spot with this label; returns how many."""
        n = 0
        for s in self._spots:
            if s.label == label:
                s.color = color
                n += 1
        return n

    def snap(self, freq_hz: float, max_dist_hz: float) -> Spot | None:
        """Nearest spot within max_dist_hz, or None (click-to-tune)."""
        best, bd = None, max_dist_hz
        for s in self._spots:
            d = abs(s.freq_hz - freq_hz)
            if d <= bd:
                best, bd = s, d
        return best

    def in_span(self, f_lo: float, f_hi: float) -> list[Spot]:
        return [s for s in self._spots if f_lo <= s.freq_hz <= f_hi]

    def __len__(self):
        return len(self._spots)

    def __iter__(self):
        return iter(self._spots)


# --------------------------------------------------------------------------
# Three-box pipeline
# --------------------------------------------------------------------------

class DisplayFrame(NamedTuple):
    """One display tick's host-side products."""
    time_y: np.ndarray        # (time_pts,) float32 |x| envelope samples
    freqs_hz: np.ndarray      # (nbins,) displayed frequency axis
    psd_db: np.ndarray        # (nbins,) newest PSD row (dB)
    waterfall_u8: np.ndarray  # (rows, nbins) uint8
    peak_freqs_hz: np.ndarray  # (k,) peak frequencies
    peak_vals_db: np.ndarray   # (k,)
    background_db: float


@dataclasses.dataclass
class DisplayConfig:
    fs: float
    fc_hz: float = 0.0
    nfft: int = 1024
    rows: int = 100            # waterfall depth
    pan_dr_db: float = 60.0    # dynamic range clamp (PAN_DR)
    pan_dir: str = "updown"    # 'up' | 'down' | 'updown'
    use_peaks: bool = True
    peak_dist_bins: int = 8    # min peak spacing
    peak_height_db: float = 6.0  # above median background
    time_pts: int = 256
    window: str = "hann"


class ThreeBox:
    """One domain's (RF / BB / AF) display state machine.

    update(x_block) runs the PSD + waterfall step on the device and
    returns a host DisplayFrame; retune(fc) realigns the waterfall."""

    def __init__(self, cfg: DisplayConfig, tag: str = "", device="cuda"):
        self.cfg = cfg
        self.tag = tag
        self.device = resolve_device(device)
        self.spots = SpotList()
        self.design = spectrum.SpectrumDesign(
            fs=cfg.fs, nfft=cfg.nfft, window=cfg.window)
        self._window = torch.from_numpy(self.design.window_array()) \
            .to(self.device)
        self.fc_hz = cfg.fc_hz
        self._wf = torch.full((cfg.rows, cfg.nfft), -200.0,
                              dtype=torch.float32, device=self.device)
        self._lo, self._hi = self._pan_slice()

    def _pan_slice(self) -> tuple[int, int]:
        """Displayed bin range: Up keeps [fc, fc+fs/2), Down keeps
        (fc-fs/2, fc], Up-Down keeps all."""
        n = self.cfg.nfft
        if self.cfg.pan_dir == "up":
            return n // 2, n
        if self.cfg.pan_dir == "down":
            return 0, n // 2 + 1
        return 0, n

    @property
    def freqs_hz(self) -> np.ndarray:
        return self.design.freqs_hz(self.fc_hz)[self._lo:self._hi]

    def update(self, x_block) -> DisplayFrame:
        """x_block: host complex (n,) or real (n,) samples."""
        cfg = self.cfg
        x = torch.from_numpy(np.ascontiguousarray(x_block, np.complex64)) \
            .to(self.device)
        row = spectrum.periodogram(x, self._window, nfft=cfg.nfft,
                                   hop=self.design.hop)
        self._wf = spectrum.waterfall_push(self._wf, row)
        bg = spectrum.background_median(row)
        dr = float(np.float32(cfg.pan_dr_db))
        img = spectrum.to_image_u8(spectrum.clamp_dynamic_range(
            self._wf[:, self._lo:self._hi], dr), dr)
        pidx, pval = spectrum.find_peaks(
            row[self._lo:self._hi], bg + float(np.float32(cfg.peak_height_db)),
            min_dist=cfg.peak_dist_bins)
        step = max(1, x.shape[0] // cfg.time_pts)
        env = torch.abs(x[: step * cfg.time_pts:step])
        pidx = pidx.cpu().numpy()
        pval = pval.cpu().numpy()
        ok = pidx >= 0
        if not cfg.use_peaks:
            ok[:] = False
        freqs = self.freqs_hz
        return DisplayFrame(
            time_y=env.cpu().numpy(),
            freqs_hz=freqs,
            psd_db=row[self._lo:self._hi].cpu().numpy(),
            waterfall_u8=img.cpu().numpy(),
            peak_freqs_hz=freqs[pidx[ok]],
            peak_vals_db=pval[ok],
            background_db=float(bg),
        )

    def retune(self, new_fc_hz: float):
        """Keep the waterfall history aligned with a new center."""
        df = self.design.fs / self.cfg.nfft
        bins = int(round((new_fc_hz - self.fc_hz) / df))
        if bins:
            self._wf = spectrum.waterfall_shift(self._wf, -bins)
        self.fc_hz = new_fc_hz

    def clear(self):
        self._wf = torch.full_like(self._wf, -200.0)


# --------------------------------------------------------------------------
# Colormaps + rendering (host)
# --------------------------------------------------------------------------

def _lerp_map(anchors) -> np.ndarray:
    """(pos, r, g, b) anchors in [0,1] -> (256, 3) uint8 LUT."""
    a = np.asarray(anchors, np.float64)
    x = np.linspace(0.0, 1.0, 256)
    lut = np.stack([np.interp(x, a[:, 0], a[:, 1 + c]) for c in range(3)],
                   axis=1)
    return np.clip(lut * 255.0, 0, 255).astype(np.uint8)


_COLORMAPS = {
    "jet": [(0, 0, 0, .5), (.125, 0, 0, 1), (.375, 0, 1, 1),
            (.625, 1, 1, 0), (.875, 1, 0, 0), (1, .5, 0, 0)],
    "hot": [(0, 0, 0, 0), (.375, 1, 0, 0), (.75, 1, 1, 0), (1, 1, 1, 1)],
    "gray": [(0, 0, 0, 0), (1, 1, 1, 1)],
    "bone": [(0, 0, 0, 0), (.375, .32, .32, .44), (.75, .66, .78, .78),
             (1, 1, 1, 1)],
    "cool": [(0, 0, 1, 1), (1, 1, 0, 1)],
    "copper": [(0, 0, 0, 0), (.8, 1, .625, .4), (1, 1, .78, .5)],
    "spring": [(0, 1, 0, 1), (1, 1, 1, 0)],
    "summer": [(0, 0, .5, .4), (1, 1, 1, .4)],
    "autumn": [(0, 1, 0, 0), (1, 1, 1, 0)],
    "winter": [(0, 0, 0, 1), (1, 0, 1, .5)],
    "viridis": [(0, .267, .005, .329), (.25, .283, .141, .458),
                (.5, .128, .567, .551), (.75, .369, .789, .383),
                (1, .993, .906, .144)],
}


def colormap_lut(name: str) -> np.ndarray:
    """(256, 3) uint8 LUT by name."""
    return _lerp_map(_COLORMAPS[name])


def colormap_names() -> list[str]:
    return sorted(_COLORMAPS)


def render_rgb(img_u8: np.ndarray, lut: np.ndarray) -> np.ndarray:
    """uint8 grayscale (rows, cols) -> RGB (rows, cols, 3) via LUT."""
    return lut[np.asarray(img_u8)]


def write_png(path: str, rgb: np.ndarray):
    """Minimal dependency-free PNG writer (8-bit RGB)."""
    rgb = np.ascontiguousarray(rgb, np.uint8)
    if rgb.ndim == 2:
        rgb = np.stack([rgb] * 3, axis=-1)
    h, w, _ = rgb.shape
    raw = b"".join(b"\x00" + rgb[y].tobytes() for y in range(h))

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data)))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    png = (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
           + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))
    with open(path, "wb") as f:
        f.write(png)


# --------------------------------------------------------------------------
# Display engine: the UpdatePSD loop
# --------------------------------------------------------------------------

class DisplayEngine:
    """Owns one ThreeBox per domain (RF + per-channel AF/BB) on the bank's
    device, consumes blocks from the executive's PSD tap, and rate-limits
    updates to every `decimate`-th block."""

    def __init__(self, bank, rf_cfg: DisplayConfig | None = None,
                 af_cfg: DisplayConfig | None = None, decimate: int = 1,
                 show_baseband: bool = False, max_af: int = 8):
        d = bank.design
        dev = bank.device
        self.bank = bank
        self.decimate = max(1, decimate)
        rxs = getattr(bank.cfg, "receivers", None)
        if rxs:
            # the RF pane shows the DEVICE passband: its center is the
            # tuner frequency fc0 - foffset, not the main dial
            fc0 = rxs[0].fc_hz - getattr(bank.cfg, "foffset_hz", 0.0)
        else:
            fc0 = getattr(bank.cfg, "fc_hz", 0.0)
        rf_cfg = rf_cfg or DisplayConfig(fs=d.fs_in, fc_hz=fc0)
        af_cfg = af_cfg or DisplayConfig(fs=d.fs_out, nfft=512,
                                         pan_dir="up")
        self.rf = ThreeBox(rf_cfg, tag="RF", device=dev)
        # a 64-channel channelizer does not need 64 panes
        n_af = min(bank.n_rx, max_af)
        self.af = [ThreeBox(dataclasses.replace(af_cfg), tag=f"AF{i}",
                            device=dev)
                   for i in range(n_af)]
        self.bb = [ThreeBox(DisplayConfig(fs=d.fs_out,
                                          fc_hz=rxs[i].fc_hz if rxs
                                          else fc0),
                            tag=f"BB{i}", device=dev)
                   for i in range(n_af)] if show_baseband else []
        self.frames: dict[str, DisplayFrame] = {}
        self._n = 0

    def _keeps(self, n: int) -> bool:
        """Whether the n-th block (1-based) updates the AF/BB panes: the
        first and every decimate-th after it, on the RF pane's phase (the
        reference updates them from block `decimate` on, so a run shorter
        than that had no AF frame)."""
        return (n - 1) % self.decimate == 0

    def __call__(self, executive, audio):
        """Executive psd_callback: audio is host complex64 (n_rx, n)."""
        self._n += 1
        if not self._keeps(self._n):
            return
        for i, box in enumerate(self.af):
            self.frames[box.tag] = box.update(
                np.ascontiguousarray(audio[i]))

    def wants_next_bb(self) -> bool:
        """True when the next __call__/update_bb pair will consume a
        baseband block (callers skip the device->host pull otherwise)."""
        return bool(self.bb) and self._keeps(self._n + 1)

    def update_bb(self, bb):
        """Feed the per-RX baseband boxes with host complex64
        (n_rx, out_block), on the AF update's decimation phase."""
        if not self.bb or not self._keeps(self._n):
            return
        for i, box in enumerate(self.bb):
            self.frames[box.tag] = box.update(
                np.ascontiguousarray(bb[i]))

    def update_rf(self, x_block) -> DisplayFrame:
        fr = self.rf.update(x_block)
        self.frames["RF"] = fr
        return fr

    def retune(self, fc_hz: float):
        self.rf.retune(fc_hz)

    def export_png(self, path: str, domain: str = "RF",
                   colormap: str = "viridis"):
        fr = self.frames[domain]
        write_png(path, render_rgb(fr.waterfall_u8, colormap_lut(colormap)))
        return path
