"""Headless three-box display: time pane + PSD + waterfall (counterpart of
pysdr_tpu/models/display.py).

The PSD, the rolling waterfall and the peak picking run on the bank's
device (ops/spectrum); the waterfall stays there as a (rows, nfft)
tensor, and only the uint8 image, the PSD row and the peak list cross to
the host. On a card each pane's step is one CUDA graph a block length,
replayed on the display's own stream (the JAX package's
`jax.jit(self._step_impl)`, pysdr_tpu/models/display.py). The host
pieces (Spot, SpotList, the colormap LUTs, render_rgb and the PNG
writer) are copies of the reference's: its module imports jax.
"""

from __future__ import annotations

import contextlib
import dataclasses
import struct
import time
import zlib
from typing import NamedTuple

import numpy as np
import torch

from pysdr_tpu_torch.device import resolve_device
from pysdr_tpu_torch.models import graphstep
from pysdr_tpu_torch.ops import spectrum
from pysdr_tpu_torch.runtime.profiler import stage_range


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


# the peaks a frame carries at most (find_peaks' default, as the JAX step's)
MAX_PEAKS = 32


def _layout(n: int, nbins: int, rows: int, time_pts: int) -> tuple:
    """The outputs of one update of an n-sample block, packed in one byte
    vector (name, dtype, shape, byte offset): the 4-byte fields first, so
    every offset is aligned, the uint8 image last."""
    step = max(1, n // time_pts)
    n_env = len(range(0, min(n, step * time_pts), step))
    fields = (("psd", torch.float32, (nbins,)),
              ("pval", torch.float32, (MAX_PEAKS,)),
              ("bg", torch.float32, ()),
              ("env", torch.float32, (n_env,)),
              ("pidx", torch.int32, (MAX_PEAKS,)),
              ("img", torch.uint8, (rows, nbins)))
    out, off = [], 0
    for name, dt, shape in fields:
        out.append((name, dt, shape, off))
        off += int(np.prod(shape, dtype=np.int64)) * dt.itemsize
    return tuple(out), off


def _field(buf: torch.Tensor, dt, shape, off: int) -> torch.Tensor:
    n = int(np.prod(shape, dtype=np.int64)) * dt.itemsize
    return buf[off:off + n].view(dt).reshape(shape)


@dataclasses.dataclass
class _Block:
    """The static buffers of one block length n: the input (the n complex
    samples, then the dynamic range and the peak height, one float32
    vector), the outputs packed in one byte vector, and their host twins
    (pinned memory on a card; the buffers themselves on the CPU). On a
    card the events of the last upload and the last pull, and with
    graph=True the captured graph."""
    inp: torch.Tensor
    out: torch.Tensor
    host_in: torch.Tensor
    host_x: torch.Tensor           # the samples' view of host_in
    host_out: torch.Tensor
    outs: tuple                    # device views of `out`, by field
    host: dict                     # numpy views of `host_out`, by name
    in_done: object = None
    out_done: object = None
    captured: graphstep.Captured | None = None

    @property
    def x(self) -> torch.Tensor:
        return self.inp[:-2].view(torch.complex64)


_PANE_TENSORS = "the pane's waterfall or window"


class ThreeBox:
    """One domain's (RF / BB / AF) display state machine.

    update(x_block) runs the PSD + waterfall step on the device and
    returns a host DisplayFrame; retune(fc) realigns the waterfall.

    The step is a body over static buffers, one set per block length
    (`prepare(n)`): the block and the two controls (`pan_dr_db`,
    `peak_height_db`, copied in at each update as device scalars, so a
    change shows in the next frame without a new capture) go up in one
    copy; the waterfall is pushed in place; the newest row, the image,
    the peaks, the background and the time pane come back in one copy.
    On a card every copy, replay and pull is issued on the pane's own
    stream (`stream`, the engine's), so an update waits on its own
    pull alone, never on a bank step in flight; with graph=True (the
    default) the body of each block length is captured once as a CUDA
    graph (models/graphstep.capture) and replayed, with graph=False it
    runs eagerly. On the CPU the body runs eagerly over the same
    buffers. A failed capture or replay raises; a block of a length the
    pane was not prepared for raises once one length was prepared (the
    first update prepares its own length); rebinding the waterfall
    raises at the next update: retune and clear write into it."""

    def __init__(self, cfg: DisplayConfig, tag: str = "", device="cuda",
                 graph: bool = True, stream=None):
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
        on_card = self.device.type == "cuda"
        self.graph = bool(graph) and on_card
        self.stream = (stream if stream is not None
                       else torch.cuda.Stream(self.device)) \
            if on_card else None
        self._blocks: dict[int, _Block] = {}
        self._bound = self._tensors()
        # ms the updates spent waiting on their pull (out_done), summed
        self.wait_ms = 0.0

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

    @property
    def graph_count(self) -> int:
        """CUDA graphs captured so far: one per block length."""
        return sum(b.captured is not None for b in self._blocks.values())

    @property
    def lengths(self) -> list[int]:
        """The block lengths prepared so far."""
        return sorted(self._blocks)

    def _tensors(self) -> tuple:
        return (self._wf, self._window)

    def _on_stream(self):
        return torch.cuda.stream(self.stream) if self.stream is not None \
            else contextlib.nullcontext()

    def _compute(self, x, wf, dr, height, in_place: bool) -> tuple:
        """The step (the JAX package's _step_impl): the outputs in
        _layout's order. in_place pushes the newest row into wf itself;
        otherwise wf is left as it is."""
        cfg = self.cfg
        lo, hi = self._lo, self._hi
        row = spectrum.periodogram(x, self._window, nfft=cfg.nfft,
                                   hop=self.design.hop)
        wf = (spectrum.waterfall_push_ if in_place
              else spectrum.waterfall_push)(wf, row)
        bg = spectrum.background_median(row)
        img = spectrum.to_image_u8(spectrum.clamp_dynamic_range(
            wf[:, lo:hi], dr), dr)
        pidx, pval = spectrum.find_peaks(row[lo:hi], bg + height,
                                         max_peaks=MAX_PEAKS,
                                         min_dist=cfg.peak_dist_bins)
        step = max(1, x.shape[0] // cfg.time_pts)
        env = torch.abs(x[: step * cfg.time_pts:step])
        return row[lo:hi], pval, bg, env, pidx, img

    def _body(self, blk: _Block) -> None:
        """One update over the static buffers: the waterfall pushed in
        place, the outputs copied into the packed output vector."""
        inp = blk.inp
        for o, r in zip(blk.outs, self._compute(
                blk.x, self._wf, inp[-2], inp[-1], in_place=True)):
            o.copy_(r)

    def prepare(self, n: int) -> None:
        """Make the static buffers of n-sample blocks, and on a card with
        graph=True capture the body over them (a no-op once done). Call
        it before other threads work on the card: a capture fails while
        another thread issues work there."""
        n = int(n)
        if n not in self._blocks:
            self._blocks[n] = self._make(n)

    def _make(self, n: int) -> _Block:
        dev = self.device
        on_card = dev.type == "cuda"
        layout, nbytes = _layout(n, self._hi - self._lo, self.cfg.rows,
                                 self.cfg.time_pts)
        inp = torch.zeros(2 * n + 2, dtype=torch.float32, device=dev)
        out = torch.zeros(nbytes, dtype=torch.uint8, device=dev)
        host_in = torch.zeros(inp.shape, dtype=inp.dtype,
                              pin_memory=True) if on_card else inp
        host_out = torch.zeros(out.shape, dtype=out.dtype,
                               pin_memory=True) if on_card else out
        blk = _Block(
            inp=inp, out=out,
            host_in=host_in, host_x=host_in[:-2].view(torch.complex64),
            host_out=host_out,
            outs=tuple(_field(out, dt, shape, off)
                       for _, dt, shape, off in layout),
            host={name: _field(host_out, dt, shape, off).numpy()
                  for name, dt, shape, off in layout})
        if not on_card:
            return blk
        blk.in_done, blk.out_done = torch.cuda.Event(), torch.cuda.Event()
        if self.graph:
            def warm_up():
                # the step once (its cuFFT plan), the waterfall unwritten
                self._compute(blk.x, self._wf, inp[-2], inp[-1],
                              in_place=False)
                return ()
            blk.captured, _ = graphstep.capture(
                dev, warm_up, lambda _outs: self._body(blk), self._tensors,
                self.stream, _PANE_TENSORS)
        return blk

    def update(self, x_block) -> DisplayFrame:
        """x_block: host complex (n,) or real (n,) samples."""
        cfg = self.cfg
        graphstep.check_bound(self._tensors(), self._bound, _PANE_TENSORS)
        x = np.asarray(x_block)
        n = x.shape[0]
        if n not in self._blocks:
            if self._blocks:
                raise ValueError(
                    f"display pane {self.tag or '?'}: a block of {n} "
                    f"samples, but the pane was prepared for {self.lengths}")
            self.prepare(n)
        blk = self._blocks[n]
        if blk.in_done is not None:
            # the last upload out of the pinned input has finished
            blk.in_done.synchronize()
        # torch's copy: threaded, and without the interpreter lock (a
        # 4 M-sample RF block is 32.8 MB)
        blk.host_x.copy_(torch.from_numpy(x if x.flags.writeable
                                          else x.copy()))
        blk.host_in[-2:] = torch.tensor(
            [cfg.pan_dr_db, cfg.peak_height_db], dtype=torch.float32)
        if self.stream is None:
            self._body(blk)
        else:
            with torch.cuda.stream(self.stream):
                blk.inp.copy_(blk.host_in, non_blocking=True)
                blk.in_done.record()
                if blk.captured is not None:
                    blk.captured.replay()
                else:
                    self._body(blk)
                blk.host_out.copy_(blk.out, non_blocking=True)
                blk.out_done.record()
            t0 = time.perf_counter()
            blk.out_done.synchronize()
            self.wait_ms += 1e3 * (time.perf_counter() - t0)
        h = blk.host
        pidx = h["pidx"].copy()
        pval = h["pval"].copy()
        ok = pidx >= 0
        if not cfg.use_peaks:
            ok[:] = False
        freqs = self.freqs_hz
        return DisplayFrame(
            time_y=h["env"].copy(),
            freqs_hz=freqs,
            psd_db=h["psd"].copy(),
            waterfall_u8=h["img"].copy(),
            peak_freqs_hz=freqs[pidx[ok]],
            peak_vals_db=pval[ok],
            background_db=float(h["bg"]),
        )

    def retune(self, new_fc_hz: float):
        """Keep the waterfall history aligned with a new center (written
        into the waterfall, on the pane's stream)."""
        df = self.design.fs / self.cfg.nfft
        bins = int(round((new_fc_hz - self.fc_hz) / df))
        if bins:
            with self._on_stream():
                spectrum.waterfall_shift_(self._wf, -bins)
        self.fc_hz = new_fc_hz

    def clear(self):
        with self._on_stream():
            self._wf.fill_(-200.0)


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

# the display's domains: the RF pane, the AF panes, the BB panes
DOMAINS = ("rf", "af", "bb")


class DisplayEngine:
    """Owns one ThreeBox per domain (RF + per-channel AF/BB) on the bank's
    device, consumes blocks from the executive's PSD tap, and rate-limits
    updates to every `decimate`-th block. On a card its panes share one
    CUDA stream of their own (`stream`), and `prepare` captures each
    pane's graph (graph=False: the panes run eagerly).

    Each domain's updates of a block run under the profiler range
    `pysdr.display_<domain>#<block_id>` (the id the block's __call__
    gave, which its update_rf and update_bb reuse), are timed into
    `stage_ms` and counted, a frame a pane, in `counters`."""

    def __init__(self, bank, rf_cfg: DisplayConfig | None = None,
                 af_cfg: DisplayConfig | None = None, decimate: int = 1,
                 show_baseband: bool = False, max_af: int = 8,
                 graph: bool = True):
        d = bank.design
        dev = resolve_device(bank.device)
        self.bank = bank
        self.decimate = max(1, decimate)
        self.stream = torch.cuda.Stream(dev) if dev.type == "cuda" \
            else None
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

        def box(cfg, tag):
            return ThreeBox(cfg, tag=tag, device=dev, graph=graph,
                            stream=self.stream)
        self.rf = box(rf_cfg, "RF")
        # a 64-channel channelizer does not need 64 panes
        n_af = min(bank.n_rx, max_af)
        self.af = [box(dataclasses.replace(af_cfg), f"AF{i}")
                   for i in range(n_af)]
        self.bb = [box(DisplayConfig(fs=d.fs_out,
                                     fc_hz=rxs[i].fc_hz if rxs else fc0),
                       f"BB{i}")
                   for i in range(n_af)] if show_baseband else []
        self.frames: dict[str, DisplayFrame] = {}
        self._n = 0
        self.block_id = None
        self._domain_ms = dict.fromkeys(DOMAINS, 0.0)
        # the frames made, by domain
        self.counters = dict.fromkeys(DOMAINS, 0)

    @property
    def stage_ms(self) -> dict:
        """Cumulative ms on the host's clock: each domain's updates
        ("rf", "af", "bb"), summed over its panes, from the first pane's
        copy in to the last pane's frame; and "wait", the part of all of
        them that the panes spent waiting on their pull."""
        return {**self._domain_ms,
                "wait": sum(b.wait_ms for b in self.panes)}

    def _update(self, domain: str, boxes, blocks) -> None:
        """Update each of `boxes` with its block, as one timed domain."""
        t0 = time.perf_counter()
        with stage_range(f"display_{domain}", self.block_id):
            for box, x in zip(boxes, blocks):
                self.frames[box.tag] = box.update(x)
        self._domain_ms[domain] += 1e3 * (time.perf_counter() - t0)
        self.counters[domain] += len(boxes)

    @property
    def panes(self) -> list[ThreeBox]:
        return [self.rf, *self.af, *self.bb]

    @property
    def graph_count(self) -> int:
        """CUDA graphs captured over the panes: one per (pane, length)."""
        return sum(b.graph_count for b in self.panes)

    def prepare(self) -> None:
        """Prepare the RF pane for the bank's in_block and the AF and BB
        panes for its out_block (on a card: capture their graphs). A
        no-op once done; the App runs it from Executive.prepare, before
        the prefetch thread and the services start."""
        d = self.bank.design
        self.rf.prepare(d.in_block)
        for b in (*self.af, *self.bb):
            b.prepare(d.out_block)

    def _keeps(self, n: int) -> bool:
        """Whether the n-th block (1-based) updates the AF/BB panes: the
        first and every decimate-th after it, on the RF pane's phase (the
        reference updates them from block `decimate` on, so a run shorter
        than that had no AF frame)."""
        return (n - 1) % self.decimate == 0

    def __call__(self, executive, audio, block_id=None):
        """Executive psd_callback: audio is host complex64 (n_rx, n);
        block_id names the block in the profiler's ranges, this call's
        and those of the update_rf and update_bb that follow it."""
        self._n += 1
        self.block_id = block_id
        if not self._keeps(self._n):
            return
        self._update("af", self.af, audio)

    def wants_next_bb(self) -> bool:
        """True when the next __call__/update_bb pair will consume a
        baseband block (callers skip the device->host pull otherwise)."""
        return bool(self.bb) and self._keeps(self._n + 1)

    def update_bb(self, bb):
        """Feed the per-RX baseband boxes with host complex64
        (n_rx, out_block), on the AF update's decimation phase."""
        if not self.bb or not self._keeps(self._n):
            return
        self._update("bb", self.bb, bb)

    def update_rf(self, x_block) -> DisplayFrame:
        self._update("rf", (self.rf,), (x_block,))
        return self.frames["RF"]

    def retune(self, fc_hz: float):
        self.rf.retune(fc_hz)

    def export_png(self, path: str, domain: str = "RF",
                   colormap: str = "viridis"):
        fr = self.frames[domain]
        write_png(path, render_rgb(fr.waterfall_u8, colormap_lut(colormap)))
        return path
