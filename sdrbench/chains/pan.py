"""Reference chain `pan`: the receivers of the `receivers` chain (by
import) and the pan-adaptor the App draws with `--psd --bb`: a three-box
pane (time pane, PSD, waterfall with peak marks) for the RF passband, one
for each receiver's audio (AF) and one for each receiver's baseband
(BB), each updated on every block (`--psd-every 1`), with a tap on the
App's frames.

The panes are written from the reference pySDR's description (aa2il/pySDR
Plotting.py:312-753, three_box_plot: the periodogram at :462, the
waterfall rolled by concatenation at :543, the median background and
find_peaks with a height and a distance at :583-600, the pan direction
at :515-531, the clamp max(zz, zmax - PAN_DR) at :618-626; gui.py:1222-1398,
UpdatePSD; gui.py:121-221, the BB domain) and the port's documented
rules, in plain torch (float32, TF32 off) and numpy. It imports nothing
of the program. A pane's products for a block of n samples:
  - the PSD row: the mean over the block's segments of nfft samples at a
    hop of nfft / 2 (one zero-padded segment under nfft) of |FFT(w x)|^2
    / nfft, w the Hann window scaled to unit rms, fftshifted, in dB (10
    log10, floored at 1e-20);
  - the waterfall: the last `rows` PSD rows, the newest first, -200 dB
    before the first; its displayed bins (an AF pane shows the upper
    half, [fc, fc + fs/2)) clamped to their max less the range, then as
    codes floor(255 clamp((z - (max - range)) / range, 0, 1));
  - the background: the row's median over all its bins (the mean of the
    two middle values);
  - the peaks: displayed bins over each of the `dist` bins to their left
    and at least each of the `dist` to their right (one flag a plateau,
    where scipy's find_peaks takes its middle), at least `height` over
    the background; the highest first (the lower bin first on a tie), at
    most MAX_PEAKS;
  - the time pane: |x| at every (n // 256)-th sample, 256 points.
The RF pane reads the RF wire; AF pane i the reference's audio of
receiver i as the f32 audio wire delivers it; BB pane i its baseband,
the bank's mix and resample before the demod (the rtty chain's).

The RF pane shows the RF block the executive dispatched last: the
drained block's own, unless that block drained after the next one's
dispatch. So the tap records which RF block each RF update showed, and
the reference's RF waterfall follows that record.

The tap keeps, on every SAMPLE_EVERY-th delivered block and on the
window's last two others (a closed loop's window ends at a delivery
time, which a block's updates precede), the frames the panes' updates
already brought to the host (references, no copy), and the RF blocks of
the RF pane's last `rows` updates. `output` gives every pane's rows and
time panes for every block from the stream's start, their frames worked
out on demand; `output_measures` compares the kept blocks.
"""

from __future__ import annotations

import collections
import dataclasses
import math
import sys
import time

import numpy as np
import torch
from numpy.lib.stride_tricks import sliding_window_view

from sdrbench import harness
from sdrbench.chains.receivers import Receivers
from sdrbench.chains.rtty import Rtty
from sdrbench.reference import Arith, demod

SAMPLE_EVERY = 97               # the delivered blocks whose frames compare
MEASURES = ("display_psd_db_err", "display_img_code_mismatch",
            "display_peak_mismatch", "display_rf_psd_db_err")
MAX_PEAKS = 32
MAX_AF = 8                      # the App's AF and BB panes at most
FLOOR_DB = -200.0               # a waterfall row before the first update
ROW_CHUNK = 64                  # blocks a Welch pass
DEMOD_CHUNK = 256               # blocks a demod pass, after its warm-up


@dataclasses.dataclass(frozen=True)
class Frame:
    """One pane's compared products of a block: the PSD row over the
    displayed bins (dB), the waterfall's codes (rows, bins), the peaks'
    bins (highest first) and the time pane."""
    psd: np.ndarray
    img: np.ndarray
    peaks: np.ndarray
    env: np.ndarray

    @classmethod
    def of(cls, fr) -> "Frame":
        """From the program's DisplayFrame: its peaks' frequencies as
        bins of its axis."""
        return cls(fr.psd_db, fr.waterfall_u8,
                   np.searchsorted(fr.freqs_hz, fr.peak_freqs_hz), fr.time_y)


def find_peaks(row: np.ndarray, height, dist: int, k: int) -> np.ndarray:
    """The bins of row's peaks: over each of the `dist` bins to the left,
    at least each of the `dist` to the right, at least `height`; the
    highest first, ties by bin; at most k."""
    pad = np.full(dist, -np.inf, np.float32)
    w = sliding_window_view(np.concatenate([pad, row, pad]), 2 * dist + 1)
    ok = (row > w[:, :dist].max(1)) & (row >= w[:, dist + 1:].max(1)) \
        & (row >= height)
    idx = np.flatnonzero(ok)
    return idx[np.argsort(-row[idx], kind="stable")][:k]


@dataclasses.dataclass(frozen=True)
class Pane:
    """One three-box pane's settings (the port's DisplayConfig defaults;
    an AF pane: nfft 512, the upper half)."""
    nfft: int = 1024
    rows: int = 100
    range_db: float = 60.0
    upper_half: bool = False
    height_db: float = 6.0
    dist: int = 8
    time_pts: int = 256

    @property
    def hop(self) -> int:
        return self.nfft // 2

    @property
    def shown(self) -> slice:
        return slice(self.nfft // 2 if self.upper_half else 0, self.nfft)

    def psd_rows(self, x: torch.Tensor) -> torch.Tensor:
        """(B, nfft) float32 dB: each of the blocks x (B, n) complex64."""
        pad = self.nfft - x.shape[1]
        if pad > 0:
            x = torch.cat([x, x.new_zeros(x.shape[0], pad)], 1)
        w = np.hanning(self.nfft)
        w = torch.from_numpy((w / np.sqrt(np.mean(w ** 2)))
                             .astype(np.float32)).to(x.device)
        spec = torch.fft.fft(x.unfold(1, self.nfft, self.hop) * w, dim=-1)
        p = (spec.real ** 2 + spec.imag ** 2).mean(dim=1) / self.nfft
        return 10.0 * torch.log10(torch.clamp(
            torch.fft.fftshift(p, dim=-1), min=1e-20))

    def stream(self, x: torch.Tensor) -> tuple:
        """(rows (B, nfft), time panes (B, time_pts)) of the blocks x
        (B, n), a Welch pass a ROW_CHUNK of them."""
        rows = torch.cat([self.psd_rows(x[j:j + ROW_CHUNK])
                          for j in range(0, x.shape[0], ROW_CHUNK)])
        step = max(1, x.shape[1] // self.time_pts)
        return rows, x[:, :step * self.time_pts:step].abs()

    def frame(self, rows: torch.Tensor, env: torch.Tensor) -> Frame:
        """The frame of a block from its pane's rows (m, nfft), the
        newest (the block's own) first, and its time pane."""
        wf = rows.new_full((self.rows, self.nfft), FLOOR_DB)
        m = min(self.rows, rows.shape[0])
        wf[:m] = rows[:m]
        shown = wf[:, self.shown]
        top = shown.max()
        z = torch.maximum(shown, top - self.range_db)
        img = (torch.clamp((z - (top - self.range_db)) / self.range_db,
                           0.0, 1.0) * 255.0).to(torch.uint8)
        row = rows[0]
        mid = torch.sort(row).values[self.nfft // 2 - 1:self.nfft // 2 + 1]
        bg = np.float32(mid.mean().item())
        psd = row[self.shown].cpu().numpy()
        return Frame(psd, img.cpu().numpy(),
                     find_peaks(psd, bg + np.float32(self.height_db),
                                self.dist, MAX_PEAKS), env.cpu().numpy())


class Stream:
    """Every pane's rows and time panes over the blocks of a stream,
    {tag: (Pane, rows (N, nfft), time panes (N, k))}."""

    def __init__(self, panes: dict):
        self.panes = panes

    @property
    def n_blocks(self) -> int:
        """The blocks of the stream."""
        return next(iter(self.panes.values()))[1].shape[0]

    def frames(self, block: int, rf_blocks=()) -> dict:
        """{tag: Frame} of `block`, every pane's; the RF pane's waterfall
        from the RF blocks `rf_blocks` (newest first) where given, else
        from the blocks up to `block`."""
        out = {}
        for tag, (pane, rows, env) in self.panes.items():
            ids = list(range(block, max(-1, block - pane.rows), -1))
            if tag == "RF" and rf_blocks:
                ids = list(rf_blocks)
            out[tag] = pane.frame(rows[ids], env[ids[0]])
        return out


@dataclasses.dataclass(frozen=True)
class Shown:
    """A block of the reference's stream, its frames worked out on
    demand. It stands in for a `Kept` where the reference's output takes
    the program's place (control.py): its RF pane's updates follow the
    blocks, so it has no `rf_blocks` of its own."""
    stream: Stream
    block: int
    rf_blocks: tuple = ()

    def pane_frames(self, rf_blocks=()) -> dict:
        return self.stream.frames(self.block, rf_blocks)


@dataclasses.dataclass
class Kept:
    """A delivered block's frames as the program drew them, the panes'
    DisplayFrames by tag, and the RF blocks of the RF pane's last
    updates, the newest first."""
    frames: dict = dataclasses.field(default_factory=dict)
    rf_blocks: tuple = ()

    def pane_frames(self) -> dict:
        return {tag: Frame.of(fr) for tag, fr in self.frames.items()}


def _unmatched(a: np.ndarray, b: np.ndarray) -> int:
    """The peaks of a with no peak of b within one bin."""
    return sum(1 for k in a if not (np.abs(b - k) <= 1).any())


def measures(pairs, panes: dict) -> dict:
    """The display's compared numbers over [(program {tag: Frame},
    reference {tag: Frame})], `panes` {tag: Pane}: the worst |dB|
    difference of a PSD row over the bins within the pane's range of the
    reference row's max; the share of waterfall codes that differ by
    more than one; the share of peaks, on either side, with no peak
    within one bin on the other; and the first number over the RF pane
    alone. The RF pane reads the RF wire as the program does, where the
    AF panes read audio whose float32 differences a DC-blocked or
    filtered-out bin shows tenths of a dB large: so the RF pane's own
    number can refuse an RF pane off by much less. A pane the program
    drew no frame of (or one of another shape) differs everywhere."""
    err, rf_err, off, px, lost, peaks = 0.0, 0.0, 0, 0, 0, 0
    for got, want in pairs:
        for tag, w in want.items():
            g = got.get(tag)
            peaks += len(w.peaks)
            if g is None or g.psd.shape != w.psd.shape \
                    or g.img.shape != w.img.shape:
                e = math.inf
                off, px = off + w.img.size, px + w.img.size
                lost += len(w.peaks)
            else:
                live = w.psd >= w.psd.max() - panes[tag].range_db
                e = float(np.abs(g.psd[live].astype(np.float64)
                                 - w.psd[live]).max())
            err = max(err, e)
            if tag == "RF":
                rf_err = max(rf_err, e)
            if e == math.inf:
                continue
            d = np.abs(g.img.astype(np.int16) - w.img.astype(np.int16))
            off += int((d > 1).sum())
            px += d.size
            peaks += len(g.peaks)
            lost += _unmatched(g.peaks, w.peaks) + _unmatched(w.peaks,
                                                              g.peaks)
    return dict(zip(MEASURES, (err, off / max(1, px),
                               lost / max(1, peaks), rf_err)))


class DisplayTap(harness.Tap):
    """Wraps each of the App's display panes' update (the engine's
    __call__, update_rf and update_bb call them; a dunder call cannot be
    wrapped on the instance) and the bank's step_device, whose calls
    number the RF block the RF pane shows. On a kept block it records a
    `Kept` of the frames the updates returned."""

    def __init__(self, app, keep):
        super().__init__()
        disp = self.disp = app.display
        if disp is None:
            raise RuntimeError("the App draws no display (--psd)")
        self.ex, self.keep = app.ex, keep
        self.dispatched = 0
        self.rf_blocks: collections.deque = collections.deque(
            maxlen=disp.rf.cfg.rows)
        self.at = None              # the block whose updates run
        self.kept = None            # its record, where it is kept
        # the window's last two blocks so far, where not kept anyway
        self.lasts: collections.deque = collections.deque()
        step = app.ex.bank.step_device

        def step_device(xb):
            self.dispatched += 1
            return step(xb)
        app.ex.bank.step_device = step_device
        for box in disp.panes:
            box.update = self._tapped(box, box.update)

    def _in_window(self, block: int) -> bool:
        """Whether the harness's delivery, which wraps the App's per-block
        callback, counts `block` in the window."""
        dl = getattr(self.ex.psd_callback, "__self__", None)
        return isinstance(dl, harness.Delivery) and dl.in_window(
            block, time.perf_counter())

    def _start(self, block: int) -> None:
        self.at, self.kept = block, None
        shown = self._in_window(block)
        if shown and len(self.lasts) == 2:
            del self.outputs[self.lasts.popleft()]  # not the window's last
        if self.keep(block) or shown:
            self.kept = Kept()
            self.record(self.kept)
            if not self.keep(block):
                self.lasts.append(block)

    def _tapped(self, box, update):
        def tapped(x):
            fr = update(x)
            if self.block != self.at:
                self._start(self.block)
            rf = box is self.disp.rf
            if rf:
                self.rf_blocks.appendleft(self.dispatched - 1)
            if self.kept is not None:
                self.kept.frames[box.tag] = fr
                if rf:
                    self.kept.rf_blocks = tuple(self.rf_blocks)
            return fr
        return tapped

    def counters(self) -> dict:
        """The display's stage_ms (display_<stage>_ms) and frame counts
        (display_<domain>_frames), where it keeps them."""
        d = self.disp
        out = {f"display_{k}_ms": v
               for k, v in getattr(d, "stage_ms", {}).items()}
        out.update({f"display_{k}_frames": v
                    for k, v in getattr(d, "counters", {}).items()})
        return out


@dataclasses.dataclass(frozen=True)
class Pan(Receivers):
    """The receivers and the display's panes: RF, then AF and BB for each
    of the first MAX_AF receivers."""

    # the rtty chain's mix and resample, in spans joined as one
    baseband = Rtty.baseband

    @property
    def n_af(self) -> int:
        return min(len(self.modes), MAX_AF)

    def panes(self) -> dict:
        n = self.n_af
        return {"RF": Pane(),
                **{f"AF{i}": Pane(nfft=512, upper_half=True)
                   for i in range(n)},
                **{f"BB{i}": Pane() for i in range(n)}}

    def stream_audio(self, bb: torch.Tensor, ar: Arith) -> torch.Tensor:
        """(R, n) complex64: each receiver's demod of its baseband bb
        (R, n) from the stream's start, DEMOD_CHUNK blocks a pass, each
        pass from zero state the harness's warm-up earlier (as the audio
        checks take it)."""
        ob = self.out_block
        nb = bb.shape[1] // ob
        warm = math.ceil(harness.WARM_AUDIO_S * self.fs_out / ob)
        rows = []
        for r, mode in enumerate(self.modes):
            parts = []
            for b0 in range(0, nb, DEMOD_CHUNK):
                s = max(0, b0 - warm)
                a, _ = demod(bb[r:r + 1, s * ob:(b0 + DEMOD_CHUNK) * ob],
                             mode, self.fs_out, s * ob, ob, self.squelch_db,
                             ar, 0)
                parts.append(a[0, (b0 - s) * ob:])
            rows.append(torch.cat(parts))
        return torch.stack(rows)

    @staticmethod
    def keep(block: int) -> bool:
        return block % SAMPLE_EVERY == 0

    def attach(self, app):
        return DisplayTap(app, self.keep)

    def output(self, x: torch.Tensor, ar: Arith) -> dict:
        t0 = time.perf_counter()
        nb = x.shape[0] // self.in_block
        x = x[:nb * self.in_block]
        bb = self.baseband(x, 0, ar)
        audio = self.stream_audio(bb, ar)
        ob = self.out_block
        panes = self.panes()
        blocks = {"RF": x.view(nb, self.in_block)}
        for i in range(self.n_af):
            blocks[f"AF{i}"] = audio[i].view(nb, ob)
            blocks[f"BB{i}"] = bb[i].view(nb, ob)
        stream = Stream({tag: (p, *p.stream(blocks[tag]))
                         for tag, p in panes.items()})
        if x.is_cuda:
            torch.cuda.synchronize(x.device)
        print(f"pan reference: {nb} blocks from the stream's start in "
              f"{time.perf_counter() - t0:.3f} s", file=sys.stderr)
        return {i: Shown(stream, i) for i in range(nb)}

    def output_measures(self, prog: dict, ref: dict) -> dict:
        """The display's numbers (`measures`) over the compared blocks
        of `prog`: every SAMPLE_EVERY-th and the last the tap kept, of
        those whose RF pane showed a block of the reference's stream. A
        block that drained after the next block's dispatch showed that
        block's RF, so the window's last (without prefetch, its last
        pipeline depth) may show one past the stream; each compared
        block compares all its panes. A block the program kept no frames
        of differs everywhere. None where no block is compared."""
        n = next(iter(ref.values())).stream.n_blocks if ref else 0

        def inside(p) -> bool:
            return p is None or max(p.rf_blocks, default=-1) < n
        last = max((i for i, p in prog.items()
                    if p is not None and inside(p)), default=None)
        pairs = []
        for i, p in prog.items():
            if not ((self.keep(i) or i == last) and inside(p)):
                continue
            got = {} if p is None else p.pane_frames()
            pairs.append((got, ref[i].pane_frames(
                () if p is None else p.rf_blocks)))
        if not pairs:
            return dict.fromkeys(MEASURES, None)
        return measures(pairs, self.panes())


def build(spec: dict, fc_hz: float, block: int) -> Pan:
    """As the receivers chain, by their dials (`fc_mhz`)."""
    kw = {k: v for k, v in spec.items() if k not in ("kind", "fc_mhz")}
    return Pan(offsets_hz=tuple(f * 1e6 - fc_hz for f in spec["fc_mhz"]),
               modes=tuple(kw.pop("modes")), block=block, **kw)
