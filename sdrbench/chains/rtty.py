"""Reference chain `rtty`: one receiver in RTTY mode, whose audio is its
baseband passed through (the receivers chain's mix and resample, by
import), and the wideband RTTY decoder the App runs on that baseband
(`--rtty RX`), with a tap for the decoder's output.

The decoder here is written from the reference pySDR's description
(aa2il/pySDR rtty.py: up to 100 parallel 45.45-baud decoders over one
FFT filterbank; RTTY_Params, rtty.py:376-404: 170 Hz shift, 4 overlapped
FFTs a bit, Kaiser beta 8.6) and the port's documented rules, in plain
torch (float32, TF32 off) and numpy. It imports nothing of the program.
  - Frames of one bit at a quarter-bit hop from the stream's start, Kaiser
    windowed (unit sum), |FFT| zero-padded to a power of two. A block's
    frames are those its samples complete; their mean spectrum drives
    detection.
  - Detection on a block with frames while no channel is held, and a
    rescan on every 4th block with frames: FSK pairs (mark, space shift
    bins below) whose joint mean magnitude clears 10 dB over twice the
    25th-percentile floor and lies within 40 dB of the strongest pair,
    strongest first, each excluding [mark - 2 shift, mark + shift] for
    the next. A rescan adds pairs more than 2 shifts from every channel
    it keeps, and drops a channel after 4 scans in a row with its pair
    under the threshold and no candidate within a shift; a channel list
    it changes is sorted by mark bin, and the carried soft bits of a new
    channel are those of the channel that held its mark bin, if one did,
    else zeros.
  - Soft bits (mark - space) / (mark + space) a frame and channel, after
    a carried tail of at most 2 characters' frames, and the scores of the
    32 Baudot templates at every offset: one matrix product through
    `Arith`, which the control rounds to TF32.
  - Per channel, the timing search: over a character's offsets while
    unlocked, over 3 around the expected one while locked, the earliest
    offset whose best score lies within fpc 2^-24 of the top one (the
    port's TIE_PER_FRAME), a character where its score clears half a
    perfect one, lock lost after 2 misses in a row; then the LTRS/FIGS
    state machine.

The tap records, per delivered block, the decoder's new text per
channel, its channels' mark bins, and on every SCORE_EVERY-th block a
copy of the scores it pulled. `output` gives the same for every block of
the stream from its start; `output_measures` compares the window's
blocks: the text and channel lists of all, the scores of those kept.
"""

from __future__ import annotations

import dataclasses
import math
import sys
import time

import numpy as np
import torch

from sdrbench import harness, roofline
from sdrbench.chains.receivers import Receivers
from sdrbench.reference import Arith, lo, resample, resampler_taps, snap

SCORE_EVERY = 199               # the blocks whose scores are compared
RESCAN_EVERY = 4
EXPIRE_AFTER = 4
THRESH_DB = 10.0
REL_DB = 40.0
TIE_PER_FRAME = 2.0 ** -24
FRAME_CHUNK = 2048              # frames a filterbank pass
LTRS_CODE, FIGS_CODE = 31, 27
# ITA2, index = code; \x0f and \x0e stand at the shift codes, \x00 is
# blank: none of the three is emitted
LTRS_TABLE = "\x00E\nA SIU\rDRJNFCKTZLWHYPQOBG\x0fMXV\x0e"
FIGS_TABLE = "\x003\n- '87\r$4\x07,!:(5+)2#6019?&\x0f./;\x0e"
SILENT = "\x00\x0e\x0f"


@dataclasses.dataclass(frozen=True)
class Design:
    """The decoder's design at baseband rate fs (RTTY_Params)."""
    fs: float
    baud: float = 45.45
    shift_hz: float = 170.0
    frames_per_bit: int = 4
    kaiser_beta: float = 8.6
    max_channels: int = 100
    bits_per_char: int = 8      # start, 5 data, 2 stop

    @property
    def bit_len(self) -> int:
        return int(round(self.fs / self.baud))

    @property
    def nfft(self) -> int:
        return 1 << math.ceil(math.log2(self.bit_len))

    @property
    def hop(self) -> int:
        return self.bit_len // self.frames_per_bit

    @property
    def shift_bins(self) -> int:
        return max(1, int(round(self.shift_hz * self.nfft / self.fs)))

    @property
    def fpc(self) -> int:
        """Frames a character."""
        return self.bits_per_char * self.frames_per_bit

    def frames(self, n: int) -> int:
        """Frames that the stream's first n samples complete."""
        return max(0, (n - self.bit_len) // self.hop + 1)

    def templates(self) -> np.ndarray:
        """(32, fpc) +-1: the start bit on space, the code's 5 bits LSB
        first (1 on mark), 2 stop bits on mark, each a bit's frames."""
        rows = [[-1.0] + [1.0 if code >> k & 1 else -1.0 for k in range(5)]
                + [1.0, 1.0] for code in range(32)]
        return np.repeat(np.asarray(rows, np.float32), self.frames_per_bit,
                         axis=1)


@dataclasses.dataclass(frozen=True)
class Output:
    """One block's decoder output: the new text of each channel, their
    mark bins, and the scores (n_off, channels, 32) where kept."""
    texts: tuple
    marks: tuple
    scores: np.ndarray | None = None


def spectra(bb: torch.Tensor, d: Design) -> torch.Tensor:
    """|FFT| of every whole frame of the baseband bb (n,), (frames,
    nfft) float32."""
    w = np.kaiser(d.bit_len, d.kaiser_beta)
    w = torch.from_numpy((w / w.sum()).astype(np.float32)).to(bb.device)
    n = d.frames(bb.shape[0])
    out = torch.empty((n, d.nfft), dtype=torch.float32, device=bb.device)
    for j in range(0, n, FRAME_CHUNK):
        k = min(n, j + FRAME_CHUNK)
        seg = bb[j * d.hop:(k - 1) * d.hop + d.bit_len]
        out[j:k] = torch.fft.fft(seg.unfold(0, d.bit_len, d.hop) * w,
                                 n=d.nfft).abs()
    return out


class _Channel:
    __slots__ = ("mark", "figs", "pos", "locked", "misses", "idle")

    def __init__(self, mark: int):
        self.mark = int(mark)
        self.figs = self.locked = False
        self.pos = self.misses = self.idle = 0


class Decoder:
    """The streaming decoder's state over blocks."""

    def __init__(self, d: Design, device, ar: Arith):
        self.d, self.ar = d, ar
        self.tmpl = torch.from_numpy(d.templates().T.copy()).to(device)
        self.channels: list[_Channel] = []
        self.tail = None                # soft bits (rows, channels)
        self.scanned = 0                # blocks that had frames

    def candidates(self, avg: np.ndarray) -> tuple[list[int], float]:
        """Mark bins of the FSK pairs that clear the threshold and the
        window, strongest first, and the spectrum's floor."""
        sb, n = self.d.shift_bins, len(avg)
        floor = np.percentile(avg, 25)
        joint = avg + np.roll(avg, sb)          # mark at b, space at b - sb
        least = joint.max() * 10 ** (-REL_DB / 20)
        taken = np.zeros(n, bool)
        found = []
        for b in np.argsort(joint)[::-1]:
            if len(found) >= self.d.max_channels or joint[b] < least:
                break
            if taken[b] or taken[(b - sb) % n] or 20 * np.log10(
                    joint[b] / (2 * floor) + 1e-12) < THRESH_DB:
                continue
            taken[max(0, b - 2 * sb):b + sb + 1] = True
            found.append(int(b))
        return found, floor

    def detect(self, avg: np.ndarray) -> None:
        self.channels = [_Channel(b) for b in sorted(self.candidates(avg)[0])]
        self.tail = None

    def rescan(self, avg: np.ndarray) -> None:
        sb, n = self.d.shift_bins, len(avg)
        cand, floor = self.candidates(avg)
        for ch in self.channels:
            pair = avg[ch.mark] + avg[(ch.mark - sb) % n]
            loud = 20 * np.log10(pair / (2 * floor) + 1e-12) >= THRESH_DB
            near = any(abs(c - ch.mark) <= sb for c in cand)
            ch.idle = 0 if loud or near else ch.idle + 1
        kept = [ch for ch in self.channels if ch.idle < EXPIRE_AFTER]
        changed = len(kept) != len(self.channels)
        for b in cand:
            if len(kept) >= self.d.max_channels:
                break
            if all(abs(b - ch.mark) > 2 * sb for ch in kept):
                kept.append(_Channel(b))
                changed = True
        if changed:
            kept.sort(key=lambda ch: ch.mark)
            if self.tail is not None:
                # a channel takes the tail's column of its mark bin, a new
                # one zeros where no channel held its bin
                col = {ch.mark: i for i, ch in enumerate(self.channels)}
                zero = self.tail.new_zeros((self.tail.shape[0], 1))
                wide = torch.cat([self.tail, zero], 1)
                idx = [col.get(ch.mark, wide.shape[1] - 1) for ch in kept]
                self.tail = wide[:, torch.tensor(idx, device=wide.device)]
        self.channels = kept

    def scores(self, mags: torch.Tensor) -> tuple:
        """The matched scores (n_off, channels, 32) of the carried tail
        and these frames' soft bits, and the rows trimmed off the front of
        the tail carried on; (None, 0), the soft bits all carried, while
        they hold less than a character."""
        d = self.d
        mark = torch.tensor([ch.mark for ch in self.channels],
                            device=mags.device)
        m = mags[:, mark % d.nfft]
        s = mags[:, (mark - d.shift_bins) % d.nfft]
        soft = (m - s) / (m + s + 1e-9)
        if self.tail is not None and self.tail.shape[1] == len(mark):
            soft = torch.cat([self.tail, soft])
        if soft.shape[0] < d.fpc:
            self.tail = soft
            return None, 0
        trim = max(0, soft.shape[0] - 2 * d.fpc)
        self.tail = soft[trim:]
        return self.ar.mm(soft.unfold(0, d.fpc, 1), self.tmpl), trim

    def characters(self, best: np.ndarray, sym: np.ndarray, trim: int
                   ) -> list[str]:
        """Each channel's new text from the per-offset best scores
        (n_off, channels) and their symbols; then its position moves
        into the trimmed tail."""
        fpc = self.d.fpc
        gate, tie = 0.5 * fpc, fpc * TIE_PER_FRAME
        n_off = best.shape[0]
        out = []
        for ci, ch in enumerate(self.channels):
            col, text = best[:, ci], []
            while ch.pos + 1 < n_off:
                a = max(0, ch.pos - 1) if ch.locked else ch.pos
                b = a + (3 if ch.locked else fpc)
                if b > n_off:
                    break               # the search's frames are not all in
                w = col[a:b]
                o = a + int(np.argmax(w >= w.max() - tie))
                if best[o, ci] > gate:
                    text.append(self.emit(int(sym[o, ci]), ch))
                    ch.pos, ch.locked, ch.misses = o + fpc, True, 0
                else:
                    ch.pos += fpc
                    if ch.locked:
                        ch.misses += 1
                        if ch.misses >= 2:
                            ch.locked, ch.misses = False, 0
            ch.pos = max(0, ch.pos - trim)
            out.append("".join(text))
        return out

    @staticmethod
    def emit(code: int, ch: _Channel) -> str:
        if code in (LTRS_CODE, FIGS_CODE):
            ch.figs = code == FIGS_CODE
            return ""
        c = (FIGS_TABLE if ch.figs else LTRS_TABLE)[code]
        return "" if c in SILENT else c


def decode_stream(bb: torch.Tensor, block: int, d: Design, ar: Arith,
                  keep=lambda i: False) -> dict:
    """{block: Output} of the decoder fed bb (n,), a stream's baseband
    from its start, in blocks of `block` samples; the scores of the
    blocks that `keep` names."""
    mags = spectra(bb, d)
    n_blocks = bb.shape[0] // block
    edges = [d.frames((i + 1) * block) for i in range(n_blocks)]
    starts = [0] + edges[:-1]
    means = [mags[a:b].mean(0) for a, b in zip(starts, edges) if b > a]
    means = iter(torch.stack(means).cpu().numpy() if means else ())
    dec = Decoder(d, bb.device, ar)
    out = {}
    for i, (a, b) in enumerate(zip(starts, edges)):
        if b == a:
            out[i] = Output(("",) * len(dec.channels),
                            tuple(ch.mark for ch in dec.channels))
            continue
        avg = next(means)
        dec.scanned += 1
        if not dec.channels:
            dec.detect(avg)
        elif dec.scanned % RESCAN_EVERY == 0:
            dec.rescan(avg)
        marks = tuple(ch.mark for ch in dec.channels)
        if not marks:
            out[i] = Output((), ())
            continue
        sc, trim = dec.scores(mags[a:b])
        if sc is None:
            out[i] = Output(("",) * len(marks), marks)
            continue
        top = sc.max(dim=2)
        best, sym = top.values.cpu().numpy(), top.indices.cpu().numpy()
        out[i] = Output(tuple(dec.characters(best, sym, trim)), marks,
                        sc.cpu().numpy() if keep(i) else None)
    return out


class DecoderTap(harness.Tap):
    """Wraps the App's RTTY decoder: records each decode_block's text per
    channel and the channels' mark bins, and on the kept blocks a copy of
    the scores its pull brought to the host; reads its counters."""

    def __init__(self, app, keep):
        super().__init__()
        dec = self.dec = app.rtty
        if dec is None:
            raise RuntimeError("the App runs no RTTY decoder (--rtty)")
        decode, pull = dec.decode_block, dec._pull
        self._scores = None

        def pull_kept(t, slot):
            h = pull(t, slot)
            if slot == "scores" and keep(self.block):
                self._scores = np.array(h)
            return h

        def decode_block(x, *a, **kw):
            self._scores = None
            texts = decode(x, *a, **kw)
            self.record(Output(tuple(texts),
                               tuple(c["mark_bin"] for c in dec.channels),
                               self._scores))
            return texts
        dec._pull = pull_kept
        dec.decode_block = decode_block

    def counters(self) -> dict:
        """Each stage's ms summed (rtty_<stage>_ms), and the decoder's
        counts (rtty_<count>) where it keeps them."""
        d = self.dec
        out = {f"rtty_{k}_ms": v * d.stage_blocks
               for k, v in d.stage_ms.items()}
        out.update({f"rtty_{k}": v
                    for k, v in getattr(d, "counters", {}).items()})
        return out


def rtty_scores_launch(frames: float, channels: int, tail: int,
                       length: int) -> tuple[float, float]:
    """(bytes, operations) of one rtty_scores launch: the magnitudes of
    the mark and space bins read, the bins, the tail and the templates
    in, the soft bits and the scores out; 3 operations a soft bit, a
    multiply-add a template tap and score."""
    rows = tail + frames
    n_off = rows - length + 1
    return (4 * frames * 2 * channels + 8 * channels + 4 * tail * channels
            + 4 * 32 * length + 4 * rows * channels
            + 4 * n_off * channels * 32,
            3 * frames * channels + 2 * n_off * channels * 32 * length)


@dataclasses.dataclass(frozen=True)
class Rtty(Receivers):
    """The receivers (all in RTTY mode) and the decoder on the first
    (`--rtty 0`), which holds `channels` stations."""
    channels: int = 100

    def baseband(self, x: torch.Tensor, block0: int, ar: Arith
                 ) -> torch.Tensor:
        """(R, n_out) complex64: each receiver's LO mix and resample of x
        (from block `block0`'s first sample, zero before it), as
        Receivers.audio takes them, in spans of whole blocks after the
        resampler's history, so the spans join as one."""
        up, down = self.rates
        tpp = max(16, int(np.ceil(8 * down / up)))        # Receivers.audio's
        h = torch.from_numpy(resampler_taps(self.fs_in, up, down, tpp)) \
            .to(x.device)
        hist = tpp * down
        span = max(1, (1 << 23) // self.in_block) * self.in_block
        s0 = block0 * self.in_block
        rows = []
        for off in self.offsets_hz:
            k = snap(off, self.fs_in)
            parts = []
            for a in range(0, x.shape[0], span):
                a0 = max(0, a - hist)
                z = x[a0:a + span] * lo(k, s0 + a0, min(x.shape[0], a + span)
                                        - a0, -1.0, x.device)
                parts.append(resample(z[None], h, up, down, ar)[
                    0, (a - a0) // down * up:])
            rows.append(torch.cat(parts))
        return torch.stack(rows)

    def audio(self, x: torch.Tensor, block0: int, ar: Arith,
              check_from: int = 0):
        """RTTY mode's audio is its baseband, passed through."""
        bb = self.baseband(x, block0, ar)
        return bb, torch.ones(bb.shape[0], dtype=torch.bool,
                              device=x.device)

    @staticmethod
    def keep(block: int) -> bool:
        return block % SCORE_EVERY == 0

    def attach(self, app):
        return DecoderTap(app, self.keep)

    def output(self, x: torch.Tensor, ar: Arith) -> dict:
        t0 = time.perf_counter()
        bb = self.baseband(x, 0, ar)[0]
        out = decode_stream(bb, self.out_block, Design(self.fs_out), ar,
                            self.keep)
        if bb.is_cuda:
            torch.cuda.synchronize(bb.device)
        print(f"rtty reference: {len(out)} blocks from the stream's start "
              f"in {time.perf_counter() - t0:.3f} s", file=sys.stderr)
        return out

    def output_measures(self, prog: dict, ref: dict) -> dict:
        """rtty_text_mismatch: the share of the blocks' decoded characters,
        channels matched by mark bin, that differ (a character the other
        side lacks differs); rtty_channel_mismatch: blocks whose channel
        lists differ; rtty_scores_rel_err: the worst relative rms error of
        a kept block's scores (None where no block kept any). A block the
        program gave no output differs in all three."""
        chars = diff = off_list = 0
        worst = None
        for i, r in ref.items():
            p = prog[i] or Output((), ())
            off_list += p.marks != r.marks
            pt, rt = dict(zip(p.marks, p.texts)), dict(zip(r.marks, r.texts))
            for m in pt.keys() | rt.keys():
                a, b = pt.get(m, ""), rt.get(m, "")
                chars += max(len(a), len(b))
                diff += max(len(a), len(b)) - sum(
                    u == v for u, v in zip(a, b))
            if r.scores is None and p.scores is None:
                continue
            rel = math.inf
            if r.scores is not None and p.scores is not None \
                    and p.scores.shape == r.scores.shape:
                ref64 = r.scores.astype(np.float64)
                rel = float(np.linalg.norm(p.scores - ref64)
                            / max(np.linalg.norm(ref64), 1e-30))
            worst = rel if worst is None else max(worst, rel)
        return {"rtty_text_mismatch": diff / max(1, chars),
                "rtty_channel_mismatch": off_list,
                "rtty_scores_rel_err": worst}

    def launches(self, wire: str) -> dict:
        """One step's scan launches, and rtty_scores' launch a block at the
        decoder's shapes: the frames a block (on average), the channels,
        a carried tail of 2 characters' frames."""
        d = Design(self.fs_out)
        out = roofline.step_launches(len(self.modes), self.out_block)
        out["rtty_scores"] = [rtty_scores_launch(
            self.out_block / d.hop, self.channels, 2 * d.fpc, d.fpc)]
        return out


def build(spec: dict, fc_hz: float, block: int) -> Rtty:
    """As the receivers chain, by their dials (`fc_mhz`); every receiver
    in RTTY mode."""
    if any(m != "RTTY" for m in spec["modes"]):
        raise ValueError(f"the rtty chain runs RTTY mode only: "
                         f"{spec['modes']}")
    kw = {k: v for k, v in spec.items() if k not in ("kind", "fc_mhz")}
    return Rtty(offsets_hz=tuple(f * 1e6 - fc_hz for f in spec["fc_mhz"]),
                modes=tuple(kw.pop("modes")), block=block, **kw)
