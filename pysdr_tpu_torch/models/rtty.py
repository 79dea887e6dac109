"""Wideband parallel RTTY decoder: FFT filterbank + batched matched filter
(counterpart of pysdr_tpu/models/rtty.py).

Up to 100 parallel 45.45-baud FSK decoders over one FFT filterbank. The
host half is the JAX package's, unchanged: the Baudot tables,
RTTYDesign, the templates, the test-signal synthesizer, and the
decoder's detection, rescan, symbol slicing and LTRS/FIGS state machine.
The device half runs in torch on the decoder's device: Kaiser-windowed
frames at hop spacing -> |FFT| and their mean over frames
(`filterbank_block`), then the soft bits at every channel's mark/space
bins and the matched scores of all 32 Baudot templates at every frame
offset in one call (`rtty_scores`): on a CUDA tensor the hand-written
kernel (csrc/rtty.cu, kernels.rtty), on a CPU tensor the plain twin
`rtty_scores_ref`, with no fallback from one to the other.

The filterbank is a body over static buffers, one set a frame count
(the JAX decoder's `jax.jit` of `filterbank_block`, which it feeds the
frame-exact slice so that it sees few shapes): on a card it is captured
once a frame count as a CUDA graph and replayed. Every device op of the
decoder runs on its own CUDA stream, which waits on the events after
which the block is valid, and per block the decoder pulls to the host
only what the host logic reads, each by one copy into pinned memory
whose event it waits on alone: the mean spectrum (nfft,) for detection,
rescan and `last_spectrum`, and the scores (n_off, n_ch, 32) for the
state machine. The baseband tail and the soft-bit tail stay on the
device.

One departure from the host half: where the JAX decoder's timing search
takes the argmax of scores that are equal but for float rounding, this
one takes the earliest of the tied offsets (`_pick`, `TIE_PER_FRAME`).
Where scores differ by a few units in the last place (the idle of a
crowded band), either rule follows the rounding, and the two decoders
may decode a character apart.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time

import numpy as np
import torch

from pysdr_tpu_torch.device import resolve_device
from pysdr_tpu_torch.models import graphstep
from pysdr_tpu_torch.runtime.profiler import stage_range

# ITA2 / Baudot code tables (LTRS and FIGS shifts), index = 5-bit code.
BAUDOT_LTRS = [
    '\x00', 'E', '\n', 'A', ' ', 'S', 'I', 'U',
    '\r', 'D', 'R', 'J', 'N', 'F', 'C', 'K',
    'T', 'Z', 'L', 'W', 'H', 'Y', 'P', 'Q',
    'O', 'B', 'G', '\x0f', 'M', 'X', 'V', '\x0e']
BAUDOT_FIGS = [
    '\x00', '3', '\n', '-', ' ', "'", '8', '7',
    '\r', '$', '4', '\x07', ',', '!', ':', '(',
    '5', '+', ')', '2', '#', '6', '0', '1',
    '9', '?', '&', '\x0f', '.', '/', ';', '\x0e']
LTRS_CODE, FIGS_CODE = 31, 27
# matched scores within fpc * 2^-24 of each other count as one score: one
# float32 unit in the last place of any score that clears the gate
# (fpc/2 .. fpc), where FFT libraries and summation orders round apart
TIE_PER_FRAME = 2.0 ** -24


@dataclasses.dataclass(frozen=True)
class RTTYDesign:
    """Static decoder design (reference RTTY_Params, rtty.py:376-404)."""
    fs: float                      # baseband sample rate
    baud: float = 45.45
    shift_hz: float = 170.0
    frames_per_bit: int = 4        # 4 overlapped FFTs per bit
    max_channels: int = 100
    kaiser_beta: float = 8.6

    @property
    def bit_len(self) -> int:
        """Samples per bit."""
        return int(round(self.fs / self.baud))

    @property
    def nfft(self) -> int:
        """Window = one bit period, padded to a power of two."""
        n = self.bit_len
        return 1 << int(np.ceil(np.log2(n)))

    @property
    def hop(self) -> int:
        return self.bit_len // self.frames_per_bit

    @property
    def bin_hz(self) -> float:
        return self.fs / self.nfft

    @property
    def shift_bins(self) -> int:
        return max(1, int(round(self.shift_hz / self.bin_hz)))

    def window(self) -> np.ndarray:
        w = np.kaiser(self.bit_len, self.kaiser_beta)
        return (w / w.sum()).astype(np.float32)

    # character frame: 1 start bit (space) + 5 data + 2 stop bits (mark)
    @property
    def bits_per_char(self) -> int:
        return 8

    @property
    def frames_per_char(self) -> int:
        return self.bits_per_char * self.frames_per_bit


def char_templates(design: RTTYDesign) -> np.ndarray:
    """(32, frames_per_char) ±1 templates: start=space(-1), 5 data bits
    LSB-first (mark=+1 for 1), stop=mark(+1). The reference's per-decoder
    template bank (rtty.py:483-512) shared by all channels."""
    fpb = design.frames_per_bit
    rows = []
    for code in range(32):
        bits = [-1.0] + [(1.0 if (code >> b) & 1 else -1.0)
                         for b in range(5)] + [1.0, 1.0]
        rows.append(np.repeat(bits, fpb))
    return np.asarray(rows, np.float32)


# ---------------------------------------------------------------------------
# device half
# ---------------------------------------------------------------------------

def filterbank_block(x: torch.Tensor, design: RTTYDesign,
                     window: torch.Tensor) -> torch.Tensor:
    """Windowed overlapped FFTs: complex64 baseband (n,) -> magnitude
    spectra (n_frames, nfft) float32, frames at `hop` spacing (4 per
    bit). window float32 (bit_len,) on x's device."""
    segs = x.unfold(0, design.bit_len, design.hop) * window
    return torch.fft.fft(segs, n=design.nfft, dim=-1).abs()


def soft_bits(mags: torch.Tensor, mark_bins: torch.Tensor,
              space_bins: torch.Tensor) -> torch.Tensor:
    """Per-channel FSK soft decision from filterbank magnitudes.
    mags (n_frames, nfft); mark/space_bins (n_ch,) int, taken modulo
    nfft. Returns (n_frames, n_ch) in [-1, 1]: +1 = mark."""
    nfft = mags.shape[1]
    mark = mags.index_select(1, torch.remainder(mark_bins, nfft).long())
    space = mags.index_select(1, torch.remainder(space_bins, nfft).long())
    return (mark - space) / (mark + space + 1e-9)


def matched_scores(soft: torch.Tensor,
                   templates: torch.Tensor) -> torch.Tensor:
    """scores[f, c, s] = sum_t soft[f+t, c] * templates[s, t] for every
    (frame offset, channel, symbol): (n_off, n_ch, 32), n_off =
    n_frames - L + 1, empty when fewer than L frames."""
    n_frames, n_ch = soft.shape
    n_sym, L = templates.shape
    if n_frames < L:
        return soft.new_zeros((0, n_ch, n_sym))
    windows = soft.unfold(0, L, 1)                    # (n_off, n_ch, L)
    return torch.matmul(windows, templates.t())


def rtty_scores_ref(mags, mark_bins, space_bins, soft_tail, templates):
    """Plain torch twin of the rtty_scores kernel: the soft bits of mags
    after the carried tail, and their matched scores. Returns (soft
    (T+F, C), scores (max(T+F-L+1, 0), C, 32))."""
    soft = torch.cat([soft_tail, soft_bits(mags, mark_bins, space_bins)])
    return soft, matched_scores(soft, templates)


def rtty_scores(mags, mark_bins, space_bins, soft_tail, templates):
    """Soft bits + matched scores of one block: mags float32 (F, nfft),
    mark/space_bins int32 (C,), soft_tail float32 (T, C), templates
    float32 (32, L). A CPU tensor takes the plain twin; any other goes to
    the CUDA kernel, whose wrapper raises if it cannot launch."""
    if mags.device.type == "cpu":
        return rtty_scores_ref(mags, mark_bins, space_bins, soft_tail,
                               templates)
    from pysdr_tpu_torch.kernels import rtty as krtty
    return krtty.rtty_scores(mags, mark_bins, space_bins, soft_tail,
                             templates)


def _as_baseband(x, device) -> torch.Tensor:
    """A baseband block as complex64 (n,) on `device`: a complex tensor
    or array, or float32 (n, 2) pairs."""
    if not isinstance(x, torch.Tensor):
        x = np.asarray(x)
        x = torch.from_numpy(np.ascontiguousarray(
            x.astype(np.complex64) if np.iscomplexobj(x)
            else x.astype(np.float32)))
    if not x.is_complex():
        x = torch.view_as_complex(x.float().contiguous())
    return x.to(device=device, dtype=torch.complex64).reshape(-1)


def n_frames(n: int, design: RTTYDesign) -> int:
    """The frames at hop spacing that n samples hold (< 1: none)."""
    return (n - design.bit_len) // design.hop + 1


def frame_counts(design: RTTYDesign, tail: int, block: int) -> list[int]:
    """The frame counts that a stream of `block`-sample blocks gives the
    filterbank after a carried baseband tail of `tail` samples: the tail
    arithmetic of decode_block, run until the tail's length repeats.
    Sorted, without 0 (a block that completes no frame)."""
    if block < 1:
        raise ValueError(f"block: {block} samples")
    counts, seen = set(), set()
    while tail not in seen:
        seen.add(tail)
        tail += block
        f = n_frames(tail, design)
        if f >= 1:
            counts.add(f)
            tail -= f * design.hop
    return sorted(counts)


@dataclasses.dataclass
class _Frames:
    """The static buffers of one frame count F: the filterbank's input,
    [baseband tail | block] as (F - 1) * hop + bit_len complex64
    samples, its magnitudes (F, nfft) and their mean over the frames
    (nfft,), float32; with graph=True on a card, the filterbank captured
    over them."""
    inp: torch.Tensor
    mags: torch.Tensor
    mean: torch.Tensor
    captured: graphstep.Captured | None = None


_DECODER_TENSORS = "the decoder's window"
# the parts of decode_block that stage_ms times
STAGES = ("spectrum", "detect", "scores", "channels")


class _Laps:
    """The host's clock at the start of decode_block's work and at the end
    of each part of it that ran (STAGES, in order), each part also the
    range `pysdr.rtty_<stage>#<block_id>` while a torch.profiler
    records."""

    def __init__(self, block_id):
        self.block_id = block_id
        self.t = [time.perf_counter()]
        self._range = None
        self._enter()

    def _enter(self):
        k = len(self.t) - 1
        if k < len(STAGES):
            self._range = stage_range(f"rtty_{STAGES[k]}", self.block_id)
            self._range.__enter__()

    def close(self):
        if self._range is not None:
            self._range.__exit__(None, None, None)
            self._range = None

    def lap(self):
        self.close()
        self.t.append(time.perf_counter())
        self._enter()


class RTTYDecoder:
    """Host-driven streaming decoder over the device filterbank and
    matched filter.

    detect_channels: pick carrier candidates from the average spectrum
    (reference find_sigs scan, rtty.py:744-776). decode_block: per channel,
    slice symbol windows on the recovered clock, argmax matched scores,
    SNR-gate, and feed the baudot FSM (rtty.py:567-700).

    The filterbank runs over static buffers, one set a frame count
    (`prepare`). On a card every device op of the decoder is issued on
    its own stream (`stream`), and with graph=True (the default) the
    filterbank of each frame count is captured once as a CUDA graph
    (models/graphstep.capture) and replayed; graph=False runs the same
    body eagerly, as the CPU always does. A block whose frame count was
    not prepared raises, and a failed capture or replay raises: nothing
    falls back to the eager body.
    """

    def __init__(self, design: RTTYDesign, rescan_every: int = 4,
                 expire_after: int = 4, thresh_db: float = 10.0,
                 rel_db: float = 40.0, device="cuda", graph: bool = True):
        self.design = design
        self.device = resolve_device(device)
        self.window = torch.from_numpy(design.window()).to(self.device)
        self.templates = torch.from_numpy(
            char_templates(design)).to(self.device)
        on_card = self.device.type == "cuda"
        self.graph = bool(graph) and on_card
        self.stream = torch.cuda.Stream(self.device) if on_card else None
        self._frames: dict[int, _Frames] = {}
        # pinned host buffers of the pulls, by name, and the last pull's
        # event (on a card)
        self._host: dict[str, torch.Tensor] = {}
        self._pulled = torch.cuda.Event() if on_card else None
        # the channels' mark bins and their (mark, space) rows on the
        # device, uploaded when the channel list changes
        self._bins: tuple = ((), None)
        self._stage_sum = dict.fromkeys(STAGES, 0.0)
        self.stage_blocks = 0
        self._chars = self._rescans = 0
        self.channels: list[dict] = []   # {mark_bin, figs, text, ...}
        self._soft_tail = None           # float32 (T, n_ch) on the device
        self._iq_tail = None             # keeps frames hop-aligned across blocks
        # continuous-scan policy (the reference scans every pass,
        # rtty.py:744-776): re-scan every N blocks, expire a channel after
        # M consecutive scans below threshold
        self.rescan_every = max(1, rescan_every)
        self.expire_after = max(1, expire_after)
        self.thresh_db = thresh_db
        # dynamic-range window: ignore pairs more than rel_db below the
        # strongest pair (suppresses filter-stopband images of strong
        # stations on clean captures, where the absolute floor is ~0)
        self.rel_db = rel_db
        self._n_blocks = 0
        self.last_spectrum = None

    @property
    def graph_count(self) -> int:
        """CUDA graphs captured so far: one per frame count."""
        return sum(f.captured is not None for f in self._frames.values())

    @property
    def frame_counts(self) -> list[int]:
        """The frame counts prepared so far."""
        return sorted(self._frames)

    @property
    def stage_ms(self) -> dict:
        """Mean ms a block, over `stage_blocks` (the blocks that ran the
        filterbank), in each part of decode_block on the host's clock:
        "spectrum" until the mean spectrum is on the host (the wait on
        the block's events, the copies into the static input, the
        filterbank and the pull), "detect" detection or rescan, "scores"
        from the issue of rtty_scores until its scores are on the host,
        "channels" the per-channel state machine."""
        n = max(1, self.stage_blocks)
        return {k: v / n for k, v in self._stage_sum.items()}

    @property
    def counters(self) -> dict:
        """Cumulative counts of the work decode_block did: the characters
        it decoded, its rescans and the blocks that ran the filterbank."""
        return {"chars": self._chars, "rescans": self._rescans,
                "filterbank_blocks": self.stage_blocks}

    def _on_stream(self):
        return torch.cuda.stream(self.stream) if self.stream is not None \
            else contextlib.nullcontext()

    def _tensors(self) -> tuple:
        return (self.window,)

    def _filterbank(self, inp: torch.Tensor) -> tuple:
        mags = filterbank_block(inp, self.design, self.window)
        return mags, mags.mean(dim=0)

    def _body(self, inp: torch.Tensor, outs: tuple) -> None:
        """The filterbank over one frame count's static buffers."""
        for o, r in zip(outs, self._filterbank(inp)):
            o.copy_(r)

    def prepare(self, block: int) -> list[int]:
        """Make the static buffers of every frame count that blocks of
        `block` samples give after the decoder's baseband tail
        (frame_counts), and on a card with graph=True capture the
        filterbank over each; a count done already is kept. Returns the
        counts. Call it after carried state is loaded (set_tails), and
        before other threads work on the card: a capture fails while
        another thread issues work there (the App runs it from
        Executive.prepare)."""
        tail = 0 if self._iq_tail is None else int(self._iq_tail.shape[0])
        counts = frame_counts(self.design, tail, int(block))
        for f in counts:
            if f not in self._frames:
                self._frames[f] = self._make(f)
        if self.stream is not None:
            # the pulls' pinned buffers at their largest (a soft tail of
            # at most 2 * fpc rows before a block's frames), and
            # rtty_scores' library, made outside the run: a pinned
            # allocation inside it may wait on the whole card
            d = self.design
            n_off = d.frames_per_char + max(self._frames) + 1
            self._pinned("mean", d.nfft, torch.float32)
            self._pinned("scores", n_off * d.max_channels * 32,
                         torch.float32)
            self._pinned("bins", 2 * d.max_channels, torch.int32)
            from pysdr_tpu_torch.kernels import build
            build.library()
        return counts

    def _make(self, f: int) -> _Frames:
        d, dev = self.design, self.device
        inp = torch.zeros((f - 1) * d.hop + d.bit_len, dtype=torch.complex64,
                          device=dev)
        if not self.graph:
            return _Frames(inp, torch.empty((f, d.nfft), dtype=torch.float32,
                                            device=dev),
                           torch.empty(d.nfft, dtype=torch.float32,
                                       device=dev))
        cap, (mags, mean) = graphstep.capture(
            dev, lambda: self._filterbank(inp),
            lambda outs: self._body(inp, outs), self._tensors, self.stream,
            _DECODER_TENSORS)
        return _Frames(inp, mags, mean, cap)

    def set_tails(self, iq_tail, soft_tail) -> None:
        """Load carried state onto the decoder's device, on its stream:
        the baseband tail (complex (n,), or float32 (n, 2) pairs) and the
        soft-bit tail (float32 (T, n_ch)), arrays or tensors, or None."""
        with self._on_stream():
            self._iq_tail = None if iq_tail is None \
                else _as_baseband(iq_tail, self.device)
            self._soft_tail = None if soft_tail is None else torch.as_tensor(
                soft_tail, dtype=torch.float32).to(self.device)

    def _pinned(self, slot: str, n: int, dtype) -> torch.Tensor:
        """The first n elements of the decoder's pinned host buffer
        `slot`, made or grown to fit."""
        buf = self._host.get(slot)
        if buf is None or buf.numel() < n:
            buf = self._host[slot] = torch.empty(n, dtype=dtype,
                                                 pin_memory=True)
        return buf[:n]

    def _pull(self, t: torch.Tensor, slot: str) -> np.ndarray:
        """t's values on the host. On a card: one non_blocking copy on the
        decoder's stream into its pinned buffer `slot`, then a wait on
        that copy's event alone; the array views the buffer, which the
        next pull into `slot` rewrites. On the CPU: t's own values."""
        if self.stream is None:
            return t.numpy()
        h = self._pinned(slot, t.numel(), t.dtype).view(t.shape)
        h.copy_(t, non_blocking=True)
        self._pulled.record(self.stream)
        self._pulled.synchronize()
        return h.numpy()

    def _device_bins(self) -> torch.Tensor:
        """(2, n_ch) int32 on the device: the channels' mark bins and
        their space bins, uploaded when the channel list changed (on a
        card from the pinned buffer "bins", whose last upload the mean
        spectrum's pull of this block has waited for)."""
        key = tuple(c["mark_bin"] for c in self.channels)
        if self._bins[0] != key:
            mark = torch.tensor(key, dtype=torch.int32)
            bins = torch.stack([mark, (mark - self.design.shift_bins)
                                % self.design.nfft])
            if self.stream is not None:
                h = self._pinned("bins", bins.numel(), torch.int32)
                h = h.view(bins.shape)
                h.copy_(bins)
                bins = h.to(self.device, non_blocking=True)
            self._bins = (key, bins)
        return self._bins[1]

    def _new_channel(self, mark_bin: int) -> dict:
        return {"mark_bin": int(mark_bin), "figs": False, "text": "",
                "snr_db": 0.0, "idle_scans": 0}

    def _candidate_bins(self, avg: np.ndarray) -> list[int]:
        """Mark-bin candidates: FSK pairs (mark + space shift_bins below)
        above the median floor, strongest first, de-overlapped. The
        threshold tests the pair's JOINT mean energy: FSK keys exactly one
        of the two tones at any instant, so mark+space together is
        duty-cycle-invariant, while either bin alone under-reports at
        mark-heavy duty cycles (idle is all-mark). Floor = 25th
        percentile: at the reference's 100-stations-in-band density
        (rtty.py:56) the MEDIAN bin is already signal-occupied."""
        d = self.design
        floor = np.percentile(avg, 25)
        sb = d.shift_bins
        cand = []
        joint = avg + np.roll(avg, sb)   # mark at b, space at b - shift
        order = np.argsort(joint)[::-1]
        used = np.zeros(len(avg), bool)
        min_joint = joint.max() * 10 ** (-self.rel_db / 20)
        for b in order:
            if len(cand) >= d.max_channels:
                break
            sp = (b - sb) % len(avg)
            if used[b] or used[sp]:
                continue
            if joint[b] < min_joint:
                break            # sorted descending — all weaker below
            if 20 * np.log10(joint[b] / (2 * floor) + 1e-12) \
                    < self.thresh_db:
                continue
            # exclusion zone [mark-2*shift, mark+shift]: covers the pair's
            # own span plus the keying sidebands below the space tone
            # (which otherwise spawn shadow channels decoding duplicate
            # text) while staying narrower than the reference's
            # 100-stations-in-band pitch (rtty.py:56)
            lo = max(0, b - 2 * sb)
            used[lo:b + sb + 1] = True
            cand.append(int(b))
        return cand

    def detect_channels(self, avg: np.ndarray,
                        thresh_db: float | None = None):
        """Initial scan over the mean spectrum (nfft,): replace the
        channel list (reference find_sigs, rtty.py:744-776)."""
        if thresh_db is not None:
            self.thresh_db = thresh_db
        cand = self._candidate_bins(avg)
        self.channels = [self._new_channel(b) for b in sorted(cand)]
        # a full re-detect replaces the channel set: any carried soft-bit
        # tail indexes the OLD columns
        self._soft_tail = None
        return [c["mark_bin"] for c in self.channels]

    def rescan(self, avg: np.ndarray) -> tuple[list[int], list[int]]:
        """Continuous operation over the mean spectrum (nfft,): merge
        newly-appeared stations into the channel list and expire ones that
        have gone quiet, preserving the decode state (pos/figs/lock) of
        surviving channels. Returns (added_bins, removed_bins)."""
        d = self.design
        sb = d.shift_bins
        cand = self._candidate_bins(avg)
        added, removed = [], []
        # activity bookkeeping for existing channels (joint mark+space
        # energy, duty-cycle invariant — see _candidate_bins)
        floor = np.percentile(avg, 25)
        for ch in self.channels:
            b = ch["mark_bin"]
            sp = (b - sb) % len(avg)
            snr = 20 * np.log10((avg[b] + avg[sp]) / (2 * floor) + 1e-12)
            ch["snr_db"] = float(snr)
            active = snr >= self.thresh_db or any(
                abs(c - b) <= sb for c in cand)
            ch["idle_scans"] = 0 if active else ch.get("idle_scans", 0) + 1
        survivors = []
        for ch in self.channels:
            if ch["idle_scans"] >= self.expire_after:
                removed.append(ch["mark_bin"])
            else:
                survivors.append(ch)
        # add genuinely new stations (not near a survivor)
        for b in cand:
            if len(survivors) >= d.max_channels:
                break
            if all(abs(b - ch["mark_bin"]) > 2 * sb for ch in survivors):
                nc = self._new_channel(b)
                survivors.append(nc)
                added.append(b)
        if added or removed:
            # remap the persistent soft-bit tail to the new channel order:
            # survivors keep their column, new channels start from zeros
            # (column n_old of the padded tail)
            old_idx = {ch["mark_bin"]: i
                       for i, ch in enumerate(self.channels)}
            survivors.sort(key=lambda c: c["mark_bin"])
            if self._soft_tail is not None:
                tail = self._soft_tail
                n_old = tail.shape[1]
                idx = torch.tensor([old_idx.get(ch["mark_bin"], n_old)
                                    for ch in survivors], dtype=torch.long)
                with self._on_stream():
                    idx = idx.to(tail.device)
                    padded = torch.cat(
                        [tail, tail.new_zeros((len(tail), 1))], 1)
                    self._soft_tail = padded.index_select(1, idx)
        self.channels = survivors
        return added, removed

    def decode_block(self, x, ready=None, block_id=None) -> list[str]:
        """Process one baseband block (complex (n,) or float32 (n, 2)
        pairs, a tensor or an array); returns newly decoded text per
        channel. Device, on the decoder's stream: [baseband tail | block]
        into the frame count's static input, the filterbank (on a card
        with graph=True a graph replay), soft bits + matched scores;
        host: detection or rescan, symbol slicing + baudot FSM.

        ready: on a card, the CUDA events after which a device block is
        valid (the executive's drained_bb_ready), which the decoder's
        stream waits on; None waits on all work issued so far on the
        current stream. block_id: the block's id in the executive, which
        keys each part's profiler range (`pysdr.rtty_<stage>#<block_id>`).
        The first block of an unprepared decoder prepares its own length;
        a block whose frame count was not prepared raises ValueError and
        leaves the decoder as it was."""
        if self.stream is not None:
            if ready is None:
                self.stream.wait_stream(
                    torch.cuda.current_stream(self.device))
            else:
                for ev in ready:
                    self.stream.wait_event(ev)
        with self._on_stream():
            x = _as_baseband(x, self.device)
            if x.is_cuda:
                # made on another stream, read on this one
                x.record_stream(self.stream)
            if not self._frames:
                self.prepare(x.shape[0])
            laps = _Laps(block_id)
            try:
                out = self._decode(x, laps)
                self._chars += sum(map(len, out))
                return out
            finally:
                laps.close()
                t = laps.t
                if len(t) > 1:
                    t += [t[-1]] * (len(STAGES) + 1 - len(t))
                    for k, a, b in zip(STAGES, t, t[1:]):
                        self._stage_sum[k] += (b - a) * 1e3

    def _decode(self, x: torch.Tensor, laps: _Laps) -> list[str]:
        """decode_block's work on the decoder's stream; `laps.lap()` at
        the end of each part it runs (STAGES)."""
        d = self.design
        tail = self._iq_tail
        tl = 0 if tail is None else tail.shape[0]
        f = n_frames(tl + x.shape[0], d)
        if f < 1:
            self._iq_tail = x.clone() if tail is None else torch.cat([tail, x])
            return ["" for _ in self.channels]
        fr = self._frames.get(f)
        if fr is None:
            raise ValueError(
                f"RTTY decoder: {x.shape[0]} samples after a {tl}-sample "
                f"tail make {f} frames, but the decoder was prepared for "
                f"{self.frame_counts}")
        if tl:
            fr.inp[:tl].copy_(tail)
        fr.inp[tl:].copy_(x[:fr.inp.shape[0] - tl])
        cut = f * d.hop
        self._iq_tail = x[cut - tl:].clone() if cut >= tl \
            else torch.cat([tail[cut:], x])
        if fr.captured is not None:
            fr.captured.replay()
        else:
            self._body(fr.inp, (fr.mags, fr.mean))
        # spectrum tap for the live RTTY waterfall (the reference RTTY
        # window's top pane, rtty.py:92-371): mean |X| over this block
        avg = self._pull(fr.mean, "mean").copy()
        laps.lap()
        self.stage_blocks += 1
        self.last_spectrum = avg
        self._n_blocks += 1
        if not self.channels:
            self.detect_channels(avg)
        elif self._n_blocks % self.rescan_every == 0:
            # continuous station add/expire (reference re-scans every
            # pass, rtty.py:744-776)
            self.rescan(avg)
            self._rescans += 1
        laps.lap()
        if not self.channels:
            return []
        n_ch = len(self.channels)
        bins = self._device_bins()
        # persistent soft-bit buffer so characters straddling block edges
        # decode intact (the reference's prev-symbol concat,
        # rtty.py:825-831); a tail of another channel count is dropped
        tail = self._soft_tail
        if tail is None or tail.shape[1] != n_ch:
            tail = fr.mags.new_zeros((0, n_ch))
        soft, sc = rtty_scores(fr.mags, bins[0], bins[1], tail,
                               self.templates)
        fpc = d.frames_per_char
        if soft.shape[0] < fpc:
            # not one character's worth of frames yet (small device
            # blocks) — accumulate and wait
            self._soft_tail = soft
            laps.lap()
            return ["" for _ in self.channels]
        sc = self._pull(sc, "scores")                 # (n_off, n_ch, 32)
        laps.lap()
        out = [self._decode_channel(sc[:, ci, :], ch)
               for ci, ch in enumerate(self.channels)]
        # trim consumed frames; shift channel positions into the kept tail
        trim = max(0, soft.shape[0] - 2 * fpc)
        self._soft_tail = soft[trim:].clone()
        for ch in self.channels:
            ch["pos"] = max(0, ch.get("pos", 0) - trim)
        laps.lap()
        return out

    def _decode_channel(self, scores: np.ndarray, ch: dict) -> str:
        """Symbol-synchronous decode with per-character timing recovery:
        search the full character period for the best-matching (offset,
        symbol), emit if the normalized score clears the gate, then jump
        one character (the reference's integrated-score argmax timing,
        rtty.py:530-564, per character instead of per window)."""
        d = self.design
        fpc = d.frames_per_char
        gate = 0.5 * fpc            # perfect match scores ~fpc
        text = []
        pos = ch.get("pos", 0)
        locked = ch.get("locked", False)
        misses = ch.get("misses", 0)
        n_off = scores.shape[0]
        while pos + 1 < n_off:
            # acquisition: search a whole character period; once locked,
            # only a ±1-frame jitter window so shift chars can't be skipped
            span = 3 if locked else fpc
            lo = max(0, pos - 1) if locked else pos
            hi = lo + span
            if hi > n_off:
                # the full search span hasn't streamed in yet — deciding
                # on a truncated window picks premature off-center chars
                # (garbles small-block incremental decode); wait
                break
            win = scores[lo:hi]
            o, sym = self._pick(win)
            off = lo + o
            if win[o, sym] > gate:
                text.append(self._baudot(sym, ch))
                pos = off + fpc
                locked, misses = True, 0
            else:
                pos += fpc
                if locked:
                    misses += 1
                    if misses >= 2:
                        locked, misses = False, 0
        ch["pos"] = pos   # absolute in the soft buffer; caller trims
        ch["locked"], ch["misses"] = locked, misses
        s = "".join(t for t in text if t)
        ch["text"] += s
        return s

    def _pick(self, win: np.ndarray) -> tuple[int, int]:
        """The timing search over one window (span, 32) of scores: (offset
        in the window, symbol). Offsets whose best score is within f32
        rounding of the top one are tied (an isolated station's idle
        all-mark stretch scores every offset alike): take the earliest,
        so the clock does not follow the FFT library's rounding noise
        there (ROADMAP Queue 3)."""
        per_off = win.max(axis=1)
        tie = self.design.frames_per_char * TIE_PER_FRAME
        o = int(np.argmax(per_off >= per_off.max() - tie))
        return o, int(np.argmax(win[o]))

    @staticmethod
    def _baudot(code: int, ch: dict) -> str:
        if code == LTRS_CODE:
            ch["figs"] = False
            return ""
        if code == FIGS_CODE:
            ch["figs"] = True
            return ""
        table = BAUDOT_FIGS if ch["figs"] else BAUDOT_LTRS
        c = table[code]
        return c if c not in ("\x00", "\x0e", "\x0f") else ""


def synthesize_rtty(text: str, design: RTTYDesign, carrier_hz: float,
                    amplitude: float = 1.0, snr_db: float | None = None,
                    seed: int = 0) -> np.ndarray:
    """Generate a baudot FSK baseband signal for tests (the reference
    validates against recorded RTTY captures with known content, rtty:1-40)."""
    d = design
    ltrs = {c: i for i, c in enumerate(BAUDOT_LTRS)}
    figs = {c: i for i, c in enumerate(BAUDOT_FIGS)}
    bits = [1.0] * (4 * d.bits_per_char)  # idle mark
    in_figs = False
    for c in text.upper():
        if c in ltrs:
            if in_figs:
                code, in_figs = LTRS_CODE, False
                bits += [-1.0] + [(1.0 if (code >> b) & 1 else -1.0)
                                  for b in range(5)] + [1.0, 1.0]
            code = ltrs[c]
        elif c in figs:
            if not in_figs:
                code, in_figs = FIGS_CODE, True
                bits += [-1.0] + [(1.0 if (code >> b) & 1 else -1.0)
                                  for b in range(5)] + [1.0, 1.0]
            code = figs[c]
        else:
            continue
        bits += [-1.0] + [(1.0 if (code >> b) & 1 else -1.0)
                          for b in range(5)] + [1.0, 1.0]
    bits += [1.0] * (4 * d.bits_per_char)
    sig = np.repeat(bits, d.bit_len)
    f_dev = d.shift_hz / 2.0
    inst = carrier_hz - f_dev + (np.asarray(sig) * 0.5 + 0.5) * d.shift_hz
    phase = 2 * np.pi * np.cumsum(inst) / d.fs
    x = amplitude * np.exp(1j * phase)
    if snr_db is not None:
        rng = np.random.default_rng(seed)
        npow = amplitude ** 2 / (10 ** (snr_db / 10))
        x = x + np.sqrt(npow / 2) * (rng.standard_normal(len(x))
                                     + 1j * rng.standard_normal(len(x)))
    return x.astype(np.complex64)
