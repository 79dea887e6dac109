"""Stream-axis (time) parallelism: overlap-discard with halo exchange
(counterpart of pysdr_tpu/parallel/stream.py).

The reference processes blocks strictly serially because FIR/NCO/AGC state
carries across chunk boundaries (SURVEY.md §2.10, sigs/iir.py:83-105).
Here a long IQ stream is cut into S contiguous segments, one per 'stream'
mesh row; each segment is processed with

  * an RF *halo* of H samples, the last H samples of the segment to its
    left, copied to its shard's device (the JAX package's `lax.ppermute`
    inside `shard_map`; across torch.distributed ranks a send/recv) —
    this warms up every FIR history (resampler Kp-1, AF/carrier/pilot
    taps) and settles the exponential-memory recurrences (AGC, DC,
    de-emphasis) before the segment proper begins; the warm-up audio is
    discarded;
  * an *analytic* NCO phase: the LO phase at sample index m is
    (k*m) mod DENOM — a pure function of position (ops/nco.py), so no
    serial dependency crosses shards at all (the CW BFO likewise, at the
    audio rate).

One process issues every shard, each on the current stream of its
device, in grid order; on one card the shards run in turn on one stream.
The scan kernels' look-back state is kept per (device, stream)
(kernels/scan.py), so shards issued on one stream from this one thread
take their tiles' epochs in order.
"""

from __future__ import annotations

import contextlib
import dataclasses
import warnings

import numpy as np
import torch

from pysdr_tpu_torch.device import map_tensors
from pysdr_tpu_torch.ops import cplx
from pysdr_tpu_torch.ops import demod as demod_ops
from pysdr_tpu_torch.ops import nco, resample
from pysdr_tpu_torch.parallel.mesh import Mesh, Shard, gather, shards


def default_halo(design, settle_sec: float = 0.2) -> int:
    """Halo length in RF samples: covers the resampler history, the AF-
    filter warm-up mapped back to RF rate, and `settle_sec` of recurrence
    settling; rounded up to a multiple of DOWN so polyphase alignment is
    preserved. 0.2 s covers the slowest always-on recurrence (the DC
    blocker, tau ~14 ms) with margin; with AGC enabled the envelope
    tracker's decay (~1 s) is only approximately settled — acceptable
    because AGC gain varies slowly by design (audio-SNR-level match)."""
    kp = resample.taps_per_phase(design.video_taps, design.up)
    af_rf = (design.demod.af_taps + design.demod.carrier_taps) \
        * design.down // design.up
    h = max(4 * kp, af_rf, int(settle_sec * design.fs_in))
    return -(-h // design.down) * design.down


def on_device(dev: torch.device):
    """The context that issues a shard's work on its device's current
    stream."""
    return (torch.cuda.device(dev) if dev.type == "cuda"
            else contextlib.nullcontext())


def channel_slices(n_items: int, mesh: Mesh, what: str) -> list:
    """Rows of the channel axis each local column of the mesh owns."""
    n_ch = mesh.n_ch
    if n_items % n_ch:
        raise ValueError(f"the mesh 'ch' axis ({n_ch}) must divide the "
                         f"{what} count ({n_items})")
    cl = n_items // n_ch
    return [slice((mesh.ch_offset + c) * cl, (mesh.ch_offset + c + 1) * cl)
            for c in range(len(mesh.devices[0]))]


def device_consts(mesh: Mesh, tensors, demod_design) -> dict:
    """{device: the tensors on it} for every device of the grid; the
    demod's scan constants go to each device now, not in a step."""
    out = {}
    for row in mesh.devices:
        for dev in row:
            if dev not in out:
                out[dev] = tuple(t.to(dev) for t in tensors)
                demod_ops.scan_constants(demod_design, dev)
    return out


def shifted_base(k, base, unit: int, back: int, s: int) -> torch.Tensor:
    """(base + k*(s*unit - back)) mod DENOM: the phase at the start of
    stream shard s's halo. nco.mul_mod keeps every product exact for ANY
    shard index (the JAX package's int32 discipline, bit for bit), and
    takes python ints as kernel arguments, so a CUDA graph captures it."""
    return (base + nco.mul_mod(nco.mul_mod(k, unit), s)
            - nco.mul_mod(k, back) + nco.DENOM) % nco.DENOM


def left_halos(segs: list, tail_prev: torch.Tensor, halo: int,
               mesh: Mesh) -> list:
    """The left halo of each local stream row: the carried tail at global
    row 0, else the last `halo` samples of the segment to the left — from
    the rank to the left by torch.distributed send/recv where that
    segment lives on another process."""
    lefts = [tail_prev] + [sg[-halo:] for sg in segs[:-1]]
    if mesh.world > 1:
        import torch.distributed as dist
        req = None
        if mesh.rank < mesh.world - 1:
            req = dist.isend(segs[-1][-halo:].contiguous(), mesh.rank + 1)
        if mesh.rank > 0:
            buf = torch.empty_like(segs[0][-halo:])
            dist.recv(buf, mesh.rank - 1)
            lefts[0] = buf
        if req is not None:
            req.wait()
    return lefts


def from_last_rank(mesh: Mesh, tensors):
    """The last stream row's carried values on every rank: broadcast from
    the last rank (a no-op in one process). `tensors`: a tensor or a
    dataclass of them, valid on the last rank and of the right shapes on
    every other."""
    if mesh.world == 1:
        return tensors
    import torch.distributed as dist

    def bcast(t):
        t = t.clone(memory_format=torch.contiguous_format)  # not in place
        dist.broadcast(t, mesh.world - 1)
        return t
    return map_tensors(bcast, tensors)


def cat_rows(parts: list, dev: torch.device):
    """Stack the channel rows of per-shard tensors or dataclasses on dev."""
    first = parts[0]
    if isinstance(first, torch.Tensor):
        return torch.cat([p.to(dev) for p in parts], dim=0)
    return type(first)(**{f.name: cat_rows([getattr(p, f.name)
                                            for p in parts], dev)
                          for f in dataclasses.fields(first)})


@dataclasses.dataclass
class ShardIn:
    """A shard's inputs: its RF [left halo | segment] as float32 (H +
    seg, 2) pairs, and its rows of the params, of the carried NCO and BFO
    phase bases and of the carried demod state, all on its device."""
    xe: torch.Tensor
    params: object
    nco_base: torch.Tensor
    bfo_base: torch.Tensor
    dstate: object


@dataclasses.dataclass
class ShardOut:
    """A shard's outputs: its audio wire piece, its baseband piece (or
    None), and its new demod state rows where they are carried (a shard
    of the last stream row), else None."""
    audio: torch.Tensor
    bb: torch.Tensor | None
    dstate: object


class StreamSplit:
    """A state-continuous sharded processor in its three parts, the same
    for the stream and the channelizer forms:

      (a) `head`: the wire block dequantized and cut into the local
          rows' segments, each with its left halo (left_halos' send/recv
          across ranks); `shard_in` then gives each shard its inputs;
      (b) `body(shard, inputs)`: the shard's device work, from its
          inputs to its outputs — what a CUDA graph of the shard
          captures (parallel/adapter.py);
      (c) `tail`: the carried values of the next call: the last stream
          row's demod state rows stacked, the new RF tail, the phase
          bases advanced (from_last_rank's broadcasts across ranks).

    `process` composes them into the functional processor; the adapters
    run the same parts over static buffers."""

    def __init__(self, mesh: Mesh, seg: int, halo: int, slices,
                 nco_unit: int, bfo_unit: int, body):
        self.mesh = mesh
        self.seg = seg
        self.halo = halo
        self.shards = shards(mesh, slices)
        self.last_row = \
            mesh.stream_offset + len(mesh.devices) == mesh.n_stream
        self._nco_unit = mesh.n_stream * nco_unit
        self._bfo_unit = mesh.n_stream * bfo_unit
        self._body = body

    def carries(self, sh: Shard) -> bool:
        """Whether shard sh's new demod state is carried to the next call
        (it is on the grid's last stream row)."""
        return self.last_row and sh.row == len(self.mesh.devices) - 1

    def head(self, x, tail_prev):
        """(a) x: the wire block (S_local*seg, 2) -> (the dequantized
        block, [(left halo, segment)] a local row)."""
        # int8/int16 wire blocks dequantize BEFORE the halo exchange, so
        # the carried tail and the halo copies stay f32
        xs = cplx.dequantize(x)
        seg = self.seg
        segs = [xs[r * seg:(r + 1) * seg]
                for r in range(len(self.mesh.devices))]
        return xs, list(zip(left_halos(segs, tail_prev, self.halo,
                                       self.mesh), segs))

    def shard_in(self, sh: Shard, pieces, params, nco_base, bfo_base,
                 dstate) -> ShardIn:
        """Shard sh's inputs as new tensors on its device."""
        dev = sh.device
        left, seg = pieces[sh.row]

        def rows(t):
            return t[sh.rows].to(dev)
        return ShardIn(xe=torch.cat([left.to(dev), seg.to(dev)]),
                       params=map_tensors(rows, params),
                       nco_base=rows(nco_base), bfo_base=rows(bfo_base),
                       dstate=map_tensors(rows, dstate))

    def body(self, sh: Shard, inp: ShardIn) -> ShardOut:
        """(b) Shard sh's work on its device's current stream."""
        with on_device(sh.device):
            audio, bb, new_d = self._body(sh, inp)
        return ShardOut(audio=audio, bb=bb,
                        dstate=new_d if self.carries(sh) else None)

    def tail(self, xs, outs, params, tail_prev, nco_base, bfo_base,
             dstate):
        """(c) -> (nco_base, bfo_base, tail, dstate) of the next call, on
        the mesh's first device."""
        first, mesh = self.mesh.first, self.mesh
        last = [o.dstate for o in outs if o.dstate is not None]
        new_tail = from_last_rank(
            mesh, xs[-self.halo:].clone() if self.last_row else tail_prev)
        new_dstate = from_last_rank(
            mesh, cat_rows(last, first) if last else dstate)
        # cross-call state advances: pure elementwise
        new_nb = nco.advance(params.nco_k, nco_base, self._nco_unit)
        new_bb = nco.advance(params.demod.bfo_k, bfo_base, self._bfo_unit)
        return new_nb.to(first), new_bb.to(first), new_tail, new_dstate

    def process(self, x, params, tail_prev, nco_base, bfo_base, dstate):
        """One call, functional: (shard outputs in grid order, nco_base,
        bfo_base, tail, dstate of the next call)."""
        xs, pieces = self.head(x, tail_prev)
        outs = [self.body(sh, self.shard_in(sh, pieces, params, nco_base,
                                            bfo_base, dstate))
                for sh in self.shards]
        return (outs, *self.tail(xs, outs, params, tail_prev, nco_base,
                                 bfo_base, dstate))


def stream_split(bank, mesh: Mesh, seg: int, halo: int | None = None,
                 audio_wire: str | None = None,
                 emit_bb: bool | None = None) -> StreamSplit:
    """The ReceiverBank's StreamSplit (make_streaming_processor's
    parts); the shard body is the bank's mix + resample, demod_block and
    the audio-wire quantize, over the shard's [halo | segment]."""
    design = bank.design
    d, u = design.down, design.up
    if seg % d:
        raise ValueError(f"segment {seg} is not a multiple of down={d}")
    want = default_halo(design) if halo is None else halo
    H = min(want, seg)
    if seg < want:
        warnings.warn(
            f"stream segment ({seg} samples, {seg / design.fs_in * 1e3:.0f}"
            f" ms) is shorter than the recurrence-settle halo "
            f"({want / design.fs_in * 1e3:.0f} ms): AGC/DC/squelch state "
            "will only partially re-settle per call — use a larger --block",
            stacklevel=4)
    if H % d:
        raise ValueError(f"halo {H} is not a multiple of down={d}")
    slices = channel_slices(bank.n_rx, mesh, "receiver")
    if len(slices) != mesh.n_ch:
        raise ValueError("every channel shard of a stream row must be local")
    out_halo = H * u // d
    aseg = seg * u // d
    wire = bank.audio_wire if audio_wire is None else audio_wire
    if emit_bb is None:
        emit_bb = bank.emit_baseband
    kp1 = resample.history_len(design.video_taps, u)
    consts = device_consts(mesh, (bank.video_bank, bank.carrier_taps,
                                  bank.pilot_taps), design.demod)

    def body(sh, inp):
        vb, ct, pt = consts[sh.device]
        p = inp.params
        k = p.nco_k
        xe = torch.view_as_complex(inp.xe)
        p0 = shifted_base(k, inp.nco_base, seg, H, sh.stream)
        p0m = nco.advance((nco.DENOM - k) % nco.DENOM, p0, kp1)
        bb = resample.mixed_resample_bank(
            xe, xe.new_zeros(kp1), vb[p.video_row], k, p0m, up=u, down=d)
        b0 = shifted_base(p.demod.bfo_k, inp.bfo_base, aseg, out_halo,
                          sh.stream)
        a, new_d = demod_ops.demod_block(
            bb, dataclasses.replace(inp.dstate, bfo_phase=b0), p.demod,
            design.demod, ct, pt)
        audio = cplx.quantize_audio_wire(
            torch.view_as_real(a[:, out_halo:]).contiguous(), wire)
        return (audio, bb[:, out_halo:].contiguous() if emit_bb else None,
                new_d)

    return StreamSplit(mesh, seg, H, slices, seg, aseg, body)


def make_streaming_processor(bank, mesh: Mesh, seg: int,
                             halo: int | None = None,
                             audio_wire: str | None = None,
                             emit_bb: bool | None = None):
    """State-continuous repeated-call form of the sharded processor.

    It carries the real cross-call state:

      * the RF tail of the previous super-block becomes shard 0's left
        halo (shards s>0 take theirs from the segment to their left) —
        FIR/resampler histories are then EXACT everywhere after the very
        first call, and the recurrence warm-up sees real signal;
      * per-channel NCO/BFO phase bases advance across calls, so LO and
        beat phases are continuous over arbitrarily long streams (and
        across retunes, matching the serial bank's phase behavior);
      * the full per-channel demod recurrence state (AGC envelope,
        squelch latch + envelopes, auto-mute hold, DC blocker,
        de-emphasis) from the LAST stream shard seeds every shard's next
        call. Within a super-block shard s still runs from state that is
        s segments stale — the one remaining stream-parallel
        approximation, bounded by the tests' AGC-on SNR floor (SURVEY
        §2.10 row 4).

    The audio wire (i16/i8, ops/cplx.quantize_audio_wire) is applied
    INSIDE each shard, so the device->host return ships the small ints;
    with emit_bb each shard's baseband is returned too, for the RTTY tap.
    The call is stream_split's head, shard bodies and tail.

    Returns (process, halo) with
      process(x, params, tail_prev, nco_base, bfo_base, dstate)
        -> (audio, new_nco_base, new_bfo_base, new_tail, new_dstate, bb)
    x: a float32 / int16 / int8 (S_local*seg, 2) wire block of this
    process's segments, on the mesh's first device; params: bank.params;
    tail_prev: float32 (halo, 2) (zeros on the first call); nco_base /
    bfo_base: int64 (n_rx,) phase bases (zeros initially); dstate: a
    DemodState of n_rx rows (seed with bank.state.ch.demod). audio: a
    tuple of one (n_rx / C, seg*up/down, 2) wire-dtype tensor a shard, in
    grid order; bb: such a tuple of complex64 (n_rx / C, seg*up/down), or
    None. The carried values come back on the mesh's first device.
    """
    split = stream_split(bank, mesh, seg, halo, audio_wire, emit_bb)

    def process(x, params, tail_prev, nco_base, bfo_base, dstate):
        outs, *carried = split.process(x, params, tail_prev, nco_base,
                                       bfo_base, dstate)
        bbs = tuple(o.bb for o in outs)
        return (tuple(o.audio for o in outs), *carried,
                None if bbs[0] is None else bbs)

    return process, split.halo


def make_stream_processor(bank, mesh: Mesh, seg: int,
                          halo: int | None = None):
    """One-shot sharded processor for a fixed segment length: every call
    starts cold (shard 0's halo zeros, phases from 0, the demod's initial
    state), like the first call of make_streaming_processor.

    Returns (process, halo), process(x, params) -> a tuple of one
    complex64 (n_rx / C, seg*up/down) audio tensor a shard, in grid
    order; x: float32 (S*seg, 2) pairs (or a wire block) on the mesh's
    first device."""
    want = default_halo(bank.design) if halo is None else halo
    proc, H = make_streaming_processor(bank, mesh, seg, min(want, seg),
                                       audio_wire="f32", emit_bb=False)
    first = mesh.first

    def process(x, params):
        n = bank.n_rx
        zeros = torch.zeros(n, dtype=torch.int64, device=first)
        audio = proc(x, params,
                     torch.zeros((H, 2), dtype=torch.float32, device=first),
                     zeros, zeros,
                     demod_ops.init_state(bank.design.demod, n, first))[0]
        return tuple(torch.view_as_complex(a) for a in audio)

    return process, H


def process_stream(bank, x, mesh: Mesh, halo: int | None = None):
    """Convenience one-shot: cut a long host IQ array into the mesh's
    stream segments and process it. len(x) must divide evenly into stream
    shards with segments that are multiples of DOWN. Returns host
    complex64 (n_rx, len(x)*up/down)."""
    n_stream = mesh.n_stream
    x = np.asarray(x)
    if x.shape[0] % n_stream:
        raise ValueError(f"{x.shape[0]} samples do not split into "
                         f"{n_stream} segments")
    proc, _ = make_stream_processor(bank, mesh, x.shape[0] // n_stream, halo)
    xp = torch.from_numpy(np.ascontiguousarray(
        x.astype(np.complex64).view(np.float32).reshape(-1, 2)))
    return gather(proc(xp.to(mesh.first), bank.params), mesh).numpy()
