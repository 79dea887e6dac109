"""Channel-axis sharding for the ChannelizerBank (counterpart of
pysdr_tpu/parallel/chanshard.py).

The 64+-channel configuration (BASELINE config 5; generalization of the
reference's per-RX processes, am.py:85-114) shards over the 'ch' mesh axis
with no exchange in the hot path:

  * the raw RF block goes to every channel shard, and every shard runs
    the branch filter (the pfb_branch kernel on a card) on it;
  * the channel transform is the serial bank's `torch.fft.fft` over the
    branches, of which each shard keeps only its own channels' columns.
    The JAX package multiplies by its column slice of the DFT matrix
    instead (an (N, C_local) matmul, chosen for the TPU's matrix unit);
    the FFT's columns are the serial bank's own numbers, bit for bit, at
    the cost of the whole transform on every shard;
  * fine NCO / resampler / demod state and params are sliced on the
    leading channel axis and stay on the shard's device.

The only cross-device traffic is the copy of the input block to each
shard's device.
"""

from __future__ import annotations

import dataclasses
import warnings

import numpy as np
import torch

from pysdr_tpu_torch.device import map_tensors
from pysdr_tpu_torch.models.channelizer_bank import (ChanBankState,
                                                     ChannelizerBank)
from pysdr_tpu_torch.ops import channelizer as chan_ops
from pysdr_tpu_torch.ops import cplx
from pysdr_tpu_torch.ops import demod as demod_ops
from pysdr_tpu_torch.ops import resample
from pysdr_tpu_torch.parallel.mesh import Mesh
from pysdr_tpu_torch.parallel.stream import (StreamSplit, channel_slices,
                                             device_consts, on_device,
                                             shifted_base)


def _consts(cb: ChannelizerBank, mesh: Mesh) -> dict:
    """{device: (video_bank, carrier_taps, pilot_taps, branch_weights)}."""
    return device_consts(mesh, (cb.video_bank, cb.carrier_taps,
                                cb.pilot_taps, cb.branch_weights),
                         cb.demod_design)


def _line(mesh: Mesh, axis: str) -> list:
    """The local devices along `axis`: row 0's columns for "ch", column
    0's rows for "stream"."""
    if axis == "ch":
        return list(mesh.devices[0])
    if axis == "stream":
        return [row[0] for row in mesh.devices]
    raise ValueError(f"unknown mesh axis {axis!r} (stream or ch)")


def make_channelizer_processor(cb: ChannelizerBank, mesh: Mesh,
                               axis: str = "ch"):
    """A channel-sharded streaming step over the local devices of `axis`.

    Returns (process, slices) where
      process(states, x, params) -> (new_states, audio)
    with x a wire block (in_block, 2) (or complex64 (in_block,)) on any
    device, states / params one per shard (`shard_inputs` places them)
    and audio a tuple of one complex64 (N / shards, out_block) tensor a
    shard; `slices` are the channel rows of each shard.
    """
    n_sh = mesh.shape[axis]
    if cb.n_ch % n_sh:
        raise ValueError(f"the mesh '{axis}' axis ({n_sh}) must divide "
                         f"the channel count ({cb.n_ch})")
    cl = cb.n_ch // n_sh
    offset = mesh.ch_offset if axis == "ch" else mesh.stream_offset
    devs = _line(mesh, axis)
    slices = [slice((offset + i) * cl, (offset + i + 1) * cl)
              for i in range(len(devs))]
    consts = _consts(cb, mesh)

    def process(states, x, params):
        new_states, audio = [], []
        for dev, sl, st, p in zip(devs, slices, states, params):
            vb, ct, pt, bw = consts[dev]
            with on_device(dev):
                v, chan_hist = chan_ops.branch_filter(x.to(dev),
                                                      st.chan_hist, bw)
                y = chan_ops.channel_transform(v)[:, sl]   # (M, C_local)
                a, ph, rh, dst = cb.channel_chain(
                    y.T, st.nco_phase, st.rs_hist, st.demod, p,
                    consts=(vb, ct, pt))
            new_states.append(ChanBankState(chan_hist=chan_hist,
                                            nco_phase=ph, rs_hist=rh,
                                            demod=dst))
            audio.append(a)
        return new_states, tuple(audio)

    return process, slices


def shard_inputs(cb: ChannelizerBank, mesh: Mesh, slices,
                 axis: str = "ch"):
    """The bank's state and params, one slice a shard on its device (the
    raw RF tail whole on each). Returns (states, params), lists in shard
    order."""
    states, params = [], []
    for dev, sl in zip(_line(mesh, axis), slices):
        st = cb.state
        states.append(ChanBankState(
            chan_hist=st.chan_hist.to(dev),
            nco_phase=st.nco_phase[sl].to(dev),
            rs_hist=st.rs_hist[sl].to(dev),
            demod=map_tensors(lambda t: t[sl].to(dev), st.demod)))
        params.append(map_tensors(lambda t: t[sl].to(dev), cb.params))
    return states, params


def default_halo(cb: ChannelizerBank, settle_sec: float = 0.2) -> int:
    """Stream-axis halo in RF samples for the channelizer: covers the
    branch-filter history, the per-channel resampler history and AF
    warm-up mapped to the RF rate, plus recurrence settling; rounded to a
    multiple of N*down so channel/polyphase alignment is preserved."""
    n = cb.n_ch
    unit = n * cb.plan.down
    branch = chan_ops.history_len(cb.chan_design)
    af_rf = (cb.demod_design.af_taps + cb.demod_design.carrier_taps) \
        * cb.plan.down * n // cb.plan.up
    h = max(4 * branch, af_rf, int(settle_sec * cb.cfg.fs_in))
    return -(-h // unit) * unit


def channelizer_split(cb: ChannelizerBank, mesh: Mesh, seg: int,
                      halo: int | None = None,
                      audio_wire: str | None = None) -> StreamSplit:
    """The ChannelizerBank's StreamSplit (parallel/stream.py; the parts
    of make_channelizer_streaming_processor). The shard body runs the
    branch filter (pfb_branch on a card) over the shard's [halo |
    segment] from a zero history, the channel transform, keeps its own
    channels' columns and runs `cb.channel_chain` on them from a zero
    resampler history."""
    n = cb.n_ch
    unit = n * cb.plan.down
    if seg % unit:
        raise ValueError(f"segment {seg} is not a multiple of N*down={unit}")
    slices = channel_slices(n, mesh, "channel")
    if len(slices) != mesh.n_ch:
        raise ValueError("every channel shard of a stream row must be local")
    want = default_halo(cb) if halo is None else halo
    H = min(-(-want // unit) * unit, seg)
    if H < want:
        warnings.warn(
            f"stream segment ({seg} samples, "
            f"{seg / cb.cfg.fs_in * 1e3:.0f} ms) is shorter than the "
            f"recurrence-settle halo ({want / cb.cfg.fs_in * 1e3:.0f} "
            "ms): state only partially re-settles per call — use a "
            "larger --block", stacklevel=4)
    up, down = cb.plan.up, cb.plan.down
    aseg = seg * up // (down * n)
    ahalo = H * up // (down * n)
    m_seg, m_h = seg // n, H // n
    wire = cb.audio_wire if audio_wire is None else audio_wire
    kp1 = resample.history_len(up * cb.cfg.video_taps_per_phase, up)
    n_hist = chan_ops.history_len(cb.chan_design)
    consts = _consts(cb, mesh)

    def body(sh, inp):
        vb, ct, pt, bw = consts[sh.device]
        dev, sl = sh.device, sh.rows
        # the zero histories are device allocations (inside a capture,
        # of the graph's pool), never a host tensor copied up
        hist0 = torch.zeros(n_hist, dtype=torch.complex64, device=dev)
        v, _ = chan_ops.branch_filter(inp.xe, hist0, bw)
        y = chan_ops.channel_transform(v)[:, sl]
        p = inp.params
        ph = shifted_base(p.nco_k, inp.nco_base, m_seg, m_h, sh.stream)
        b0 = shifted_base(p.demod.bfo_k, inp.bfo_base, aseg, ahalo,
                          sh.stream)
        rh0 = torch.zeros((sl.stop - sl.start, kp1), dtype=torch.complex64,
                          device=dev)
        a, _, _, new_d = cb.channel_chain(
            y.T, ph, rh0, dataclasses.replace(inp.dstate, bfo_phase=b0), p,
            consts=(vb, ct, pt))
        audio = cplx.quantize_audio_wire(
            torch.view_as_real(a[:, ahalo:]).contiguous(), wire)
        return audio, None, new_d

    return StreamSplit(mesh, seg, H, slices, m_seg, aseg, body)


def make_channelizer_streaming_processor(cb: ChannelizerBank, mesh: Mesh,
                                         seg: int,
                                         halo: int | None = None,
                                         audio_wire: str | None = None):
    """State-continuous repeated-call form of the 2-D stream x ch
    channelizer (see parallel/stream.make_streaming_processor for the
    carried-state rationale): shard 0's halo comes from the previous
    super-block's RF tail, shard s > 0's from the segment to its left;
    per-channel fine-NCO/BFO phase bases advance across calls; the demod
    recurrence state (AGC envelope, squelch latch, mute hold) carries
    from the last stream shard; the audio wire (i16/i8 mu-law) is applied
    inside each shard. The call is channelizer_split's head, shard bodies
    and tail.

    Returns (process, halo) with
      process(x, params, tail_prev, nco_base, bfo_base, dstate)
        -> (audio, new_nco_base, new_bfo_base, new_tail, new_dstate)
    x: a wire block (S_local*seg, 2) on the mesh's first device; params:
    cb.params; dstate: a DemodState of n_ch rows (seed with
    cb.state.demod); audio: a tuple of one (n_ch / C, seg*up/(down*N), 2)
    wire-dtype tensor a shard, in grid order. (The JAX form also takes
    the DFT factors w_re, w_im; the FFT needs none.)
    """
    split = channelizer_split(cb, mesh, seg, halo, audio_wire)

    def process(x, params, tail_prev, nco_base, bfo_base, dstate):
        outs, *carried = split.process(x, params, tail_prev, nco_base,
                                       bfo_base, dstate)
        return (tuple(o.audio for o in outs), *carried)

    return process, split.halo


def make_channelizer_stream_processor(cb: ChannelizerBank, mesh: Mesh,
                                      seg: int, halo: int | None = None):
    """2-D stream x ch sharding of the channelizer, one-shot: every call
    starts cold (zero halo at shard 0, phases from 0, the demod's initial
    state), like the first call of the streaming form.

    Returns (process, halo), process(x, params) -> a tuple of one
    complex64 (n_ch / C, seg*up/(down*N)) tensor a shard, in grid
    order."""
    unit = cb.n_ch * cb.plan.down
    want = default_halo(cb) if halo is None else halo
    proc, H = make_channelizer_streaming_processor(
        cb, mesh, seg, min(-(-want // unit) * unit, seg), audio_wire="f32")
    first = mesh.first

    def process(x, params):
        zeros = torch.zeros(cb.n_ch, dtype=torch.int64, device=first)
        audio = proc(x, params,
                     torch.zeros((H, 2), dtype=torch.float32, device=first),
                     zeros, zeros,
                     demod_ops.init_state(cb.demod_design, cb.n_ch, first))[0]
        return tuple(torch.view_as_complex(a) for a in audio)

    return process, H


def run_sharded(cb: ChannelizerBank, x, mesh: Mesh, n_blocks: int = 1,
                axis: str = "ch"):
    """Convenience: process `n_blocks` consecutive blocks of host complex
    IQ through the sharded channelizer. Returns host complex64 (channels
    of the local shards, n_blocks*out_block)."""
    proc, slices = make_channelizer_processor(cb, mesh, axis)
    states, params = shard_inputs(cb, mesh, slices, axis)
    first = _line(mesh, axis)[0]
    outs = []
    for b in np.split(np.asarray(x), n_blocks):
        xb = torch.from_numpy(np.ascontiguousarray(
            b.astype(np.complex64).view(np.float32).reshape(-1, 2)))
        states, audio = proc(states, xb.to(first), params)
        outs.append(torch.cat([a.cpu() for a in audio]).numpy())
    return np.concatenate(outs, axis=-1)
