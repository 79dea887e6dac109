"""Executive-compatible adapters that run a bank across a device grid
(counterpart of pysdr_tpu/parallel/adapter.py).

The streaming executive (runtime/executive.py) drives any bank through a
small facade: `design.{fs_in,fs_out,in_block,out_block}`, `n_rx`,
`device`, `prepare`, `step_device(x) -> audio wire`, `audio_from_wire`,
`baseband_from_wire` and the block-boundary control methods. These
adapters present that facade over the STATE-CONTINUOUS sharded processors
(parallel/stream.py stream_split, parallel/chanshard.py
channelizer_split), so the CLI (`--mesh S,C`, app.py) processes a replay
across devices with audio that matches the serial path block after
block:

  * each executive block is one SUPER-block of S segments, one per
    'stream' mesh row (in_block = S x the serial block), uploaded to the
    first shard's device; the head dequantizes it and copies each
    shard's [left halo | segment] into the shard's static input;
  * each shard's body runs over static buffers: on a card (graph=True)
    it is captured once as a CUDA graph by `prepare` and replayed every
    call, one graph a shard (the JAX package's `jax.jit(proc_impl)` over
    `shard_map`); graph=False, and the CPU always, run the same body
    eagerly over the same buffers. Between the replays the host issues
    only the copies between shards (the head's and the tail's);
  * the step returns one audio wire piece a shard, a static output the
    next call overwrites: the executive copies each to the host right
    after dispatch (executive.start_host_copy), and the baseband pieces
    are copied out (_last_bb); audio_from_wire puts the pieces together;
  * the carried state is the adapter's own static tensors: FIR/resampler
    state crosses calls exactly (the previous super-block's RF tail
    feeds shard 0's halo); NCO/BFO phases are continuous via carried
    per-channel bases; exponential recurrences (AGC/DC/squelch)
    re-settle inside each shard's halo — the documented approximation
    of stream parallelism (SURVEY §2.10 row 4);
  * control methods delegate to the wrapped bank, which copies into its
    params: a shard on the params' device reads views of them, any other
    shard gets its rows copied by the head, so retune/mode/gain changes
    posted through the executive's command queue apply at the next
    super-block exactly like the serial path. Rebinding the params or
    the carried state after `prepare` raises at the next call.

A grid over distinct cards, or over torch.distributed ranks, runs the
same per-shard graphs with peer copies (ordered against both cards'
current streams by copy_) and collectives between them: written, not
yet run on several cards.
"""

from __future__ import annotations

import dataclasses
import types

import numpy as np
import torch

from pysdr_tpu_torch.device import (copy_tensors, leaves, map_tensors,
                                    resolve_device)
from pysdr_tpu_torch.models.graphstep import (Captured, capture,
                                              check_bound, empty_like)
from pysdr_tpu_torch.ops import cplx
from pysdr_tpu_torch.parallel import chanshard as chanshard_mod
from pysdr_tpu_torch.parallel import mesh as mesh_mod
from pysdr_tpu_torch.parallel import stream as stream_mod
from pysdr_tpu_torch.parallel.stream import ShardIn, ShardOut, on_device

_BOUND = "the bank's params or the adapter's carried state"


def build_mesh(n_stream: int, n_ch: int, device="cuda") -> mesh_mod.Mesh:
    """The grid `--mesh S,C` runs on: S*C distinct visible cards on cuda,
    or the one CPU device S*C times on `--device cpu` (the counterpart of
    the JAX package's virtual CPU devices). Raises ValueError with an
    operator's message when the host cannot hold the grid."""
    dev = resolve_device(device)
    if n_stream < 1 or n_ch < 1:
        raise ValueError(f"--mesh {n_stream},{n_ch}: both axes must be >= 1")
    if dev.type == "cpu":
        return mesh_mod.make_mesh(n_stream, n_ch,
                                  devices=[dev] * (n_stream * n_ch))
    have = torch.cuda.device_count()
    if have < n_stream * n_ch:
        raise ValueError(
            f"--mesh {n_stream},{n_ch} needs {n_stream * n_ch} devices "
            f"but only {have} are available (emulate the grid on the CPU "
            "with --device cpu)")
    return mesh_mod.make_mesh(n_stream=n_stream, n_ch=n_ch)


def _rows_on(obj, sh: mesh_mod.Shard, loads: list):
    """Shard sh's rows of `obj` (a tensor or a dataclass of them) as
    static inputs: a view where a tensor lies on the shard's device, else
    a buffer there, recorded in `loads` with its source rows for the
    head's copy."""
    def take(t):
        rows = t[sh.rows]
        if t.device == sh.device:
            return rows
        buf = torch.empty_like(rows, device=sh.device)
        loads.append((buf, rows))
        return buf
    return map_tensors(take, obj)


@dataclasses.dataclass
class _Static:
    """One shard's static inputs, the copies the head makes into them,
    its static outputs and, on a card with graph=True, its graph."""
    inp: ShardIn
    loads: list
    outs: ShardOut | None = None
    captured: Captured | None = None


class _ShardedBank:
    """The executive facade over a StreamSplit, shared by both adapters.
    The subclass sets `bank`, `mesh`, `design` and calls _own_state."""

    def _own_state(self, split: stream_mod.StreamSplit, n: int, dstate,
                   graph: bool) -> None:
        first = self.mesh.first
        self._split = split
        self.halo = split.halo
        self._graph = bool(graph) and first.type == "cuda"
        self._tail = torch.zeros((self.halo, 2), dtype=torch.float32,
                                 device=first)
        self._nb = torch.zeros(n, dtype=torch.int64, device=first)
        self._bb = torch.zeros(n, dtype=torch.int64, device=first)
        # carried per-channel demod recurrence state (AGC env, squelch
        # latch, mute hold, ...) seeded from the serial bank's init
        # state: the adapter's own copy, which the tail writes into
        self._dstate = map_tensors(lambda t: t.to(first, copy=True), dstate)
        self._static = None
        self._bound = ()
        self._last_bb = None

    @property
    def n_rx(self) -> int:
        return self.bank.n_rx

    @property
    def device(self) -> torch.device:
        """The first shard's device: the executive uploads there."""
        return self.mesh.first

    @property
    def graph_count(self) -> int:
        """CUDA graphs captured: one a shard once prepared on a card."""
        return sum(st.captured is not None for st in self._static or ())

    def _tensors(self) -> tuple:
        return (*leaves(self.bank.params), self._tail, self._nb, self._bb,
                *leaves(self._dstate))

    def prepare(self, dtype, in_block) -> None:
        """Make every shard's static inputs and outputs and, on a card
        with graph=True, capture each shard's body as a CUDA graph: before
        any other thread works on the card (the executive calls it before
        its prefetch thread starts); a no-op once done. The buffers are
        float32 after the head's dequantize, the same for every wire."""
        if int(in_block) != self.design.in_block:
            raise ValueError(f"in_block {in_block}: the adapter takes "
                             f"{self.design.in_block}-sample super-blocks")
        if self._static is None:
            self._static = [self._make(sh) for sh in self._split.shards]
            self._bound = self._tensors()

    def _make(self, sh: mesh_mod.Shard) -> _Static:
        loads = []
        split = self._split
        inp = ShardIn(
            xe=torch.zeros((self.halo + split.seg, 2), dtype=torch.float32,
                           device=sh.device),
            params=_rows_on(self.bank.params, sh, loads),
            nco_base=_rows_on(self._nb, sh, loads),
            bfo_base=_rows_on(self._bb, sh, loads),
            dstate=_rows_on(self._dstate, sh, loads))
        st = _Static(inp=inp, loads=loads)

        def body():
            return split.body(sh, inp)
        if self._graph:
            st.captured, st.outs = capture(
                sh.device, body, lambda outs: copy_tensors(outs, body()),
                self._tensors, what=_BOUND)
        else:
            st.outs = empty_like(body())
        return st

    def step_device(self, x_p):
        """x_p: a float32 / int16 / int8 (S*seg, 2) wire block on
        self.device. The head's copies, each shard's body or replay in
        grid order, the tail's copies into the carried state. Returns one
        audio wire piece a shard (static outputs, valid until the next
        call); each shard's baseband is copied out into _last_bb when the
        bank emits it (the RTTY tap)."""
        if x_p.dim() != 2 or x_p.shape[1] != 2:
            raise ValueError(f"x_p: expected (n, 2) pairs, got "
                             f"{tuple(x_p.shape)}")
        self.prepare(x_p.dtype, x_p.shape[0])
        check_bound(self._tensors(), self._bound, _BOUND)
        split, H = self._split, self.halo
        xs, pieces = split.head(x_p, self._tail)
        for sh, st in zip(split.shards, self._static):
            left, seg = pieces[sh.row]
            st.inp.xe[:H].copy_(left)
            st.inp.xe[H:].copy_(seg)
            for buf, rows in st.loads:
                buf.copy_(rows)
        for sh, st in zip(split.shards, self._static):
            if st.captured is None:
                copy_tensors(st.outs, split.body(sh, st.inp))
            else:
                with on_device(sh.device):
                    st.captured.replay()
        outs = [st.outs for st in self._static]
        carried = split.tail(xs, outs, self.bank.params, self._tail,
                             self._nb, self._bb, self._dstate)
        for dst, src in zip((self._nb, self._bb, self._tail, self._dstate),
                            carried):
            copy_tensors(dst, src)
        self._last_bb = (tuple(o.bb.clone() for o in outs)
                         if outs[0].bb is not None else None)
        return tuple(o.audio for o in outs)

    def audio_from_wire(self, pieces) -> np.ndarray:
        """The pieces of a super-block (host copies or device tensors) ->
        host complex64 (n_rx, out_block)."""
        q = mesh_mod.gather(pieces, self.mesh).numpy()     # a new array
        return np.ascontiguousarray(cplx.dequantize_audio_host(q)) \
            .view(np.complex64)[..., 0]

    def baseband_from_wire(self, pieces) -> torch.Tensor:
        """The baseband pieces of a super-block -> complex64 (n_rx,
        out_block) on the first shard's device (the RTTY decoder's)."""
        return mesh_mod.gather(pieces, self.mesh, self.mesh.first)

    # control plane: delegate everything else (set_mode, retune,
    # set_af_gain, set_squelch, params, cfg, ...) to the wrapped bank
    def __getattr__(self, name):
        return getattr(self.bank, name)

    # attributes the adapter owns; everything else the wrapped bank
    # already has is written THROUGH (a read-only facade silently
    # swallowed writes like `adapter.on_device_retune = cb` — the trap
    # the JAX package's app.py once had to work around). The JAX form
    # also owns _w_re/_w_im, DFT factors the port's FFT does not need.
    _OWN_ATTRS = frozenset({
        "bank", "mesh", "halo", "design", "_s", "_split", "_graph",
        "_tail", "_nb", "_bb", "_dstate", "_static", "_bound",
        "_last_bb"})

    def __setattr__(self, name, value):
        bank = self.__dict__.get("bank")
        if name in self._OWN_ATTRS or bank is None \
                or not hasattr(bank, name):
            object.__setattr__(self, name, value)
        else:
            setattr(bank, name, value)


class ShardedStreamBank(_ShardedBank):
    """ReceiverBank across a stream x ch grid, executive-compatible.
    `graph` (a card only): replay each shard's body as a CUDA graph (the
    default) or run it eagerly, for comparisons."""

    def __init__(self, bank, mesh: mesh_mod.Mesh, halo: int | None = None,
                 graph: bool = True):
        # own attributes (writes to anything else forward to the bank —
        # see __setattr__)
        object.__setattr__(self, "bank", bank)
        self.mesh = mesh
        d = bank.design
        self._s = mesh.n_stream
        seg = d.in_block
        split = stream_mod.stream_split(bank, mesh, seg, halo)
        aseg = seg * d.up // d.down
        self.design = types.SimpleNamespace(
            fs_in=d.fs_in, fs_out=d.fs_out, up=d.up, down=d.down,
            in_block=self._s * seg, out_block=self._s * aseg)
        self._own_state(split, bank.n_rx, bank.state.ch.demod, graph)


class ShardedChannelizerBank(_ShardedBank):
    """ChannelizerBank across a stream x ch grid, executive-compatible.

    With n_stream == 1 this still goes through the streaming processor
    (carried tail + phase bases), giving a pure channel-sharded bank
    whose FIR state is exact across calls. `graph` as for
    ShardedStreamBank."""

    def __init__(self, cb, mesh: mesh_mod.Mesh, halo: int | None = None,
                 graph: bool = True):
        object.__setattr__(self, "bank", cb)
        self.mesh = mesh
        self._s = mesh.n_stream
        seg = cb.design.in_block
        split = chanshard_mod.channelizer_split(cb, mesh, seg, halo)
        self.design = types.SimpleNamespace(
            fs_in=cb.cfg.fs_in, fs_out=cb.plan.fs_out,
            up=cb.plan.up, down=cb.plan.down,
            in_block=self._s * seg,
            out_block=self._s * cb.design.out_block)
        self._own_state(split, cb.n_ch, cb.state.demod, graph)
