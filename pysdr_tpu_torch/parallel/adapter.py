"""Executive-compatible adapters that run a bank across a device grid
(counterpart of pysdr_tpu/parallel/adapter.py).

The streaming executive (runtime/executive.py) drives any bank through a
small facade: `design.{fs_in,fs_out,in_block,out_block}`, `n_rx`,
`device`, `step_device(x) -> audio wire`, `audio_from_wire`,
`baseband_from_wire` and the block-boundary control methods. These
adapters present that facade over the STATE-CONTINUOUS sharded processors
(parallel/stream.py make_streaming_processor, parallel/chanshard.py
make_channelizer_streaming_processor), so the CLI (`--mesh S,C`, app.py)
processes a replay across devices with audio that matches the serial path
block after block:

  * each executive block is one SUPER-block of S segments, one per
    'stream' mesh row (in_block = S x the serial block), uploaded to the
    first shard's device; the processor moves each segment to its shards
    (on one card, a no-op);
  * the step returns one audio wire piece a shard, and the executive
    copies each to the host with one event a device
    (executive.start_host_copy); the adapter's audio_from_wire puts the
    pieces back together;
  * FIR/resampler state crosses calls exactly (the previous super-block's
    RF tail feeds shard 0's halo); NCO/BFO phases are continuous via
    carried per-channel bases; exponential recurrences (AGC/DC/squelch)
    re-settle inside each shard's halo — the documented approximation of
    stream parallelism (SURVEY §2.10 row 4);
  * control methods delegate to the wrapped bank: the processors read
    `bank.params` every call, so retune/mode/gain changes posted through
    the executive's command queue apply at the next super-block exactly
    like the serial path.
"""

from __future__ import annotations

import types

import numpy as np
import torch

from pysdr_tpu_torch.device import resolve_device
from pysdr_tpu_torch.ops import cplx
from pysdr_tpu_torch.parallel import chanshard as chanshard_mod
from pysdr_tpu_torch.parallel import mesh as mesh_mod
from pysdr_tpu_torch.parallel import stream as stream_mod


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


class ShardedStreamBank:
    """ReceiverBank across a stream x ch grid, executive-compatible."""

    def __init__(self, bank, mesh: mesh_mod.Mesh, halo: int | None = None):
        # own attributes (writes to anything else forward to the bank —
        # see __setattr__)
        object.__setattr__(self, "bank", bank)
        self.mesh = mesh
        d = bank.design
        self._s = mesh.n_stream
        seg = d.in_block
        self._proc, self.halo = stream_mod.make_streaming_processor(
            bank, mesh, seg, halo)
        aseg = seg * d.up // d.down
        self.design = types.SimpleNamespace(
            fs_in=d.fs_in, fs_out=d.fs_out, up=d.up, down=d.down,
            in_block=self._s * seg, out_block=self._s * aseg)
        first = mesh.first
        self._tail = torch.zeros((self.halo, 2), dtype=torch.float32,
                                 device=first)
        self._nb = torch.zeros(bank.n_rx, dtype=torch.int64, device=first)
        self._bb = torch.zeros(bank.n_rx, dtype=torch.int64, device=first)
        # carried per-channel demod recurrence state (AGC env, squelch
        # latch, mute hold, ...) seeded from the serial bank's init state
        self._dstate = bank.state.ch.demod
        self._last_bb = None

    @property
    def n_rx(self) -> int:
        return self.bank.n_rx

    @property
    def device(self) -> torch.device:
        """The first shard's device: the executive uploads there."""
        return self.mesh.first

    def prepare(self, dtype, in_block) -> None:
        """Nothing to capture: the sharded processors run eagerly (the
        wrapped bank's own step, which would capture, never runs here)."""

    def step_device(self, x_p):
        """x_p: a float32 / int16 / int8 (S*seg, 2) wire block on
        self.device (dequantized before the halo copies). Returns one
        audio wire piece a shard; each shard's baseband lands in
        _last_bb when the bank emits it (the RTTY tap)."""
        (audio, self._nb, self._bb, self._tail, self._dstate,
         self._last_bb) = self._proc(
            x_p, self.bank.params, self._tail, self._nb, self._bb,
            self._dstate)
        return audio

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
        "bank", "mesh", "halo", "design", "_s", "_proc", "_tail",
        "_nb", "_bb", "_dstate", "_last_bb"})

    def __setattr__(self, name, value):
        bank = self.__dict__.get("bank")
        if name in self._OWN_ATTRS or bank is None \
                or not hasattr(bank, name):
            object.__setattr__(self, name, value)
        else:
            setattr(bank, name, value)


class ShardedChannelizerBank:
    """ChannelizerBank across a stream x ch grid, executive-compatible.

    With n_stream == 1 this still goes through the streaming processor
    (carried tail + phase bases), giving a pure channel-sharded bank
    whose FIR state is exact across calls."""

    _OWN_ATTRS = ShardedStreamBank._OWN_ATTRS

    def __init__(self, cb, mesh: mesh_mod.Mesh, halo: int | None = None):
        object.__setattr__(self, "bank", cb)
        self.mesh = mesh
        self._s = mesh.n_stream
        seg = cb.design.in_block
        self._proc, self.halo = \
            chanshard_mod.make_channelizer_streaming_processor(
                cb, mesh, seg, halo)
        self.design = types.SimpleNamespace(
            fs_in=cb.cfg.fs_in, fs_out=cb.plan.fs_out,
            up=cb.plan.up, down=cb.plan.down,
            in_block=self._s * seg,
            out_block=self._s * cb.design.out_block)
        first = mesh.first
        self._tail = torch.zeros((self.halo, 2), dtype=torch.float32,
                                 device=first)
        self._nb = torch.zeros(cb.n_ch, dtype=torch.int64, device=first)
        self._bb = torch.zeros(cb.n_ch, dtype=torch.int64, device=first)
        # carried per-channel demod recurrence state (see stream.py)
        self._dstate = cb.state.demod
        self._last_bb = None

    @property
    def n_rx(self) -> int:
        return self.bank.n_ch

    device = ShardedStreamBank.device
    prepare = ShardedStreamBank.prepare
    audio_from_wire = ShardedStreamBank.audio_from_wire
    baseband_from_wire = ShardedStreamBank.baseband_from_wire

    def step_device(self, x_p):
        audio, self._nb, self._bb, self._tail, self._dstate = self._proc(
            x_p, self.bank.params, self._tail, self._nb, self._bb,
            self._dstate)
        return audio

    def __getattr__(self, name):
        return getattr(self.bank, name)

    __setattr__ = ShardedStreamBank.__setattr__
