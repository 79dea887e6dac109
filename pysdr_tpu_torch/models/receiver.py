"""The receiver bank: NCO mix -> polyphase decimate -> demod -> AGC for N
channels of one passband (counterpart of pysdr_tpu/models/receiver.py).

One step processes a shared RF block for every channel: the bank-level
fused mix+resample (ops/resample.mixed_resample_bank) followed by the
channel-batched demod. Every control-plane knob (NCO offset, filter row,
mode, gains, squelch, mute) is per-channel tensor data rebuilt on the
host between blocks and copied into the bank's params, so a control
change never changes the step. On a card the step is captured once per
(wire dtype, in_block) as a CUDA graph and replayed (models/graphstep),
as the JAX bank jits it once; `graph=False` runs the same step eagerly.
"""

from __future__ import annotations

import dataclasses
import warnings

import numpy as np
import torch

from pysdr_tpu_torch import config as cfg_mod
from pysdr_tpu_torch import tables
from pysdr_tpu_torch.device import copy_tensors, map_tensors, resolve_device
from pysdr_tpu_torch.models.graphstep import StepGraphs
from pysdr_tpu_torch.ops import cplx
from pysdr_tpu_torch.ops import demod as demod_ops
from pysdr_tpu_torch.ops import fir, nco, resample
from pysdr_tpu_torch.tables import Mode


@dataclasses.dataclass
class ChannelParams:
    nco_k: torch.Tensor          # int64 (B,) NCO numerator (passband offset)
    video_row: torch.Tensor      # int64 (B,) row of the video weight bank
    demod: demod_ops.DemodParams


@dataclasses.dataclass
class ChannelState:
    nco_phase: torch.Tensor      # int64 (B,) LO phase index at the block start
    demod: demod_ops.DemodState


@dataclasses.dataclass
class BankState:
    """The resampler history is the RAW RF tail (last Kp-1 input samples),
    shared by every channel: each channel re-mixes it at its back-shifted
    phase, which reproduces a per-channel mixed tail exactly."""
    hist: torch.Tensor           # complex64 (Kp-1,)
    ch: ChannelState


@dataclasses.dataclass(frozen=True)
class ReceiverDesign:
    """Static design: rates, block sizes, filter lengths."""
    fs_in: float
    fs_out: float
    up: int
    down: int
    in_block: int
    out_block: int
    video_taps: int              # prototype length (up * taps_per_phase)
    demod: demod_ops.DemodDesign

    @classmethod
    def from_config(cls, cfg: cfg_mod.PipelineConfig) -> "ReceiverDesign":
        plan = cfg.plan
        tpp = cfg.video_taps_per_phase or max(
            16, int(np.ceil(8 * plan.down / plan.up)))
        return cls(fs_in=cfg.fs_in, fs_out=plan.fs_out, up=plan.up,
                   down=plan.down, in_block=plan.in_block,
                   out_block=plan.out_block, video_taps=plan.up * tpp,
                   demod=demod_ops.DemodDesign(fs_out=plan.fs_out,
                                               af_taps=cfg.af_taps))


def channel_step(x, hist, state: ChannelState, p: ChannelParams,
                 design: ReceiverDesign, video_bank, carrier_taps,
                 pilot_taps):
    """Channels one at a time in form, one block: the whole
    `demodulate_data` equivalent (reference receiver.py:231-297), as
    pysdr_tpu/models/receiver.channel_step, batched over the B channels
    of `state` and `p` as the port's ops are. x complex64 (in_block,) the
    shared RF block; hist complex64 (Kp-1,) its shared RAW tail of the
    previous block. state.nco_phase is the LO phase index at x[0]; the
    tail is re-mixed at the back-shifted phase, reproducing the previous
    block's mixed tail exactly. Returns (audio complex64 (B, out_block),
    new_state, bb (B, out_block)).

    This is the per-channel REFERENCE form: each channel's mixed stream
    is built, then resampled. The bank's step and the stream shards use
    the fused bank-level mix+resample (ops/resample.mixed_resample_bank)
    instead; tests/test_torch_receiver.py holds the two forms equal."""
    kp1 = hist.shape[0]
    k = p.nco_k
    p0m = nco.advance((nco.DENOM - k) % nco.DENOM, state.nco_phase, kp1)
    y, _ = nco.mix_down(torch.cat([hist, x]), k, p0m)       # (B, kp1 + n)
    phase = nco.advance(k, state.nco_phase, x.shape[0])
    bb, _ = resample.resample_block(
        y[:, kp1:], y[:, :kp1], video_bank[p.video_row], up=design.up,
        down=design.down)
    audio, dstate = demod_ops.demod_block(
        bb, state.demod, p.demod, design.demod, carrier_taps, pilot_taps)
    return audio, ChannelState(nco_phase=phase, demod=dstate), bb


class BankIO:
    """The host side of a bank's step, shared by ReceiverBank and
    ChannelizerBank; uses self.device, self.n_rx, self.design.out_block,
    self.step_device and the step's launcher self._graphs."""

    def to_device_block(self, x) -> torch.Tensor:
        """Host complex block -> device float32 (n, 2) pairs; a real wire
        block (n, 2) is moved as is."""
        x = np.asarray(x)
        if np.iscomplexobj(x):
            x = x.astype(np.complex64).view(np.float32).reshape(-1, 2)
        return torch.from_numpy(np.ascontiguousarray(x)).to(self.device)

    def audio_from_wire(self, audio_w: torch.Tensor) -> np.ndarray:
        """Audio wire block (the executive's host copy, or a device tensor,
        which this waits for) -> host complex64 (n_rx, out_block)."""
        flat = cplx.dequantize_audio_host(audio_w.cpu().numpy())
        return np.ascontiguousarray(flat.reshape(
            self.n_rx, self.design.out_block, 2)).view(np.complex64)[..., 0]

    def baseband_from_wire(self, bb: torch.Tensor) -> torch.Tensor:
        """A step's baseband (_last_bb, a new tensor each step) -> the
        block's baseband, complex64 (n_rx, out_block), on the device (the
        executive calls it right after the step): the RTTY decoder reads
        it there."""
        return bb

    def step(self, x) -> np.ndarray:
        """Host convenience: one RF block (in_block complex) in, host audio
        (n_rx, out_block) complex64 out; advances the state."""
        # the step's audio is its static output, rewritten by the next
        # step: a copy on the host, also where the bank is on the CPU
        return self.audio_from_wire(self.step_device(
            self.to_device_block(x)).to("cpu", copy=True))

    def prepare(self, dtype: torch.dtype, in_block: int) -> None:
        """Make the step's static buffers for (dtype, in_block) wire
        blocks, and on a card capture its graph: before any other thread
        works on the card (the executive calls it before its prefetch
        thread starts). step_device does it at a key's first block."""
        self._graphs.prepare(dtype, in_block)

    @property
    def graph_count(self) -> int:
        """CUDA graphs captured so far: one per (wire dtype, in_block)."""
        return self._graphs.count


class ReceiverBank(BankIO, torch.nn.Module):
    """N receivers inside one passband plus their host control plane.

    `step(x)` takes a host complex block and returns host audio;
    `step_device(x_wire)` takes a device wire block (float32 / int16 /
    int8 (in_block, 2)) and returns the device audio wire block. The
    control methods rewrite per-channel params in place, applied at the
    next block. `graph` (a card only): replay the step as a CUDA graph
    (the default) or run it eagerly, for comparisons.
    """

    def __init__(self, cfg: cfg_mod.PipelineConfig, emit_baseband=False,
                 audio_wire: str = "f32", device="cuda", graph: bool = True):
        super().__init__()
        cfg_mod.validate(cfg)
        if audio_wire not in ("f32", "i16", "i8"):
            raise ValueError(f"unknown audio wire {audio_wire!r}")
        self.cfg = cfg
        self.audio_wire = audio_wire
        self.device = resolve_device(device)
        self.design = ReceiverDesign.from_config(cfg)
        d = self.design
        # video (anti-alias) filter bank, one packed row per VIDEO_BWS entry
        self.video_bws = [bw for bw in tables.VIDEO_BWS_HZ
                          if bw == 0.0 or bw <= d.fs_out]
        self.video_proto = fir.video_filter_bank(
            d.fs_in, d.up, d.down, self.video_bws,
            taps_per_phase=d.video_taps // d.up)
        self.register_buffer("video_bank", torch.from_numpy(
            resample.pack_weight_bank(self.video_proto, d.up, d.down))
            .to(self.device))
        self.register_buffer("carrier_taps", torch.from_numpy(
            np.asarray(d.demod.carrier_filter(), np.complex64))
            .to(self.device))
        self.register_buffer("pilot_taps", torch.from_numpy(
            np.asarray(d.demod.pilot_filter(), np.complex64))
            .to(self.device))
        # the demod's scan constants go to the device now, not in a step
        demod_ops.scan_constants(d.demod, self.pilot_taps.device)
        self.emit_baseband = emit_baseband
        self._last_bb = None

        self._rx_cfgs = list(cfg.receivers)
        # the tuner's dial anchor (passband center in dial terms); moves
        # only on a main-RX out-of-band retune via on_device_retune
        self._center_dial = cfg.receivers[0].fc_hz - cfg.foffset_hz
        # host callback(new_center_dial_hz) that retunes the source
        self.on_device_retune = None
        self.params = map_tensors(lambda t: t.to(self.device),
                                  self._build_params())
        self.state = self.init_state()
        self._graphs = StepGraphs(
            self, self._step_impl,
            lambda: (self.video_bank, self.carrier_taps, self.pilot_taps),
            graph)

    # ---------- construction ----------

    @property
    def n_rx(self) -> int:
        return len(self._rx_cfgs)

    def _video_row_for(self, rc: cfg_mod.ReceiverConfig) -> int:
        if rc.video_bw_hz <= 0:
            return 0
        return tables.find_filter_index(rc.video_bw_hz, self.video_bws)

    def _params_for(self, rc: cfg_mod.ReceiverConfig,
                    offset_hz: float) -> ChannelParams:
        d = self.design
        dp = demod_ops.make_params(
            d.demod, rc.mode, af_bw_hz=rc.af_bw_hz, bfo_hz=rc.bfo_hz,
            af_gain=rc.af_gain, squelch_db=rc.squelch_db,
            agc_on=rc.agc_enabled, muted=rc.muted, auto_mute=rc.auto_mute,
            auto_mute_db=rc.auto_mute_db)
        return ChannelParams(
            nco_k=torch.tensor(nco.snap_freq(offset_hz, d.fs_in)),
            video_row=torch.tensor(self._video_row_for(rc)), demod=dp)

    def _build_params(self) -> ChannelParams:
        """Every channel's params from the current configs, on the host."""
        # NCO offsets from the CURRENT dials against the device anchor; a
        # chained RX (src >= 0) uses fc_i - fc_src
        def off(rc):
            if 0 <= rc.src < len(self._rx_cfgs):
                return rc.fc_hz - self._rx_cfgs[rc.src].fc_hz
            return rc.fc_hz - self._center_dial
        rows = [self._params_for(rc, off(rc)) for rc in self._rx_cfgs]
        return ChannelParams(
            nco_k=torch.stack([r.nco_k for r in rows]),
            video_row=torch.stack([r.video_row for r in rows]),
            demod=demod_ops.DemodParams.stack([r.demod for r in rows]))

    def init_state(self) -> BankState:
        d = self.design
        return BankState(
            hist=torch.zeros(resample.history_len(d.video_taps, d.up),
                             dtype=torch.complex64, device=self.device),
            ch=ChannelState(
                nco_phase=torch.zeros(self.n_rx, dtype=torch.int64,
                                      device=self.device),
                demod=demod_ops.init_state(d.demod, self.n_rx, self.device)))

    # ---------- the step ----------

    def _step_impl(self, state: BankState, x_wire: torch.Tensor,
                   params: ChannelParams):
        """x_wire: float32 / int16 / int8 (in_block, 2) on the device.
        Returns (new_state, (audio wire (n_rx*out_block*2,), bb or None))."""
        d = self.design
        x = torch.view_as_complex(cplx.dequantize(x_wire).contiguous())
        kp1 = state.hist.shape[0]
        n = x.shape[0]
        k = params.nco_k
        phase = state.ch.nco_phase
        # phase at hist[0]: back-shift the block-start phase by Kp-1 samples
        p0m = nco.advance((nco.DENOM - k) % nco.DENOM, phase, kp1)
        bb = resample.mixed_resample_bank(
            x, state.hist, self.video_bank[params.video_row], k, p0m,
            up=d.up, down=d.down)
        audio, new_demod = demod_ops.demod_block(
            bb, state.ch.demod, params.demod, d.demod, self.carrier_taps,
            self.pilot_taps)
        new_state = BankState(
            hist=x[n - kp1:].clone() if kp1 else state.hist,
            ch=ChannelState(nco_phase=nco.advance(k, phase, n),
                            demod=new_demod))
        out = cplx.quantize_audio_wire(
            torch.view_as_real(audio).reshape(-1), self.audio_wire)
        return new_state, (out, bb if self.emit_baseband else None)

    def step_functional(self, state: BankState, x_wire: torch.Tensor,
                        params: ChannelParams):
        """The pure step: (new state, (audio wire, bb or None)) from the
        given state and params, the bank's own left as they are. Eager on
        every device (step_device replays the captured graph)."""
        return self._step_impl(state, x_wire, params)

    def step_device(self, x_wire: torch.Tensor) -> torch.Tensor:
        """Device step: returns the flattened audio wire block on the
        device (no host transfer). The block is copied into the step's
        static input; the audio returned is the step's static output,
        valid until the next step (the executive copies it to the host
        right after). The baseband, which the executive keeps for
        pipeline_depth blocks, is copied out (_last_bb)."""
        outs = self._graphs.run(x_wire)
        self._last_bb = outs[1].clone() if self.emit_baseband else None
        return outs[0]

    # ---------- control plane (block-boundary mutations) ----------

    def _rebuild_params(self):
        """Copy params rebuilt from the configs into the bank's params (a
        captured step reads those tensors)."""
        copy_tensors(self.params, self._build_params())

    def _update(self, i: int, **changes):
        self._rx_cfgs[i] = dataclasses.replace(self._rx_cfgs[i], **changes)
        self._rebuild_params()

    def retune(self, i: int, fc_hz: float):
        """In-passband retunes update the NCO numerator; a MAIN-RX retune
        that leaves the passband moves the device via on_device_retune
        (when set), re-anchoring every channel's offset."""
        half = self.cfg.fs_in / 2
        if abs(fc_hz - self._center_dial) >= half:
            if i == 0 and self.on_device_retune is not None:
                self._center_dial = fc_hz - self.cfg.foffset_hz
                self.on_device_retune(self._center_dial)
                displaced = [
                    j for j, rc in enumerate(self._rx_cfgs)
                    if j != i and abs(rc.fc_hz - self._center_dial) >= half]
                if displaced:
                    warnings.warn(
                        f"device retune to {self._center_dial / 1e6:.3f} MHz "
                        f"leaves RX{displaced} outside the passband: retune "
                        "them or their audio will alias", stacklevel=2)
            else:
                why = ("only a MAIN-RX (RX0) retune moves the device; "
                       "retune RX0 to move the passband"
                       if self.on_device_retune is not None
                       else "the source cannot retune")
                warnings.warn(
                    f"RX{i} retune to {fc_hz / 1e6:.3f} MHz is outside the "
                    f"current passband (center "
                    f"{self._center_dial / 1e6:.3f} MHz ± "
                    f"{half / 1e6:.3f} MHz) — {why}: reception will alias",
                    stacklevel=2)
        self._update(i, fc_hz=fc_hz)

    def set_mode(self, i: int, mode: Mode):
        self._update(i, mode=tables.Mode(mode))

    def set_video_bw(self, i: int, bw_hz: float):
        self._update(i, video_bw_hz=bw_hz)

    def set_af_bw(self, i: int, bw_hz: float):
        self._update(i, af_bw_hz=bw_hz)

    def set_af_gain(self, i: int, gain: float):
        self._update(i, af_gain=gain)

    def set_squelch(self, i: int, level_db: float):
        self._update(i, squelch_db=level_db)

    def set_agc(self, i: int, enabled: bool):
        self._update(i, agc_enabled=enabled)

    def set_mute(self, i: int, muted: bool):
        self._update(i, muted=bool(muted))

    def set_auto_mute(self, i: int, enabled: bool,
                      thresh_db: float | None = None):
        kw = {"auto_mute": bool(enabled)}
        if thresh_db is not None:
            kw["auto_mute_db"] = float(thresh_db)
        self._update(i, **kw)

    def set_auto_mute_all(self, enabled: bool):
        for i in range(self.n_rx):
            self._rx_cfgs[i] = dataclasses.replace(
                self._rx_cfgs[i], auto_mute=bool(enabled))
        self._rebuild_params()

    # ---------- verification harness ----------

    def dump_internals(self) -> dict:
        """Filter-bank dump for numerical cross-validation (`--internals`,
        the reference's internals.mat harness, receiver.py:864-874): the
        keys and values of pysdr_tpu's dump, complex taps as float32
        (n, 2) pairs as the JAX bank keeps them."""
        d = self.design

        def pairs(t):
            return torch.view_as_real(t).cpu().numpy()
        return {
            "up": d.up, "down": d.down, "fs_in": d.fs_in,
            "fs_out": d.fs_out,
            "video_filter_bank": np.asarray(self.video_proto),
            "carrier_filter": pairs(self.carrier_taps),
            "af_banks": {i: pairs(self._params_for(rc, 0.0).demod.af_taps)
                         for i, rc in enumerate(self._rx_cfgs)},
        }
