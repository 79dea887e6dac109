"""ChannelizerBank: polyphase-channelize the whole passband, then demod
every channel (counterpart of pysdr_tpu/models/channelizer_bank.py;
BASELINE config 5).

    x wire (fs_in) -> pfb branch filter (CUDA kernel, dequantizing in its
      load) -> FFT over the branches -> (N, M) channel streams
      -> per channel [fine NCO -> polyphase fs_ch->fs_out -> demod]

The per-channel stages run batched over the channel axis (the reference
vmaps one channel). Every knob (fine offset, filter row, mode, gains,
squelch, mute) is per-channel tensor data, so a control change never
changes the step, and a knob on one channel rewrites only that channel's
row of the params, in place. On a card the step is captured once per
(wire dtype, in_block) as a CUDA graph and replayed (models/graphstep);
`graph=False` runs it eagerly. The executive drives the bank through the
same facade as ReceiverBank: design.{fs_in, fs_out, in_block, out_block,
up, down}, n_rx, device, step_device, _last_bb, and BankIO's
audio_from_wire, baseband_from_wire, step and prepare.

Channels are critically sampled; a fine retune off channel center is
legal but aliases as |offset| -> fs_ch/2, like any critically sampled PFB.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from pysdr_tpu_torch import rates, tables
from pysdr_tpu_torch.device import map_tensors, resolve_device
from pysdr_tpu_torch.models.graphstep import StepGraphs
from pysdr_tpu_torch.models.receiver import BankIO
from pysdr_tpu_torch.ops import channelizer as chan_ops
from pysdr_tpu_torch.ops import cplx
from pysdr_tpu_torch.ops import demod as demod_ops
from pysdr_tpu_torch.ops import fir, nco, resample
from pysdr_tpu_torch.tables import Mode


@dataclasses.dataclass(frozen=True)
class ChannelSettings:
    """Per-channel demod settings (the ReceiverConfig analogue; the RF
    frequency is the channel's center plus a fine offset)."""
    mode: Mode = Mode.AM
    fine_offset_hz: float = 0.0    # NCO offset from the channel center
    video_bw_hz: float = 0.0       # pre-demod channel filter (0 = Max)
    af_bw_hz: float = 0.0
    af_gain: float = 1.0
    agc_enabled: bool = True
    squelch_db: float = -150.0
    bfo_hz: float = tables.CW_BFO_HZ
    muted: bool = False
    auto_mute: bool = False
    auto_mute_db: float = -10.0


@dataclasses.dataclass(frozen=True)
class ChannelizerBankConfig:
    fs_in: float                    # total passband rate
    n_channels: int                 # uniform channels (fs_ch = fs_in / N)
    fs_out: float = 48e3
    out_block: int = 4096           # audio samples per block per channel
    fc_hz: float = 0.0              # RF frequency of the passband center
    taps_per_branch: int = 12
    af_taps: int = 256
    video_taps_per_phase: int = 16  # fs_ch -> fs_out resampler
    channels: tuple[ChannelSettings, ...] = ()

    def __post_init__(self):
        if not self.channels:
            object.__setattr__(
                self, "channels",
                tuple(ChannelSettings() for _ in range(self.n_channels)))
        if len(self.channels) != self.n_channels:
            raise ValueError(f"{len(self.channels)} channel settings for "
                             f"{self.n_channels} channels")

    @property
    def fs_ch(self) -> float:
        return self.fs_in / self.n_channels

    @property
    def plan(self) -> rates.RatePlan:
        return rates.rate_plan(self.fs_ch, self.fs_out, self.out_block)

    def center_freqs_hz(self) -> np.ndarray:
        """Absolute RF center of each channel (fftfreq order, like the
        FFT columns)."""
        return self.fc_hz + np.fft.fftfreq(self.n_channels,
                                           1.0 / self.fs_in)


@dataclasses.dataclass
class ChanParams:
    nco_k: torch.Tensor          # int64 (N,) fine offsets @ fs_ch
    video_row: torch.Tensor      # int64 (N,) row of the video weight bank
    demod: demod_ops.DemodParams  # leading axis N


@dataclasses.dataclass
class ChanBankState:
    chan_hist: torch.Tensor      # complex64 ((K-1)*N,) dequantized RF tail
    nco_phase: torch.Tensor      # int64 (N,) fine-NCO phases
    rs_hist: torch.Tensor        # complex64 (N, Kp-1) resampler tails
    demod: demod_ops.DemodState  # leading axis N


@dataclasses.dataclass(frozen=True)
class BankDesign:
    """The static design the executive and display read."""
    fs_in: float
    fs_out: float
    in_block: int
    out_block: int
    up: int
    down: int


def _set_row(full, row, i: int) -> None:
    """Write the (host) row `row` into row i of the stacked dataclass
    `full`, in place (a captured step reads full's tensors)."""
    if isinstance(full, torch.Tensor):
        full[i].copy_(row)
        return
    for f in dataclasses.fields(full):
        _set_row(getattr(full, f.name), getattr(row, f.name), i)


class ChannelizerBank(BankIO, torch.nn.Module):
    """N uniform channels + demod with the same host control plane as
    ReceiverBank (block-boundary params writes). `graph` as for
    ReceiverBank."""

    def __init__(self, cfg: ChannelizerBankConfig, audio_wire: str = "f32",
                 device="cuda", graph: bool = True):
        super().__init__()
        if audio_wire not in ("f32", "i16", "i8"):
            raise ValueError(f"unknown audio wire {audio_wire!r}")
        self.cfg = cfg
        self.audio_wire = audio_wire
        self.device = resolve_device(device)
        n = cfg.n_channels
        plan = cfg.plan
        self.plan = plan
        self.chan_design = chan_ops.ChannelizerDesign(
            fs_in=cfg.fs_in, n_channels=n,
            taps_per_branch=cfg.taps_per_branch)
        self.demod_design = demod_ops.DemodDesign(fs_out=plan.fs_out,
                                                  af_taps=cfg.af_taps)
        self.design = BankDesign(
            fs_in=cfg.fs_in, fs_out=plan.fs_out, in_block=plan.in_block * n,
            out_block=plan.out_block, up=plan.up, down=plan.down)
        self.register_buffer("branch_weights", torch.from_numpy(
            chan_ops.pack_branch_weights(self.chan_design.prototype(), n))
            .to(self.device))
        self.video_bws = [bw for bw in tables.VIDEO_BWS_HZ
                          if bw == 0.0 or bw <= plan.fs_out]
        self.video_proto = fir.video_filter_bank(
            cfg.fs_ch, plan.up, plan.down, self.video_bws,
            taps_per_phase=cfg.video_taps_per_phase)
        self.register_buffer("video_bank", torch.from_numpy(
            resample.pack_weight_bank(self.video_proto, plan.up, plan.down))
            .to(self.device))
        dd = self.demod_design
        self.register_buffer("carrier_taps", torch.from_numpy(
            np.asarray(dd.carrier_filter(), np.complex64)).to(self.device))
        self.register_buffer("pilot_taps", torch.from_numpy(
            np.asarray(dd.pilot_filter(), np.complex64)).to(self.device))
        # the demod's scan constants go to the device now, not in a step;
        # keyed by the tensors' indexed device ("cuda:0"), as the step
        # looks them up, not by the unindexed "cuda" it may be given
        demod_ops.scan_constants(dd, self.pilot_taps.device)

        self._ch_cfgs = list(cfg.channels)
        self._last_bb = None          # executive/app tap parity
        self.params = self._build_params()
        self.state = self.init_state()
        self._graphs = StepGraphs(
            self, self._step_impl,
            lambda: (self.branch_weights, self.video_bank,
                     self.carrier_taps, self.pilot_taps), graph)

    # ---------- construction ----------

    @property
    def n_ch(self) -> int:
        return self.cfg.n_channels

    # the executive-facing name (a receiver per channel)
    n_rx = n_ch

    def _params_for(self, cs: ChannelSettings) -> ChanParams:
        """One channel's params as host tensors. The pre-demod filter row
        follows video_bw_hz only (an NFM channel's narrow AF filter must
        not narrow the pre-discriminator filter)."""
        row = (tables.find_filter_index(cs.video_bw_hz, self.video_bws)
               if cs.video_bw_hz > 0 else 0)
        dp = demod_ops.make_params(
            self.demod_design, cs.mode, af_bw_hz=cs.af_bw_hz,
            bfo_hz=cs.bfo_hz, af_gain=cs.af_gain, squelch_db=cs.squelch_db,
            agc_on=cs.agc_enabled, muted=cs.muted, auto_mute=cs.auto_mute,
            auto_mute_db=cs.auto_mute_db)
        return ChanParams(
            nco_k=torch.tensor(nco.snap_freq(cs.fine_offset_hz,
                                             self.cfg.fs_ch)),
            video_row=torch.tensor(row), demod=dp)

    def _build_params(self) -> ChanParams:
        rows = [self._params_for(cs) for cs in self._ch_cfgs]
        params = ChanParams(
            nco_k=torch.stack([r.nco_k for r in rows]),
            video_row=torch.stack([r.video_row for r in rows]),
            demod=demod_ops.DemodParams.stack([r.demod for r in rows]))
        return map_tensors(lambda t: t.to(self.device), params)

    def init_state(self) -> ChanBankState:
        n = self.n_rx
        kp1 = resample.history_len(
            self.plan.up * self.cfg.video_taps_per_phase, self.plan.up)
        dev = self.device
        return ChanBankState(
            chan_hist=torch.zeros(chan_ops.history_len(self.chan_design),
                                  dtype=torch.complex64, device=dev),
            nco_phase=torch.zeros(n, dtype=torch.int64, device=dev),
            rs_hist=torch.zeros((n, kp1), dtype=torch.complex64,
                                device=dev),
            demod=demod_ops.init_state(self.demod_design, n, dev))

    # ---------- the step ----------

    def channel_chain(self, s, ph, rh, dst, pr: ChanParams, consts=None):
        """Channel streams s (B, M), one block: fine mix -> resample ->
        demod, from phases ph (B,), resampler tails rh (B, Kp-1) and demod
        state dst of B rows, with params pr of B rows. Shared by the step
        and the sharded processors (parallel/chanshard.py), which pass
        `consts`, (video_bank, carrier_taps, pilot_taps) on their shard's
        device. Returns (audio (B, out), ph, rh, dst)."""
        video_bank, carrier, pilot = consts or (
            self.video_bank, self.carrier_taps, self.pilot_taps)
        z, ph2 = nco.mix_down(s, pr.nco_k, ph)
        bb, rh2 = resample.resample_block(
            z, rh, video_bank[pr.video_row], up=self.plan.up,
            down=self.plan.down)
        audio, dst2 = demod_ops.demod_block(
            bb, dst, pr.demod, self.demod_design, carrier, pilot)
        return audio, ph2, rh2, dst2

    def _step_impl(self, state: ChanBankState, x_wire: torch.Tensor,
                   params: ChanParams):
        """x_wire: float32 / int16 / int8 (in_block, 2) on the device.
        Returns (new_state, audio wire (N*out_block*2,))."""
        v, chan_hist = chan_ops.branch_filter(x_wire, state.chan_hist,
                                              self.branch_weights)
        streams = chan_ops.channel_transform(v).T               # (N, M)
        audio, phase, rs_hist, dstate = self.channel_chain(
            streams, state.nco_phase, state.rs_hist, state.demod, params)
        new_state = ChanBankState(chan_hist=chan_hist, nco_phase=phase,
                                  rs_hist=rs_hist, demod=dstate)
        return new_state, cplx.quantize_audio_wire(
            torch.view_as_real(audio).reshape(-1), self.audio_wire)

    def step_device(self, x_wire: torch.Tensor) -> torch.Tensor:
        """Device step: returns the flattened audio wire block on the
        device (no host transfer): the step's static output, valid until
        the next step (ReceiverBank.step_device)."""
        return self._graphs.run(x_wire)[0]

    # ---------- control plane ----------

    def _update(self, i: int, **changes):
        self._ch_cfgs[i] = dataclasses.replace(self._ch_cfgs[i], **changes)
        # channels are independent: one knob rebuilds ONE row (a full
        # rebuild would design a 256-tap AF filter for every channel)
        _set_row(self.params, self._params_for(self._ch_cfgs[i]), i)

    def retune(self, i: int, fine_offset_hz: float):
        """Fine retune inside channel i (the FreqSelect analogue)."""
        self._update(i, fine_offset_hz=fine_offset_hz)

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

    def channel_of(self, freq_hz: float) -> int:
        """Channel index whose center is nearest an absolute RF freq."""
        return int(np.argmin(np.abs(self.cfg.center_freqs_hz() - freq_hz)))
