"""Carry a JAX bank's state, params and constants into a port bank.

The JAX ReceiverBank and ChannelizerBank keep their state and params as
NamedTuple trees (complex leaves packed into float pairs). Unpacked to
complex and turned leaf by leaf into numpy nested dicts with the same
field names, they load here, so a JAX bank stopped after k blocks can be
continued in the port:

    ReceiverBank
      state  {"hist", "ch": {"nco_phase", "demod": {<DemodState fields>}}}
      params {"nco_k", "video_row", "demod": {<DemodParams fields>}}
    ChannelizerBank
      state  {"chan_hist", "nco_phase", "rs_hist",
              "demod": {<DemodState fields>}}
      params {"nco_k", "video_row", "demod": {<DemodParams fields>}}

A JAX RTTYDecoder's streaming state (its channel dicts, the baseband and
soft-bit tails and the block count) carries over the same way, through
`rtty_state_from_numpy`.

Integer leaves become int64, complex leaves complex64, the rest float32 or
bool, each on the bank's device. Nothing here imports jax.
"""

from __future__ import annotations

import copy
import dataclasses

import numpy as np
import torch

from pysdr_tpu_torch.models.channelizer_bank import (ChanBankState,
                                                     ChannelizerBank,
                                                     ChanParams)
from pysdr_tpu_torch.models.receiver import (BankState, ChannelParams,
                                             ChannelState, ReceiverBank)
from pysdr_tpu_torch.models.rtty import RTTYDecoder, RTTYDesign
from pysdr_tpu_torch.ops import demod as demod_ops


def _tensor(v, device) -> torch.Tensor:
    a = np.asarray(v)
    if np.iscomplexobj(a):
        a = a.astype(np.complex64)
    elif a.dtype.kind in "iu":
        a = a.astype(np.int64)
    elif a.dtype.kind == "f":
        a = a.astype(np.float32)
    return torch.from_numpy(np.array(a, order="C")).to(device)


def _fill(cls, tree: dict, device):
    return cls(**{f.name: _tensor(tree[f.name], device)
                  for f in dataclasses.fields(cls)})


def state_from_numpy(bank: ReceiverBank, tree: dict) -> BankState:
    """Load a JAX BankState (nested dict of numpy leaves) into bank.state."""
    dev = bank.device
    bank.state = BankState(
        hist=_tensor(tree["hist"], dev),
        ch=ChannelState(
            nco_phase=_tensor(tree["ch"]["nco_phase"], dev),
            demod=_fill(demod_ops.DemodState, tree["ch"]["demod"], dev)))
    return bank.state


def params_from_numpy(bank: ReceiverBank, tree: dict) -> ChannelParams:
    """Load JAX ChannelParams (nested dict of numpy leaves, af_taps
    complex) into bank.params. A later control-plane call rebuilds the
    params from the bank's receiver configs, as in the JAX bank."""
    dev = bank.device
    bank.params = ChannelParams(
        nco_k=_tensor(tree["nco_k"], dev),
        video_row=_tensor(tree["video_row"], dev),
        demod=_fill(demod_ops.DemodParams, tree["demod"], dev))
    return bank.params


def constants_from_numpy(bank: ReceiverBank, video_bank, carrier_taps,
                         pilot_taps, af_taps=None) -> None:
    """Load the JAX bank's filter constants: the packed video weight bank
    (n_bw, up, 1, L), the complex carrier and pilot taps, and optionally
    the per-channel complex AF taps (n_rx, Ta)."""
    dev = bank.device
    bank.video_bank = _tensor(video_bank, dev)
    bank.carrier_taps = _tensor(carrier_taps, dev)
    bank.pilot_taps = _tensor(pilot_taps, dev)
    if af_taps is not None:
        bank.params.demod.af_taps = _tensor(af_taps, dev)


def chanbank_state_from_numpy(bank: ChannelizerBank,
                              tree: dict) -> ChanBankState:
    """Load a JAX ChanBankState (nested dict of numpy leaves, unpacked to
    complex) into bank.state."""
    dev = bank.device
    bank.state = ChanBankState(
        chan_hist=_tensor(tree["chan_hist"], dev),
        nco_phase=_tensor(tree["nco_phase"], dev),
        rs_hist=_tensor(tree["rs_hist"], dev),
        demod=_fill(demod_ops.DemodState, tree["demod"], dev))
    return bank.state


def chanbank_params_from_numpy(bank: ChannelizerBank,
                               tree: dict) -> ChanParams:
    """Load JAX ChanParams (nested dict of numpy leaves, af_taps complex)
    into bank.params. A later control-plane call rewrites the row of the
    channel it touches from the bank's channel settings."""
    dev = bank.device
    bank.params = ChanParams(
        nco_k=_tensor(tree["nco_k"], dev),
        video_row=_tensor(tree["video_row"], dev),
        demod=_fill(demod_ops.DemodParams, tree["demod"], dev))
    return bank.params


def rtty_state_from_numpy(jax_decoder, device) -> RTTYDecoder:
    """A port RTTYDecoder on `device` that continues a JAX RTTYDecoder
    mid-stream: the same design and scan policy, a deep copy of its
    channel dicts, its baseband tail (complex64), soft-bit tail (float32
    (T, n_ch)) and block count. Its frame counts follow the carried
    tail: prepare it (or let its first block do so) after this."""
    j = jax_decoder
    dec = RTTYDecoder(RTTYDesign(**dataclasses.asdict(j.design)),
                      rescan_every=j.rescan_every,
                      expire_after=j.expire_after, thresh_db=j.thresh_db,
                      rel_db=j.rel_db, device=device)
    dec.channels = copy.deepcopy(j.channels)
    dec._n_blocks = j._n_blocks
    dec.set_tails(j._iq_tail, j._soft_tail)
    return dec
