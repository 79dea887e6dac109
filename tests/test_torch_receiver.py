"""Parity of the torch ReceiverBank against pysdr_tpu's ReceiverBank (JAX
on the CPU) at the 4-RX config of tests/test_receiver.py: bit-equal
filter constants, >= 80 dB audio per block over a stream with a retune
and a mode change, a JAX bank's state carried into the port mid-stream,
and the i16 / mu-law i8 audio wires within one code."""

import numpy as np
import pytest
import torch

from pysdr_tpu import config as jconfig
from pysdr_tpu import tables as jtables
from pysdr_tpu.io import synth
from pysdr_tpu.models.receiver import ReceiverBank as JaxBank
from pysdr_tpu.ops import cplx as jcplx
from pysdr_tpu_torch import config, convert, tables
from pysdr_tpu_torch.models.receiver import ReceiverBank

torch.set_num_threads(1)



def make_cfg(cfg_mod, Mode):
    """The same bank's config in either package, from one set of
    keyword arguments."""
    return cfg_mod.PipelineConfig(
        fs_in=512e3, fs_out=48e3, out_block=3072, foffset_hz=60e3,
        receivers=(
            cfg_mod.ReceiverConfig(fc_hz=10e6, mode=Mode.AM),
            cfg_mod.ReceiverConfig(fc_hz=10.03e6, mode=Mode.NFM,
                                   squelch_db=-150),
            cfg_mod.ReceiverConfig(fc_hz=9.97e6, mode=Mode.USB),
            cfg_mod.ReceiverConfig(fc_hz=10.06e6, mode=Mode.CW),
        ))


CFG = make_cfg(config, tables.Mode)
JCFG = make_cfg(jconfig, jtables.Mode)


def snr_db(got, ref):
    err = (np.abs(got - ref) ** 2).mean()
    return -10 * np.log10(max(err / max((np.abs(ref) ** 2).mean(), 1e-30),
                              1e-30))


def blocks(n_blocks, in_block):
    specs = [synth.SignalSpec(offset_hz=60e3, mode="am", audio_hz=700.0),
             synth.SignalSpec(offset_hz=90e3, mode="fm", audio_hz=800.0),
             synth.SignalSpec(offset_hz=30e3, mode="usb", audio_hz=1200.0),
             synth.SignalSpec(offset_hz=120e3, mode="cw")]
    src = synth.SynthSource(specs, fs=CFG.fs_in, noise_rms=0.05)
    return [np.asarray(src.read_data(in_block), np.complex64)
            for _ in range(n_blocks)]


def np_tree(t):
    """JAX NamedTuple tree -> nested dict of numpy leaves."""
    if hasattr(t, "_asdict"):
        return {k: np_tree(v) for k, v in t._asdict().items()}
    return np.asarray(t)


def assert_parity(tb, jb, x, tag):
    a_t, a_j = tb.step(x), jb.step(x)
    assert a_t.shape == a_j.shape == (4, CFG.plan.out_block)
    for i in range(4):
        assert snr_db(a_t[i], a_j[i]) >= 80.0, (tag, i, snr_db(a_t[i], a_j[i]))


def test_constants_and_params_bit_equal():
    tb, jb = ReceiverBank(CFG, device="cpu"), JaxBank(JCFG)
    np.testing.assert_array_equal(tb.video_bank.numpy(), jb.video_bank)
    np.testing.assert_array_equal(tb.carrier_taps.numpy(),
                                  jcplx.unpack(jb.carrier_taps))
    np.testing.assert_array_equal(tb.pilot_taps.numpy(),
                                  jcplx.unpack(jb.pilot_taps))
    assert tb.design.in_block == jb.design.in_block
    assert tb.state.hist.shape == jb.state.hist.shape[:1]
    pj = np_tree(jb.params)
    np.testing.assert_array_equal(tb.params.nco_k.numpy(), pj["nco_k"])
    np.testing.assert_array_equal(tb.params.video_row.numpy(),
                                  pj["video_row"])
    np.testing.assert_array_equal(tb.params.demod.af_taps.numpy(),
                                  jcplx.unpack(pj["demod"]["af_taps"]))
    for f, v in pj["demod"].items():
        if f != "af_taps":
            np.testing.assert_array_equal(
                getattr(tb.params.demod, f).numpy(), v, err_msg=f)


def test_bank_matches_jax_over_retune_and_mode_change():
    tb, jb = ReceiverBank(CFG, device="cpu"), JaxBank(JCFG)
    xs = blocks(4, tb.design.in_block)
    for blk, x in enumerate(xs):
        if blk == 1:
            for b in (tb, jb):
                b.retune(1, 10.031e6)
        if blk == 2:
            for b, Mode in ((tb, tables.Mode), (jb, jtables.Mode)):
                b.set_mode(0, Mode.AM_SYNC)
                b.set_squelch(2, 3.0)
        assert_parity(tb, jb, x, blk)
    np.testing.assert_array_equal(tb.state.ch.nco_phase.numpy(),
                                  np.asarray(jb.state.ch.nco_phase))


def test_jax_state_carries_into_port():
    jb = JaxBank(JCFG)
    xs = blocks(4, jb.design.in_block)
    for x in xs[:2]:
        jb.step(x)
    tb = ReceiverBank(CFG, device="cpu")
    state = np_tree(jcplx.unpack_tree(jb.state, jb._state_mask))
    params = np_tree(jb.params)
    params["demod"]["af_taps"] = jcplx.unpack(params["demod"]["af_taps"])
    convert.state_from_numpy(tb, state)
    convert.params_from_numpy(tb, params)
    convert.constants_from_numpy(
        tb, jb.video_bank, jcplx.unpack(jb.carrier_taps),
        jcplx.unpack(jb.pilot_taps), params["demod"]["af_taps"])
    assert tb.state.ch.nco_phase.dtype == torch.int64
    for blk, x in enumerate(xs[2:]):
        assert_parity(tb, jb, x, blk + 2)


@pytest.mark.parametrize("wire", ["i16", "i8"])
def test_audio_wire_within_one_code(wire):
    tb = ReceiverBank(CFG, audio_wire=wire, device="cpu")
    jb = JaxBank(JCFG, audio_wire=wire)
    for x in blocks(2, tb.design.in_block):
        got = tb.step_device(tb.to_device_block(x)).numpy()
        ref = np.asarray(jb.step_device(jb.to_device_block(x)))
        assert got.dtype == ref.dtype
        assert np.abs(got.astype(np.int32) - ref.astype(np.int32)).max() <= 1


def test_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        ReceiverBank(CFG)
