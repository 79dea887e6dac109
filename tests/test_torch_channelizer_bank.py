"""Parity of the port's ChannelizerBank against pysdr_tpu's (JAX on the
CPU), mirroring tests/test_channelizer_bank.py: N = 8 channels at 48 kHz
and at 192 kHz (the decimating plan), a fine retune, a mode change and a
mute, streaming against one batch block, and a JAX bank's state carried
into the port mid-stream. Every channel carries a station over a noise
floor, and every block holds >= 80 dB audio SNR per channel."""

import numpy as np
import pytest
import torch

from pysdr_tpu.io import synth
from pysdr_tpu.models.channelizer_bank import ChannelizerBank as JaxBank
from pysdr_tpu.models.channelizer_bank import \
    ChannelizerBankConfig as JaxConfig
from pysdr_tpu.models.channelizer_bank import ChannelSettings as JaxSettings
from pysdr_tpu.ops import cplx as jcplx
from pysdr_tpu.tables import Mode as JMode
from pysdr_tpu_torch import convert
from pysdr_tpu_torch.device import map_tensors
from pysdr_tpu_torch.models.channelizer_bank import (ChannelizerBank,
                                                     ChannelizerBankConfig,
                                                     ChannelSettings)
from pysdr_tpu_torch.tables import Mode

torch.set_num_threads(1)

N = 8
FC = 100e6


def configs(fs_ch, out_block=2048, **kw):
    """The same bank for both packages: (port config, JAX config)."""
    def make(cfg_cls, set_cls, mode):
        return cfg_cls(fs_in=N * fs_ch, n_channels=N, fs_out=48e3,
                       out_block=out_block, fc_hz=FC,
                       channels=tuple(set_cls(mode=mode.AM, **kw)
                                      for _ in range(N)))
    return make(ChannelizerBankConfig, ChannelSettings, Mode), \
        make(JaxConfig, JaxSettings, JMode)


def station_blocks(cfg, n_blocks, fm_channel=5):
    """One station per channel center (AM, an FM one on fm_channel) over
    a noise floor, as consecutive host blocks."""
    offs = cfg.center_freqs_hz() - cfg.fc_hz
    specs = [synth.SignalSpec(offset_hz=float(offs[c]),
                              mode="fm" if c == fm_channel else "am",
                              amplitude=0.3, audio_hz=300.0 + 100.0 * c)
             for c in range(N)]
    src = synth.SynthSource(specs, cfg.fs_in, noise_rms=0.05, seed=7)
    in_block = cfg.plan.in_block * N
    return [np.asarray(src.read_data(in_block), np.complex64)
            for _ in range(n_blocks)]


def snr_db(got, ref):
    err = (np.abs(got - ref) ** 2).mean()
    return -10 * np.log10(max(err / max((np.abs(ref) ** 2).mean(), 1e-30),
                              1e-30))


def assert_parity(tb, jb, x, tag):
    a_t, a_j = tb.step(x), np.asarray(jb.step(x))
    assert a_t.shape == a_j.shape == (N, tb.design.out_block)
    for c in range(N):
        s = snr_db(a_t[c], a_j[c])
        assert s >= 80.0, (tag, c, s)
    return a_t


def np_tree(t):
    """JAX NamedTuple tree -> nested dict of numpy leaves."""
    if hasattr(t, "_asdict"):
        return {k: np_tree(v) for k, v in t._asdict().items()}
    return np.asarray(t)


def test_constants_params_and_facade_match():
    tcfg, jcfg = configs(192e3)
    tb, jb = ChannelizerBank(tcfg, device="cpu"), JaxBank(jcfg)
    np.testing.assert_array_equal(tb.branch_weights.numpy(),
                                  jb.branch_weights)
    np.testing.assert_array_equal(tb.video_bank.numpy(), jb.video_bank)
    np.testing.assert_array_equal(tb.carrier_taps.numpy(),
                                  jcplx.unpack(jb.carrier_taps))
    np.testing.assert_array_equal(tb.pilot_taps.numpy(),
                                  jcplx.unpack(jb.pilot_taps))
    for f in ("fs_in", "fs_out", "in_block", "out_block", "up", "down"):
        assert getattr(tb.design, f) == getattr(jb.design, f), f
    assert tb.n_rx == jb.n_rx == N
    assert (tb.design.up, tb.design.down) == (1, 4)
    np.testing.assert_array_equal(tcfg.center_freqs_hz(),
                                  jcfg.center_freqs_hz())
    js = np_tree(jcplx.unpack_tree(jb.state, jb._state_mask))
    assert tb.state.chan_hist.shape == js["chan_hist"].shape
    assert tb.state.rs_hist.shape == js["rs_hist"].shape
    pj = np_tree(jb.params)
    np.testing.assert_array_equal(tb.params.nco_k.numpy(), pj["nco_k"])
    np.testing.assert_array_equal(tb.params.demod.af_taps.numpy(),
                                  jcplx.unpack(pj["demod"]["af_taps"]))
    assert tb.channel_of(FC + 96e3 + 5e3) == jb.channel_of(FC + 96e3 + 5e3)


@pytest.mark.parametrize("fs_ch", [48e3, 192e3])
def test_bank_matches_jax_per_channel(fs_ch):
    """The 1:1 plan and the decimating 4:1 plan of BASELINE config 5."""
    tcfg, jcfg = configs(fs_ch)
    tb, jb = ChannelizerBank(tcfg, device="cpu"), JaxBank(jcfg)
    a = [assert_parity(tb, jb, x, blk)
         for blk, x in enumerate(station_blocks(tcfg, 3))]
    # the stations decode in their own channels
    audio = np.concatenate(a, axis=1)[:, 2048:].real
    for c in (1, 3, 6):
        sp = np.abs(np.fft.rfft(audio[c] * np.hanning(audio.shape[1])))
        f = np.fft.rfftfreq(audio.shape[1], 1 / 48e3)
        assert abs(f[5 + np.argmax(sp[5:])] - (300.0 + 100.0 * c)) < 15.0


def test_retune_mode_change_and_mute_match_jax():
    tcfg, jcfg = configs(48e3)
    tb, jb = ChannelizerBank(tcfg, device="cpu"), JaxBank(jcfg)
    params0 = map_tensors(torch.clone, tb.params)
    bound = tb.params
    for blk, x in enumerate(station_blocks(tcfg, 4)):
        if blk == 1:
            for b, M in ((tb, Mode), (jb, JMode)):
                b.retune(2, 5e3)
                b.set_mode(5, M.NFM)
        if blk == 2:
            for b in (tb, jb):
                b.set_mute(5, True)
                b.set_af_gain(3, 0.5)
        a_t = assert_parity(tb, jb, x, blk)
        if blk >= 2:
            assert np.abs(a_t[5]).max() == 0.0
    # a knob rewrites one row of the bank's params, in place (a captured
    # step reads those tensors)
    assert params0.nco_k[2].item() == 0 and tb.params.nco_k[2].item() != 0
    assert tb.params is bound
    np.testing.assert_array_equal(
        np.delete(tb.params.nco_k.numpy(), 2),
        np.delete(params0.nco_k.numpy(), 2))
    np.testing.assert_array_equal(tb.params.nco_k.numpy(),
                                  np.asarray(jb.params.nco_k))
    np.testing.assert_array_equal(tb.state.nco_phase.numpy(),
                                  np.asarray(jb.state.nco_phase))


def test_streaming_equals_batch():
    """Four blocks in a stream equal one block four times as long, and
    both match the JAX bank's batch run."""
    tcfg, jcfg = configs(192e3, out_block=1024, agc_enabled=False)
    bcfg, jbcfg = configs(192e3, out_block=4096, agc_enabled=False)
    x = np.concatenate(station_blocks(tcfg, 4))
    tb = ChannelizerBank(tcfg, device="cpu")
    stream = np.concatenate([tb.step(b) for b in np.split(x, 4)], axis=1)
    batch = ChannelizerBank(bcfg, device="cpu").step(x)
    np.testing.assert_allclose(stream, batch, atol=2e-4)
    ref = np.asarray(JaxBank(jbcfg).step(x))
    for c in range(N):
        assert snr_db(stream[c], ref[c]) >= 80.0, c


def test_jax_state_carries_into_port():
    tcfg, jcfg = configs(192e3)
    jb = JaxBank(jcfg)
    xs = station_blocks(tcfg, 4)
    jb.set_mode(5, JMode.NFM)
    jb.retune(2, -3e3)
    for x in xs[:2]:
        jb.step(x)
    tb = ChannelizerBank(tcfg, device="cpu")
    state = np_tree(jcplx.unpack_tree(jb.state, jb._state_mask))
    params = np_tree(jb.params)
    params["demod"]["af_taps"] = jcplx.unpack(params["demod"]["af_taps"])
    convert.chanbank_state_from_numpy(tb, state)
    convert.chanbank_params_from_numpy(tb, params)
    assert tb.state.nco_phase.dtype == torch.int64
    assert tb.state.chan_hist.dtype == torch.complex64
    for blk, x in enumerate(xs[2:]):
        assert_parity(tb, jb, x, blk + 2)


def test_audio_wire_i8_within_one_code():
    tcfg, jcfg = configs(192e3)
    tb = ChannelizerBank(tcfg, audio_wire="i8", device="cpu")
    jb = JaxBank(jcfg, audio_wire="i8")
    for x in station_blocks(tcfg, 2):
        got = tb.step_device(tb.to_device_block(x)).numpy()
        ref = np.asarray(jb.step_device(jcplx.to_device(x)))
        assert got.dtype == ref.dtype == np.int8
        assert np.abs(got.astype(np.int32) - ref.astype(np.int32)).max() <= 1


def test_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        ChannelizerBank(configs(48e3)[0])
