"""The port's channel sharding of the ChannelizerBank
(pysdr_tpu_torch/parallel/chanshard.py, adapter.ShardedChannelizerBank)
on grids of the one CPU device, against the port's serial bank and the
JAX package's sharded channelizer on its 8-virtual-device CPU mesh
(mirrors tests/test_chanshard.py and the channelizer case of
tests/test_sharded_streaming.py)."""

import ctypes
import gc

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pysdr_tpu.models.channelizer_bank import ChannelizerBank as JBank
from pysdr_tpu.models.channelizer_bank import (
    ChannelizerBankConfig as JConfig, ChannelSettings as JSettings)
from pysdr_tpu.ops import cplx as jcplx
from pysdr_tpu.parallel import chanshard as jchanshard
from pysdr_tpu.parallel import mesh as jmesh
from pysdr_tpu.tables import Mode as JMode
from pysdr_tpu_torch.models.channelizer_bank import (ChannelizerBank,
                                                     ChannelizerBankConfig,
                                                     ChannelSettings)
from pysdr_tpu_torch.parallel import chanshard
from pysdr_tpu_torch.parallel import mesh as mesh_mod
from pysdr_tpu_torch.parallel.adapter import ShardedChannelizerBank
from pysdr_tpu_torch.tables import Mode

torch.set_num_threads(1)


@pytest.fixture(autouse=True, scope="module")
def release_heap():
    """After this module, give its freed heap back to the OS, so that the
    next test module in this worker process (tests/test_parity.py's RSS
    growth check among them) starts without megabytes of free but
    resident heap that a new allocation would reuse unseen."""
    yield
    gc.collect()
    getattr(ctypes.CDLL(None), "malloc_trim", lambda pad: 0)(0)
# short test segments leave the recurrences part-settled, by design
pytestmark = pytest.mark.filterwarnings("ignore:stream segment")


def snr_db(ref, got):
    err = np.sum(np.abs(got - ref) ** 2, axis=-1)
    return 10 * np.log10(np.sum(np.abs(ref) ** 2, axis=-1)
                         / np.maximum(err, 1e-30))


def cfg_kw(n, fs_ch, out_block, agc, squelch_db):
    return dict(fs_in=n * fs_ch, n_channels=n, fs_out=48e3,
                out_block=out_block, fc_hz=100e6), \
        dict(mode=Mode.AM, agc_enabled=agc, squelch_db=squelch_db)


def make(n, fs_ch=48e3, out_block=1024, agc=False, squelch_db=-150.0,
         **kw):
    c, s = cfg_kw(n, fs_ch, out_block, agc, squelch_db)
    return ChannelizerBank(ChannelizerBankConfig(
        **c, channels=tuple(ChannelSettings(**s) for _ in range(n))),
        device="cpu", **kw)


def make_jax(n, fs_ch=48e3, out_block=1024, agc=False, squelch_db=-150.0):
    c, s = cfg_kw(n, fs_ch, out_block, agc, squelch_db)
    s["mode"] = JMode(int(s["mode"]))
    return JBank(JConfig(**c, channels=tuple(JSettings(**s)
                                             for _ in range(n))))


def synth(cb, n_blocks, chans=(1, 3, 6), noise=0.0):
    """AM stations on channel centers, 300 Hz x (i+1) tones, over a
    noise floor of `noise` rms."""
    n_ch = cb.cfg.n_channels
    offs = np.fft.fftfreq(n_ch, 1.0 / cb.cfg.fs_in)
    n = cb.design.in_block * n_blocks
    t = np.arange(n) / cb.cfg.fs_in
    rng = np.random.default_rng(n_blocks)
    x = noise * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
    for i, c in enumerate(chans):
        m = 0.5 * np.sin(2 * np.pi * 300.0 * (i + 1) * t)
        x = x + (1 + m) * np.exp(2j * np.pi * offs[c] * t)
    return x.astype(np.complex64)


def cpu_grid(n_stream, n_ch):
    return mesh_mod.make_mesh(n_stream, n_ch,
                              devices=["cpu"] * (n_stream * n_ch))


def test_sharded_matches_local_8ch():
    """run_sharded over 4 channel shards == the serial bank, and == the
    JAX package's run_sharded over its 8 devices (>= 80 dB)."""
    cb = make(8)
    x = synth(cb, 3)
    got = chanshard.run_sharded(cb, x, mesh_mod.single_axis_mesh(
        "ch", ["cpu"] * 4), n_blocks=3)
    local = make(8)
    ref = np.concatenate([local.step(b) for b in np.split(x, 3)], axis=-1)
    np.testing.assert_allclose(got, ref, atol=2e-4)
    jref = jchanshard.run_sharded(make_jax(8), x,
                                  jmesh.single_axis_mesh("ch"), n_blocks=3)
    assert snr_db(jref, got).min() >= 80.0


def test_sharded_64ch_over_8_shards():
    """64 channels, 8 a shard — the BASELINE config-5 shape."""
    cb = make(64, out_block=512)
    a = chanshard.run_sharded(cb, synth(cb, 2, chans=(2, 17, 40, 63)),
                              mesh_mod.single_axis_mesh("ch", ["cpu"] * 8),
                              n_blocks=2)
    assert a.shape == (64, 1024)
    assert np.mean(np.abs(a[17, 512:])) > 10 * np.mean(np.abs(a[30, 512:]))


def test_stream_by_ch_one_shot_matches_jax_and_serial():
    """The one-shot 2 x 4 stream x ch processor: >= 80 dB against the
    JAX processor on the same input, and the serial bank past the first
    shard's warm-up (the bound of tests/test_chanshard.py)."""
    cb = make(8, out_block=512)
    seg, halo = 65536, 24576
    x = synth(cb, 2 * seg // cb.design.in_block, chans=(1, 5))[:2 * seg]
    proc, h = chanshard.make_channelizer_stream_processor(
        cb, cpu_grid(2, 4), seg, halo=halo)
    xp = jcplx.pack(x)
    got = mesh_mod.gather(proc(torch.from_numpy(xp), cb.params),
                          cpu_grid(2, 4)).numpy()
    jcb = make_jax(8, out_block=512)
    jm = jmesh.make_mesh(2, 4)
    jproc, jh = jchanshard.make_channelizer_stream_processor(
        jcb, jm, seg, halo=halo)
    _, specs = jchanshard.make_channelizer_processor(jcb, jm)
    _, params, w_re, w_im = jchanshard.shard_inputs(jcb, jm, specs)
    from jax.sharding import NamedSharding, PartitionSpec as P
    import jax
    ref = jcplx.unpack(np.asarray(jproc(
        jax.device_put(xp, NamedSharding(jm, P("stream"))), params, w_re,
        w_im)))
    assert h == jh and got.shape == ref.shape
    assert snr_db(ref[[1, 5]], got[[1, 5]]).min() >= 80.0
    ref_bank = make(8, out_block=512)
    serial = np.concatenate([ref_bank.step(b) for b in
                             np.split(x, 2 * seg // cb.design.in_block)],
                            axis=-1)
    aseg = seg * cb.plan.up // (cb.plan.down * 8)
    ahalo = halo * cb.plan.up // (cb.plan.down * 8)
    for c in (1, 5):
        scale = np.abs(serial[c]).max()
        for sl in (slice(ahalo + 512, aseg), slice(aseg + 16, 2 * aseg)):
            assert np.abs(got[c, sl] - serial[c, sl]).max() / scale < 0.05


@pytest.mark.parametrize("grid", [(1, 4), (2, 2)])
def test_streaming_channelizer_matches_jax(grid):
    """Two calls of the state-continuous channelizer processor (AGC and
    squelch on, stations over a noise floor as in
    tests/test_torch_channelizer_bank.py): >= 80 dB per station channel
    against the JAX processor, the carried bases bit-equal."""
    s, c = grid
    cb, jcb = make(8, 96e3, 128, True, -60.0), \
        make_jax(8, 96e3, 128, True, -60.0)
    # a 21 ms segment and halo: with a halo of a few ms the squelch
    # latch's first decisions, on power envelopes still settling from
    # zero, are left to rounding in either package
    seg = 8 * cb.design.in_block
    proc, halo = chanshard.make_channelizer_streaming_processor(
        cb, cpu_grid(s, c), seg)
    jm = jmesh.make_mesh(s, c)
    jproc, jhalo = jchanshard.make_channelizer_streaming_processor(
        jcb, jm, seg)
    _, specs = jchanshard.make_channelizer_processor(jcb, jm)
    _, _, w_re, w_im = jchanshard.shard_inputs(jcb, jm, specs)
    assert halo == jhalo
    st = (torch.zeros((halo, 2)), torch.zeros(8, dtype=torch.int64),
          torch.zeros(8, dtype=torch.int64), cb.state.demod)
    jst = (jnp.zeros((halo, 2), jnp.float32), jnp.zeros(8, jnp.int32),
           jnp.zeros(8, jnp.int32), jcb.state.demod)
    x = synth(cb, 2 * s * 8, chans=(0, 4), noise=0.05)
    for blk in np.split(x, 2):
        xp = jcplx.pack(blk)
        a, nb, bb, tail, dst = proc(torch.from_numpy(xp), cb.params, *st)
        ja, jnb, jbb, jtail, jdst = jproc(jnp.asarray(xp), jcb.params,
                                          w_re, w_im, *jst)
        st, jst = (tail, nb, bb, dst), (jtail, jnb, jbb, jdst)
        got = torch.view_as_complex(mesh_mod.gather(a, cpu_grid(s, c))) \
            .numpy()
        ref = jcplx.unpack(np.asarray(ja))
        assert snr_db(ref[[0, 4]], got[[0, 4]]).min() >= 80.0
        np.testing.assert_array_equal(nb.numpy(), np.asarray(jnb))
        np.testing.assert_array_equal(bb.numpy(), np.asarray(jbb))


@pytest.mark.parametrize("agc,squelch_db,floor", [(False, -150.0, 55.0),
                                                  (True, -60.0, 30.0)])
def test_streaming_sharded_channelizer_multiblock(agc, squelch_db, floor):
    """The adapter over a 2 x 4 grid, 4 super-blocks: the station
    channels against the serial bank after the settle, > 55 dB with AGC
    off and > 30 dB with AGC and squelch on."""
    kw = dict(n=8, fs_ch=96e3, out_block=9600, agc=agc,
              squelch_db=squelch_db)
    cb_s = make(**kw)
    x = synth(cb_s, 8, chans=(0, 2, 4, 6))
    ref = np.concatenate([cb_s.step(b) for b in np.split(x, 8)], axis=1)
    ad = ShardedChannelizerBank(make(**kw), cpu_grid(2, 4))
    assert ad.n_rx == 8 and ad.design.in_block == 2 * cb_s.design.in_block
    outs = []
    for b in np.split(x, 4):
        xp = torch.from_numpy(b.view(np.float32).reshape(-1, 2))
        outs.append(ad.audio_from_wire(ad.step_device(xp)))
    got = np.concatenate(outs, axis=1)
    skip = 48000 if agc else 16384
    chans = [0, 2, 4, 6]
    assert snr_db(ref[chans, skip:], got[chans, skip:]).min() > floor


def test_channel_chain_is_the_step():
    """n_ch, and channel_chain over the FFT's columns is the bank's own
    step (bit for bit: the step calls it)."""
    cb, ref = make(8), make(8)
    assert cb.n_ch == cb.n_rx == 8
    x = synth(cb, 1)
    xp = torch.from_numpy(x.view(np.float32).reshape(-1, 2))
    from pysdr_tpu_torch.ops import channelizer as chan_ops
    st = cb.state
    v, _ = chan_ops.branch_filter(xp, st.chan_hist, cb.branch_weights)
    audio, ph, rh, dst = cb.channel_chain(
        chan_ops.channel_transform(v).T, st.nco_phase, st.rs_hist,
        st.demod, cb.params)
    np.testing.assert_array_equal(audio.numpy(), ref.step(x))
    np.testing.assert_array_equal(ph.numpy(), ref.state.nco_phase.numpy())
    np.testing.assert_array_equal(rh.numpy(), ref.state.rs_hist.numpy())
