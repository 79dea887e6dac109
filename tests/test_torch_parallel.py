"""The port's stream-axis sharding (pysdr_tpu_torch/parallel/stream.py,
adapter.py) on a grid of the one CPU device repeated, against the JAX
package's processors on its 8-virtual-device CPU mesh (>= 80 dB audio per
channel, carried phase bases bit-equal) and against the port's serial
bank at the floors of tests/test_sharded_streaming.py and
tests/test_stream_parallel.py."""

import ctypes
import gc

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pysdr_tpu.config import PipelineConfig as JPipelineConfig
from pysdr_tpu.config import ReceiverConfig as JReceiverConfig
from pysdr_tpu.models.receiver import ReceiverBank as JReceiverBank
from pysdr_tpu.ops import cplx as jcplx
from pysdr_tpu.parallel import mesh as jmesh
from pysdr_tpu.parallel import stream as jstream
from pysdr_tpu.tables import Mode as JMode
from pysdr_tpu_torch.config import PipelineConfig, ReceiverConfig
from pysdr_tpu_torch.io import synth
from pysdr_tpu_torch.models.receiver import ReceiverBank
from pysdr_tpu_torch.parallel import mesh as mesh_mod
from pysdr_tpu_torch.parallel import stream as stream_mod
from pysdr_tpu_torch.parallel.adapter import ShardedStreamBank, build_mesh
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

FS = 512e3
FC0 = 10e6


def snr_db(ref, got):
    """Per-channel SNR of got against ref (rows), dB."""
    err = np.sum(np.abs(got - ref) ** 2, axis=-1)
    return 10 * np.log10(np.sum(np.abs(ref) ** 2, axis=-1)
                         / np.maximum(err, 1e-30))


def rx_kw(n_ch, modes, agc, squelch_db):
    return [dict(fc_hz=FC0 + 40e3 * i, mode=modes[i % len(modes)],
                 agc_enabled=agc, squelch_db=squelch_db)
            for i in range(n_ch)]


def make_bank(n_ch=1, out_block=1024, modes=(Mode.AM,), agc=False,
              squelch_db=-150.0, **kw):
    rxs = tuple(ReceiverConfig(**r)
                for r in rx_kw(n_ch, modes, agc, squelch_db))
    cfg = PipelineConfig(fs_in=FS, fs_out=48e3, out_block=out_block,
                         foffset_hz=60e3, receivers=rxs)
    return ReceiverBank(cfg, device="cpu", **kw)


def make_jbank(n_ch, out_block, modes, agc, squelch_db):
    rxs = tuple(JReceiverConfig(**{**r, "mode": JMode(int(r["mode"]))})
                for r in rx_kw(n_ch, modes, agc, squelch_db))
    return JReceiverBank(JPipelineConfig(
        fs_in=FS, fs_out=48e3, out_block=out_block, foffset_hz=60e3,
        receivers=rxs))


def cpu_mesh(n_stream, n_ch):
    return mesh_mod.make_mesh(n_stream, n_ch,
                              devices=["cpu"] * (n_stream * n_ch))


def stations(bank, n, noise=0.01, mode="am"):
    offs = bank.cfg.channel_offsets_hz()
    specs = [synth.SignalSpec(offset_hz=o, mode=mode,
                              audio_hz=500.0 + 200 * i)
             for i, o in enumerate(offs)]
    return synth.render(specs, FS, n, noise_rms=noise)


def serial_audio(bank, x):
    blocks = np.split(np.asarray(x), len(x) // bank.design.in_block)
    return np.concatenate([bank.step(b) for b in blocks], axis=1)


def pairs(x):
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(x, np.complex64).view(np.float32).reshape(-1, 2)))


def sharded_audio(adapter, x):
    ib = adapter.design.in_block
    return np.concatenate(
        [adapter.audio_from_wire(adapter.step_device(pairs(b)))
         for b in np.split(np.asarray(x), len(x) // ib)], axis=1)


# ---- against the JAX processors ----

@pytest.mark.parametrize("n_stream,n_ch", [(2, 1), (4, 1), (2, 2)])
def test_streaming_processor_matches_jax(n_stream, n_ch):
    """Three calls of the state-continuous processor (AM and NFM, AGC and
    squelch on): audio >= 80 dB against the JAX processor's on the same
    blocks, the carried NCO/BFO bases bit-equal, the carried tail equal."""
    modes, n_rx = (Mode.AM, Mode.NFM), 2
    tb = make_bank(n_rx, 129, modes, agc=True, squelch_db=-60.0)
    jb = make_jbank(n_rx, 129, modes, True, -60.0)
    seg = 4 * tb.design.in_block
    tproc, halo = stream_mod.make_streaming_processor(
        tb, cpu_mesh(n_stream, n_ch), seg)
    jproc, jhalo = jstream.make_streaming_processor(
        jb, jmesh.make_mesh(n_stream, n_ch), seg)
    assert halo == jhalo == seg
    t_state = (torch.zeros((halo, 2)), torch.zeros(n_rx, dtype=torch.int64),
               torch.zeros(n_rx, dtype=torch.int64), tb.state.ch.demod)
    j_state = (jnp.zeros((halo, 2), jnp.float32),
               jnp.zeros(n_rx, jnp.int32), jnp.zeros(n_rx, jnp.int32),
               jb.state.ch.demod)
    x = stations(tb, 3 * n_stream * seg)
    m = cpu_mesh(n_stream, n_ch)
    for call, blk in enumerate(np.split(x, 3)):
        xp = jcplx.pack(blk.astype(np.complex64))
        ta, nb, bb, tail, dst, _ = tproc(torch.from_numpy(xp), tb.params,
                                         *t_state)
        ja, jnb, jbb, jtail, jdst, _ = jproc(jnp.asarray(xp), jb.params,
                                             *j_state)
        t_state, j_state = (tail, nb, bb, dst), (jtail, jnb, jbb, jdst)
        got = torch.view_as_complex(mesh_mod.gather(ta, m)).numpy()
        ref = jcplx.unpack(np.asarray(ja))
        assert got.shape == ref.shape
        assert snr_db(ref, got).min() >= 80.0, (call, snr_db(ref, got))
        np.testing.assert_array_equal(nb.numpy(), np.asarray(jnb))
        np.testing.assert_array_equal(bb.numpy(), np.asarray(jbb))
        np.testing.assert_array_equal(tail.numpy(), np.asarray(jtail))
        np.testing.assert_array_equal(dst.bfo_phase.numpy(),
                                      np.asarray(jdst.bfo_phase))


@pytest.mark.parametrize("n_stream", [2, 4])
def test_process_stream_matches_jax(n_stream):
    """The one-shot processor (cold every call) on a CW receiver, whose
    BFO phase is analytic across shards: >= 80 dB against JAX's."""
    tb = make_bank(1, 129, (Mode.CW,))
    jb = make_jbank(1, 129, (Mode.CW,), False, -150.0)
    x = stations(tb, n_stream * 4 * tb.design.in_block, mode="cw")
    got = stream_mod.process_stream(tb, x, cpu_mesh(n_stream, 1))
    ref = np.asarray(jstream.process_stream(
        jb, jnp.asarray(x), jmesh.make_mesh(n_stream, 1)))
    assert snr_db(ref, got).min() >= 80.0


# ---- against the port's serial bank ----

@pytest.mark.parametrize("n_stream,n_ch_mesh", [(2, 1), (4, 1), (2, 2)])
def test_streaming_sharded_matches_serial_multiblock(n_stream, n_ch_mesh):
    """AGC off: > 55 dB against the serial bank after the first settle,
    across every super-block boundary."""
    n_rx = max(n_ch_mesh, 2)
    bank_s = make_bank(n_rx, 9600)
    x = stations(bank_s, bank_s.design.in_block * n_stream * 4)
    ref = serial_audio(bank_s, x)
    ad = ShardedStreamBank(make_bank(n_rx, 9600),
                           cpu_mesh(n_stream, n_ch_mesh))
    got = sharded_audio(ad, x)
    assert got.shape == ref.shape
    skip = 16384
    assert snr_db(ref[:, skip:], got[:, skip:]).min() > 55.0


@pytest.mark.parametrize("squelch_db", [-150.0, -60.0])
def test_streaming_sharded_agc_on_snr(squelch_db):
    """AGC on (and the squelch engaged, open on signal): > 30 dB against
    the serial bank after 1 s, over 4 super-blocks of 2 shards."""
    bank_s = make_bank(1, 9600, agc=True, squelch_db=squelch_db)
    x = stations(bank_s, bank_s.design.in_block * 8, noise=0.005)
    ref = serial_audio(bank_s, x)
    ad = ShardedStreamBank(make_bank(1, 9600, agc=True,
                                     squelch_db=squelch_db), cpu_mesh(2, 1))
    got = sharded_audio(ad, x)
    assert snr_db(ref[:, 48000:].real, got[:, 48000:].real).min() > 30.0


def test_streaming_sharded_audio_wire_i8_and_baseband():
    """The i8 (mu-law) audio wire is applied inside each shard (> 30 dB
    against the f32 sharded audio), and each shard's baseband reaches the
    adapter's baseband_from_wire as the serial bank's."""
    m = cpu_mesh(2, 1)
    ad_f = ShardedStreamBank(make_bank(1, 9600), m)
    ad_q = ShardedStreamBank(make_bank(1, 9600, audio_wire="i8",
                                       emit_baseband=True), m)
    bank_s = make_bank(1, 9600, emit_baseband=True)
    x = stations(bank_s, bank_s.design.in_block * 4, noise=0.001)
    a_f = sharded_audio(ad_f, x)
    outs, bbs = [], []
    for b in np.split(x, 2):
        pieces = ad_q.step_device(pairs(b))
        assert all(p.dtype == torch.int8 for p in pieces)
        outs.append(ad_q.audio_from_wire(pieces))
        bbs.append(ad_q.baseband_from_wire(ad_q._last_bb).numpy())
    a_q = np.concatenate(outs, axis=1)
    skip = 16384
    assert snr_db(a_f[:, skip:].real, a_q[:, skip:].real).min() > 30.0
    ref_bb = []
    for b in np.split(x, 4):
        bank_s.step(b)
        ref_bb.append(bank_s._last_bb.numpy())
    ref_bb = np.concatenate(ref_bb, axis=1)
    got_bb = np.concatenate(bbs, axis=1)
    assert snr_db(ref_bb[:, skip:], got_bb[:, skip:]).min() > 55.0


def test_streaming_sharded_control_change_applies_next_superblock():
    """A params change through the adapter (delegated to the inner bank)
    lands at super-block k exactly as at serial block k*S."""
    bank_s = make_bank(1, 9600)
    x = stations(bank_s, bank_s.design.in_block * 8, noise=0.0)
    outs = []
    for i, b in enumerate(np.split(x, 8)):
        if i == 4:
            bank_s.set_af_gain(0, 2.0)
        outs.append(bank_s.step(b))
    ref = np.concatenate(outs, axis=1)[0]
    ad = ShardedStreamBank(make_bank(1, 9600), cpu_mesh(2, 1))
    outs = []
    for i, b in enumerate(np.split(x, 4)):
        if i == 2:
            ad.set_af_gain(0, 2.0)
        outs.append(ad.audio_from_wire(ad.step_device(pairs(b))))
    got = np.concatenate(outs, axis=1)[0]
    skip = 16384
    assert snr_db(ref[skip:], got[skip:]) > 55.0
    mid = len(got) // 2
    assert np.std(got[mid + 4096:]) > 1.5 * np.std(got[skip:mid - 4096])


def test_adapter_setattr_forwards_to_bank():
    """The facade's write-through: an attribute the wrapped bank owns
    (on_device_retune) reaches the bank; adapter-owned state stays."""
    bank = make_bank(2, 9600)
    ad = ShardedStreamBank(bank, cpu_mesh(2, 1))
    cb = lambda c: None  # noqa: E731
    ad.on_device_retune = cb
    assert bank.on_device_retune is cb
    assert "on_device_retune" not in ad.__dict__
    ad._last_bb = "mine"
    assert ad.__dict__["_last_bb"] == "mine" and bank._last_bb != "mine"
    assert ad.device == torch.device("cpu") and ad.n_rx == 2


def test_adapter_and_mesh_refusals():
    with pytest.raises(ValueError, match="must divide"):
        ShardedStreamBank(make_bank(3, 9600), cpu_mesh(2, 2))
    with pytest.raises(ValueError, match="needs 4 devices"):
        mesh_mod.make_mesh(2, 2, devices=["cpu"] * 3)
    with pytest.raises(ValueError, match=">= 1"):
        build_mesh(0, 2, device="cpu")
    m = build_mesh(2, 3, device="cpu")
    assert m.shape == {"stream": 2, "ch": 3} and m.first.type == "cpu"
    assert mesh_mod.single_axis_mesh("stream", ["cpu"] * 4).shape == \
        {"stream": 4}
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="--device cpu"):
            build_mesh(1, 1, device="cuda")
