"""The reference forms the port carries beside its main path
(pysdr_tpu_torch/ops/resample.fir_block, fir_block_cmpx,
resample_block_real; models/receiver.channel_step), against numpy, the
port's own main-path forms and the JAX package: mirrors
tests/test_fftfilt.py:12-26, tests/test_resample.py:78-112 and
tests/test_receiver.py:343-397."""

import ctypes
import gc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pysdr_tpu import config as jconfig
from pysdr_tpu import tables as jtables
from pysdr_tpu.models import receiver as jreceiver
from pysdr_tpu.ops import cplx as jcplx
from pysdr_tpu.ops import resample as jresample
from pysdr_tpu_torch import config, tables
from pysdr_tpu_torch.io import synth
from pysdr_tpu_torch.models import receiver
from pysdr_tpu_torch.ops import fftfilt, fir, resample

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


def cnoise(rng, *shape):
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)


def snr_db(ref, got):
    err = np.sum(np.abs(got - ref) ** 2)
    return 10 * np.log10(np.sum(np.abs(ref) ** 2) / max(err, 1e-30))


def test_fir_block_cmpx_matches_fft_fir_block(rng):
    """The direct complex FIR == the overlap-save FIR, per row of a
    channel batch with each row's taps, history included."""
    t = 127
    taps = cnoise(rng, 3, t)
    x = cnoise(rng, 3, 4096)
    hist = cnoise(rng, 3, t - 1)
    args = [torch.from_numpy(a) for a in (x, hist, taps)]
    y_fft, h_fft = fftfilt.fft_fir_block(*args)
    y_dir, h_dir = resample.fir_block_cmpx(*args)
    np.testing.assert_allclose(y_dir.numpy(), y_fft.numpy(), atol=2e-4)
    np.testing.assert_array_equal(h_dir.numpy(), h_fft.numpy())
    for r in range(3):          # and each row is JAX's single-channel form
        yj, _ = jresample.fir_block_cmpx(*(jnp.asarray(a[r])
                                           for a in (x, hist, taps)))
        assert snr_db(np.asarray(yj), y_dir[r].numpy()) >= 80.0


def test_fir_block_real_taps(rng):
    x = cnoise(rng, 2048)
    h = fir.lowpass(101, 0.2, 2.0)
    y, _ = resample.fir_block(torch.from_numpy(x),
                              torch.zeros(100, dtype=torch.complex64),
                              torch.from_numpy(h))
    g = np.convolve(x, h.astype(np.float64))[:2048]
    np.testing.assert_allclose(y.numpy(), g.astype(np.complex64), atol=2e-5)
    xr = x.real.astype(np.float32)
    yr, hr = resample.fir_block(torch.from_numpy(xr), torch.zeros(100),
                                torch.from_numpy(h))
    np.testing.assert_allclose(yr.numpy(), np.convolve(xr, h)[:2048],
                               atol=2e-5)
    np.testing.assert_array_equal(hr.numpy(), xr[-100:])


def test_fir_block_cmpx_taps(rng):
    x = cnoise(rng, 2048)
    h = fir.complex_bandpass(300, 3000, 48e3, 129)
    y, _ = resample.fir_block_cmpx(torch.from_numpy(x),
                                   torch.zeros(128, dtype=torch.complex64),
                                   torch.from_numpy(h))
    g = np.convolve(x, h.astype(np.complex128))[:2048]
    np.testing.assert_allclose(y.numpy(), g.astype(np.complex64), atol=2e-5)


def test_streaming_fir_cmpx_state(rng):
    x = torch.from_numpy(cnoise(rng, 4096))
    h = torch.from_numpy(fir.complex_bandpass(200, 2800, 48e3, 257))
    y_full, _ = resample.fir_block_cmpx(
        x, torch.zeros(256, dtype=torch.complex64), h)
    hist = torch.zeros(256, dtype=torch.complex64)
    parts = []
    for i in range(0, 4096, 1024):
        y, hist = resample.fir_block_cmpx(x[i:i + 1024], hist, h)
        parts.append(y)
    np.testing.assert_allclose(torch.cat(parts).numpy(), y_full.numpy(),
                               atol=1e-5)


@pytest.mark.parametrize("up,down", [(3, 32), (1, 4), (2, 5)])
def test_resample_block_real_matches_jax(rng, up, down):
    """Real resample, per row, equals the JAX form on each row, streamed
    over two blocks; and the real part of the complex resample."""
    h = fir.lowpass(up * 16, 0.4 * min(1.0, up / down) * 1e3, up * 1e3)
    w = resample.pack_weights(h, up, down)
    kp1 = resample.history_len(len(h), up)
    x = rng.standard_normal((2, 2, 64 * down)).astype(np.float32)
    hist = torch.zeros((2, kp1))
    jhist = [jnp.zeros(kp1, jnp.float32) for _ in range(2)]
    wt = torch.from_numpy(np.stack([w, w]))
    for blk in range(2):
        y, hist = resample.resample_block_real(
            torch.from_numpy(x[blk]), hist, wt, up=up, down=down)
        yc, _ = resample.resample_block(
            torch.from_numpy(x[blk].astype(np.complex64)),
            torch.zeros((2, kp1), dtype=torch.complex64), wt, up=up,
            down=down)
        for r in range(2):
            yj, jhist[r] = jresample.resample_block_real(
                jnp.asarray(x[blk, r]), jhist[r], jnp.asarray(w), up=up,
                down=down)
            np.testing.assert_allclose(y[r].numpy(), np.asarray(yj),
                                       atol=2e-5)
        if blk == 0:
            np.testing.assert_array_equal(y.numpy(), yc.real.numpy())


def make_cfg(cfg_mod, Mode):
    return cfg_mod.PipelineConfig(
        fs_in=512e3, fs_out=48e3, out_block=3072, foffset_hz=60e3,
        receivers=(
            cfg_mod.ReceiverConfig(fc_hz=10e6, mode=Mode.AM),
            cfg_mod.ReceiverConfig(fc_hz=10.03e6, mode=Mode.NFM),
            cfg_mod.ReceiverConfig(fc_hz=9.97e6, mode=Mode.USB),
            cfg_mod.ReceiverConfig(fc_hz=10.06e6, mode=Mode.CW)))


def test_fused_step_matches_per_channel_reference_form():
    """The bank's fused step (mixed_resample_bank + the batched demod)
    equals channel_step (mix_down -> resample_block -> demod) > 80 dB
    over three blocks, and channel_step equals the JAX channel_step >= 80
    dB, its phases bit-equal."""
    cfg = make_cfg(config, tables.Mode)
    bank = receiver.ReceiverBank(cfg, device="cpu")
    jbank = jreceiver.ReceiverBank(make_cfg(jconfig, jtables.Mode))
    d, jd = bank.design, jbank.design
    src = synth.SynthSource([synth.SignalSpec(offset_hz=60e3, mode="am",
                                              audio_hz=700.0)],
                            fs=cfg.fs_in, noise_rms=0.05)
    hist = torch.zeros(bank.state.hist.shape, dtype=torch.complex64)
    ch = bank.state.ch
    jst = jcplx.unpack_tree(jbank.state, jbank._state_mask)
    jhist, jch = jst.hist, jst.ch
    jstep = jax.jit(jax.vmap(lambda c, p, x, h: jreceiver.channel_step(
        x, h, c, p, jd, jbank.video_bank, jbank.carrier_taps,
        jbank.pilot_taps), in_axes=(0, 0, None, None)))
    for blk in range(3):
        x = np.asarray(src.read_data(d.in_block), np.complex64)
        xt = torch.from_numpy(x)
        a_ref, ch, _ = receiver.channel_step(
            xt, hist, ch, bank.params, d, bank.video_bank,
            bank.carrier_taps, bank.pilot_taps)
        hist = xt[-hist.shape[0]:]
        a_new = bank.step(x)
        aj, jch, _ = jstep(jch, jbank.params, jnp.asarray(x), jhist)
        jhist = jnp.asarray(x[-jhist.shape[0]:])
        for r in range(bank.n_rx):
            assert snr_db(a_ref[r].numpy(), a_new[r]) > 80.0, (blk, r)
            assert snr_db(np.asarray(aj[r]), a_ref[r].numpy()) >= 80.0
        np.testing.assert_array_equal(ch.nco_phase.numpy(),
                                      np.asarray(jch.nco_phase))
