"""Parity of the torch port's scans, AGC, overlap-save FIR and fused
mix+resample against pysdr_tpu (JAX on the CPU). On the CPU the scans run
their plain torch twins; tests/test_torch_kernels.py holds the CUDA
kernels against those twins."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pysdr_tpu.ops import agc as jagc
from pysdr_tpu.ops import fftfilt as jfftfilt
from pysdr_tpu.ops import fir
from pysdr_tpu.ops import nco as jnco
from pysdr_tpu.ops import resample as jresample
from pysdr_tpu.ops import scanops as jscan
from pysdr_tpu_torch.ops import agc, fftfilt, resample, scanops

torch.set_num_threads(1)

# one compiled executable per shape instead of op-by-op dispatch
j_linrec = jax.jit(jscan.linrec)
j_one_pole = jax.jit(jscan.one_pole)
j_sr_latch = jax.jit(jscan.sr_latch)


def snr_db(got, ref):
    err = (np.abs(got - ref) ** 2).mean()
    return -10 * np.log10(max(err / max((np.abs(ref) ** 2).mean(), 1e-30),
                              1e-30))


def rel_err(got, ref):
    return np.abs(np.asarray(got) - np.asarray(ref)).max() / \
        max(np.abs(np.asarray(ref)).max(), 1e-30)


@pytest.mark.parametrize("shape", [(24576,), (3072, 4), (384, 1), (1, 2)])
def test_linrec_matches_jax(shape):
    rng = np.random.default_rng(len(shape) * 100 + shape[0])
    a = rng.uniform(0.9, 1.0, shape).astype(np.float32)
    b = rng.uniform(0.0, 1.0, shape).astype(np.float32)
    y_prev = rng.uniform(0, 1, shape[1:]).astype(np.float32)
    y, last = scanops.linrec(torch.from_numpy(a), torch.from_numpy(b),
                             torch.from_numpy(y_prev))
    yr, lastr = j_linrec(jnp.asarray(a), jnp.asarray(b),
                         jnp.asarray(y_prev))
    assert y.shape == yr.shape and last.shape == lastr.shape
    assert rel_err(y.numpy(), yr) <= 1e-5
    assert rel_err(last.numpy(), lastr) <= 1e-5


def test_linrec_batched_rows_equal_single():
    rng = np.random.default_rng(4)
    a = rng.uniform(0.9, 1.0, (3, 1000, 2)).astype(np.float32)
    b = rng.standard_normal((3, 1000, 2)).astype(np.float32)
    yp = rng.standard_normal((3, 2)).astype(np.float32)
    y, last = scanops.linrec(torch.from_numpy(a), torch.from_numpy(b),
                             torch.from_numpy(yp))
    for i in range(3):
        yi, li = scanops.linrec(torch.from_numpy(a[i]), torch.from_numpy(b[i]),
                                torch.from_numpy(yp[i]))
        np.testing.assert_array_equal(y[i].numpy(), yi.numpy())
        np.testing.assert_array_equal(last[i].numpy(), li.numpy())


def test_one_pole_matches_jax_and_is_block_invariant():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((4096, 4)).astype(np.float32)
    alpha = np.array([0.1, 0.01, 0.001, 0.5], np.float32)
    y0 = np.zeros(4, np.float32)
    y, last = scanops.one_pole(torch.from_numpy(x), torch.from_numpy(alpha),
                               torch.from_numpy(y0))
    yr, _ = j_one_pole(jnp.asarray(x), jnp.asarray(alpha),
                       jnp.asarray(y0))
    assert rel_err(y.numpy(), yr) <= 1e-5
    parts, carry = [], torch.from_numpy(y0)
    for i in range(0, 4096, 1000):
        yi, carry = scanops.one_pole(torch.from_numpy(x[i:i + 1000]),
                                     torch.from_numpy(alpha), carry)
        parts.append(yi.numpy())
    assert rel_err(np.concatenate(parts), y.numpy()) <= 1e-5
    assert rel_err(carry.numpy(), last.numpy()) <= 1e-5


def test_sr_latch_exact():
    rng = np.random.default_rng(6)
    for g_prev in (0.0, 1.0):
        s = rng.random(5000) < 0.01
        r = rng.random(5000) < 0.01
        s[:50] = r[:50] = False          # the head holds g_prev
        s[100] = r[100] = True           # set wins a tie
        gate, last = scanops.sr_latch(torch.from_numpy(s),
                                      torch.from_numpy(r), g_prev)
        gr, lr = j_sr_latch(jnp.asarray(s), jnp.asarray(r),
                            jnp.float32(g_prev))
        np.testing.assert_array_equal(gate.numpy(), np.asarray(gr))
        assert float(last) == float(lr)
    # batched rows with per-row g_prev
    s = rng.random((4, 3000)) < 0.005
    r = rng.random((4, 3000)) < 0.005
    gp = np.array([0.0, 1.0, 0.0, 1.0], np.float32)
    gate, last = scanops.sr_latch(torch.from_numpy(s), torch.from_numpy(r),
                                  torch.from_numpy(gp))
    for i in range(4):
        gr, lr = j_sr_latch(jnp.asarray(s[i]), jnp.asarray(r[i]),
                            jnp.float32(gp[i]))
        np.testing.assert_array_equal(gate[i].numpy(), np.asarray(gr))
        assert float(last[i]) == float(lr)


@pytest.mark.parametrize("enabled", [True, False])
def test_agc_matches_jax_and_is_block_invariant(enabled):
    rng = np.random.default_rng(7)
    n = 6144
    env = np.where(np.arange(n) < n // 2, 0.05, 0.8)
    x = (env * (rng.standard_normal(n) + 1j * rng.standard_normal(n))) \
        .astype(np.complex64)
    p = agc.AGCParams()
    y, e, g = agc.agc_block(torch.from_numpy(x), torch.tensor(0.1), p,
                            enabled=enabled)
    yr, er, gr = jagc.agc_block(jnp.asarray(x), jnp.float32(0.1),
                                jagc.AGCParams(), enabled=enabled)
    assert rel_err(y.numpy(), yr) <= 1e-5
    assert rel_err(e.numpy(), er) <= 1e-5
    assert rel_err(g.numpy(), gr) <= 1e-5
    # chunked (multiple of the 64-sample window) == whole
    parts, carry = [], torch.tensor(0.1)
    for i in range(0, n, 1024):
        yi, carry, _ = agc.agc_block(torch.from_numpy(x[i:i + 1024]),
                                     carry, p, enabled=enabled)
        parts.append(yi.numpy())
    assert rel_err(np.concatenate(parts), y.numpy()) <= 1e-5
    # channel-batched form equals per-channel calls
    xb = torch.from_numpy(np.stack([x, x[::-1].copy()]))
    yb, eb, _ = agc.agc_block(xb, torch.tensor([0.1, 0.2]), p,
                              enabled=torch.tensor([enabled, True]))
    np.testing.assert_allclose(yb[0].numpy(), y.numpy(), rtol=1e-6,
                               atol=1e-6)


def test_fft_fir_block_matches_jax():
    rng = np.random.default_rng(8)
    taps = fir.complex_bandpass(200, 2800, 48e3, 256)
    x = (rng.standard_normal(3072) + 1j * rng.standard_normal(3072)) \
        .astype(np.complex64)
    hist = (rng.standard_normal(255) + 1j * rng.standard_normal(255)) \
        .astype(np.complex64)
    y, h = fftfilt.fft_fir_block(torch.from_numpy(x), torch.from_numpy(hist),
                                 torch.from_numpy(taps))
    yr, hr = jfftfilt.fft_fir_block(jnp.asarray(x), jnp.asarray(hist),
                                    jnp.asarray(taps))
    assert snr_db(y.numpy(), np.asarray(yr)) >= 100.0
    np.testing.assert_array_equal(h.numpy(), np.asarray(hr))
    # batched with per-row taps
    xb = torch.from_numpy(np.stack([x, 2 * x]))
    yb, _ = fftfilt.fft_fir_block(
        xb, torch.from_numpy(np.stack([hist, 2 * hist])),
        torch.from_numpy(np.stack([taps, taps])))
    assert snr_db(yb[1].numpy(), 2 * np.asarray(yr)) >= 100.0


@pytest.mark.parametrize("up,down", [(3, 500), (3, 125), (24, 625),
                                     (3, 128)])
def test_pack_weights_bit_equal(up, down):
    h = fir.lowpass(up * 40, 0.4 * min(1.0, up / down), 2.0,
                    scale=float(up))
    np.testing.assert_array_equal(resample.pack_weights(h, up, down),
                                  jresample.pack_weights(h, up, down))
    bank = np.stack([h, 0.5 * h])
    np.testing.assert_array_equal(resample.pack_weight_bank(bank, up, down),
                                  jresample.pack_weight_bank(bank, up, down))
    assert resample.history_len(len(h), up) == \
        jresample.history_len(len(h), up)


@pytest.mark.parametrize("up,down", [(3, 500), (3, 125), (24, 625)])
def test_mixed_resample_bank_matches_jax(up, down):
    rng = np.random.default_rng(up * 1000 + down)
    fs = 2.048e6
    n = down * max(64, 4096 // down)
    x = (rng.standard_normal(n) + 1j * rng.standard_normal(n)) \
        .astype(np.complex64)
    h = fir.lowpass(up * 64, 0.4 * min(1.0, up / down), 2.0,
                    scale=float(up))
    W = np.stack([resample.pack_weights(h, up, down)] * 4)
    kp1 = resample.history_len(len(h), up)
    hist = (rng.standard_normal(kp1) + 1j * rng.standard_normal(kp1)) \
        .astype(np.complex64)
    ks = [jnco.snap_freq(f, fs) for f in (120e3, -300e3, 55e3, 731e3)]
    p0s = [7, 123456, 0, jnco.DENOM - 1]
    ref = np.asarray(jresample.mixed_resample_bank(
        jnp.asarray(x), jnp.asarray(hist), jnp.asarray(W),
        jnp.asarray(ks, np.int32), jnp.asarray(p0s, np.int32),
        up=up, down=down))
    got = resample.mixed_resample_bank(
        torch.from_numpy(x), torch.from_numpy(hist), torch.from_numpy(W),
        torch.tensor(ks), torch.tensor(p0s), up=up, down=down).numpy()
    assert got.shape == ref.shape
    assert snr_db(got, ref) >= 100.0
