"""Parity of the torch port's exact NCO and wire formats against
pysdr_tpu (JAX on the CPU as the oracle): phase arithmetic bit-exact,
LO blocks within 1e-5, wire quantizers within one code."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pysdr_tpu.ops import cplx as jcplx
from pysdr_tpu.ops import nco as jnco
from pysdr_tpu_torch.ops import cplx, nco

torch.set_num_threads(1)


def test_constants_match():
    assert nco.DENOM == jnco.DENOM
    for f, fs in ((100e3, 2.048e6), (-731e3, 8e6), (0.0, 48e3)):
        assert nco.snap_freq(f, fs) == jnco.snap_freq(f, fs)


@pytest.mark.parametrize("n", [1, 7, 4096, (1 << 17) + 513, 1 << 24])
def test_phase_indices_bit_exact(n):
    rng = np.random.default_rng(n)
    k = int(rng.integers(0, nco.DENOM))
    p0 = int(rng.integers(0, nco.DENOM))
    if n == 1 << 24:
        k = nco.DENOM - 7          # worst case at the reference's max block
    ref = np.asarray(jnco.phase_indices(k, p0, n))
    got = nco.phase_indices(k, p0, n).numpy()
    np.testing.assert_array_equal(got, ref.astype(np.int64))


def test_advance_and_mul_mod_bit_exact():
    rng = np.random.default_rng(1)
    ks = rng.integers(0, nco.DENOM, 64)
    p0s = rng.integers(0, nco.DENOM, 64)
    ns = rng.integers(0, 1 << 24, 64)
    for k, p0, n in zip(ks, p0s, ns):
        assert int(nco.advance(int(k), int(p0), int(n))) == \
            int(jnco.advance(int(k), int(p0), int(n)))
        assert int(nco.mul_mod(int(k), int(n))) == \
            int(jnco.mul_mod(int(k), int(n)))
    # batched (per-channel) form equals the scalar form
    got = nco.advance(torch.as_tensor(ks), torch.as_tensor(p0s), 1 << 23)
    ref = [int(jnco.advance(int(k), int(p), 1 << 23)) for k, p in
           zip(ks, p0s)]
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("n", [5, 24, 3072, 24576])
def test_tone_and_mix_down(n):
    rng = np.random.default_rng(n)
    k = int(rng.integers(0, nco.DENOM))
    p0 = int(rng.integers(0, nco.DENOM))
    np.testing.assert_allclose(nco.tone(k, p0, n).numpy(),
                               np.asarray(jnco.tone(k, p0, n)), atol=1e-5)
    x = (rng.standard_normal(n) + 1j * rng.standard_normal(n)) \
        .astype(np.complex64)
    y, p1 = nco.mix_down(torch.from_numpy(x), k, p0)
    yr, p1r = jnco.mix_down(jnp.asarray(x), k, p0)
    np.testing.assert_allclose(y.numpy(), np.asarray(yr), atol=1e-5)
    assert int(p1) == int(p1r)


def test_tone_batched_rows_match_scalar():
    ks = torch.tensor([5, 1 << 20, nco.DENOM - 1])
    p0s = torch.tensor([0, 99, 123456])
    t = nco.tone(ks, p0s, 4096)
    for i in range(3):
        np.testing.assert_allclose(
            t[i].numpy(), np.asarray(jnco.tone(int(ks[i]), int(p0s[i]),
                                               4096)), atol=1e-5)


def test_rf_wire_dequantize():
    rng = np.random.default_rng(2)
    xp = rng.uniform(-1.2, 1.2, (4096, 2)).astype(np.float32)
    for wire in ("i8", "i16", "f32"):
        q = cplx.quantize_host(xp, wire)
        np.testing.assert_array_equal(q, jcplx.quantize_host(xp, wire))
        got = cplx.dequantize(torch.from_numpy(q)).numpy()
        ref = np.asarray(jcplx.dequantize(jnp.asarray(q)))
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-7)


@pytest.mark.parametrize("wire,tol", [("i16", 1), ("i8", 1)])
def test_audio_wire_within_one_code(wire, tol):
    rng = np.random.default_rng(3)
    # unit-level audio, overshoot past the 4x headroom, and exact zeros
    xp = np.concatenate([rng.standard_normal(8192) * 0.5,
                         rng.uniform(-6, 6, 1024), np.zeros(16)]) \
        .astype(np.float32)
    got = cplx.quantize_audio_wire(torch.from_numpy(xp), wire).numpy()
    ref = np.asarray(jcplx.quantize_audio_wire(jnp.asarray(xp), wire))
    assert got.dtype == ref.dtype
    assert np.abs(got.astype(np.int32) - ref.astype(np.int32)).max() <= tol
    np.testing.assert_array_equal(cplx.dequantize_audio_host(ref),
                                  jcplx.dequantize_audio_host(ref))
    np.testing.assert_array_equal(cplx._MULAW_LUT, jcplx._MULAW_LUT)


def test_snapped_freq_and_lo_angles_match_jax():
    """snapped_freq_hz inverts snap_freq as the JAX one does (scalars and
    arrays, both signs); lo_angles' phase indices are bit-identical and
    its float32 angles equal the JAX ones."""
    for f, fs in ((100e3, 2.048e6), (-731e3, 8e6), (0.0, 48e3),
                  (1.0e6, 2.048e6)):
        k = nco.snap_freq(f, fs)
        assert nco.snapped_freq_hz(k, fs) == jnco.snapped_freq_hz(k, fs)
    ks = np.random.default_rng(2).integers(0, nco.DENOM, 33)
    np.testing.assert_array_equal(nco.snapped_freq_hz(ks, 8e6),
                                  jnco.snapped_freq_hz(ks, 8e6))
    for k, p0, n in ((nco.snap_freq(-731e3, 8e6), 12345, 4096),
                     (nco.DENOM - 7, nco.DENOM - 1, (1 << 17) + 513)):
        got = nco.lo_angles(k, p0, n)
        ref = np.asarray(jnco.lo_angles(k, p0, n))
        assert got.dtype == torch.float32 and got.shape == (n,)
        np.testing.assert_array_equal(
            nco.phase_indices(k, p0, n).numpy(),
            np.asarray(jnco.phase_indices(k, p0, n)).astype(np.int64))
        np.testing.assert_array_equal(got.numpy(), ref)
