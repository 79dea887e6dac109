"""Parity of the port's channelizer ops against pysdr_tpu.ops.channelizer
(JAX on the CPU) at N = 8 channels, K = 12 taps per branch, over two
consecutive blocks so the history carries; and of the channel-batched
resample_block against JAX resample_block run per channel."""

import numpy as np
import pytest
import torch

from pysdr_tpu.ops import channelizer as jchan
from pysdr_tpu.ops import fir
from pysdr_tpu.ops import resample as jres
from pysdr_tpu_torch.ops import channelizer as chan
from pysdr_tpu_torch.ops import cplx, resample

torch.set_num_threads(1)

N, K = 8, 12
DESIGN = chan.ChannelizerDesign(fs_in=N * 48e3, n_channels=N,
                                taps_per_branch=K)


def cnoise(rng, *shape):
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64) * 0.3


def rel_err(got, ref):
    return np.abs(got - ref).max() / np.abs(ref).max()


def weights():
    return chan.pack_branch_weights(DESIGN.prototype(), N)


def test_design_and_weights_bit_equal():
    jd = jchan.ChannelizerDesign(fs_in=N * 48e3, n_channels=N,
                                 taps_per_branch=K)
    h = DESIGN.prototype()
    np.testing.assert_array_equal(h, jd.prototype())
    np.testing.assert_array_equal(weights(),
                                  jchan.pack_branch_weights(h, N))
    np.testing.assert_array_equal(DESIGN.center_freqs_hz(),
                                  jd.center_freqs_hz())
    assert chan.history_len(DESIGN) == jchan.history_len(jd) == (K - 1) * N
    for a, b in zip(chan.dft_matrix(N), jchan.dft_matrix(N)):
        np.testing.assert_array_equal(a, b)


def test_branch_filter_ref_matches_jax_over_two_blocks():
    """f32 sums in the same term order: within 1e-6 of the largest output."""
    rng = np.random.default_rng(0)
    w = weights()
    hist_t = torch.zeros((K - 1) * N, dtype=torch.complex64)
    hist_j = np.zeros((K - 1) * N, np.complex64)
    for _ in range(2):
        x = cnoise(rng, 64 * N)
        v_t, hist_t = chan.branch_filter_ref(torch.from_numpy(x), hist_t,
                                             torch.from_numpy(w))
        v_j, hist_j = jchan.branch_filter(x, hist_j, w, N)
        assert v_t.shape == (64, N)
        assert rel_err(v_t.numpy(), np.asarray(v_j)) <= 1e-6
        np.testing.assert_array_equal(hist_t.numpy(), np.asarray(hist_j))


@pytest.mark.parametrize("wire", ["f32", "i16", "i8"])
def test_branch_filter_dequantizes_like_the_wire(wire):
    """branch_filter on a CPU wire block == dequantize + the JAX formula
    (1e-6 of the largest output)."""
    rng = np.random.default_rng(1)
    w = weights()
    x = cnoise(rng, 32 * N)
    xw = cplx.quantize_host(x.view(np.float32).reshape(-1, 2), wire)
    hist = cnoise(rng, (K - 1) * N)
    v_t, h_t = chan.branch_filter(torch.from_numpy(xw),
                                  torch.from_numpy(hist), torch.from_numpy(w))
    xd = cplx.dequantize(torch.from_numpy(xw)).numpy()
    v_j, h_j = jchan.branch_filter(
        np.ascontiguousarray(xd).view(np.complex64)[:, 0], hist, w, N)
    assert rel_err(v_t.numpy(), np.asarray(v_j)) <= 1e-6
    np.testing.assert_array_equal(h_t.numpy(), np.asarray(h_j))


def test_channel_transform_matches_the_dft_matmul():
    """FFT against the reference's four f32 DFT matmuls: 1e-5 of the
    largest output (different f32 summation orders over 8 terms)."""
    rng = np.random.default_rng(2)
    v = cnoise(rng, 100, N)
    w_re, w_im = jchan.dft_matrix(N)
    ref = np.asarray(jchan.channel_transform(v, w_re, w_im))
    got = chan.channel_transform(torch.from_numpy(v)).numpy()
    assert rel_err(got, ref) <= 1e-5


def test_channelize_block_matches_jax_over_two_blocks():
    rng = np.random.default_rng(3)
    w = weights()
    hist_t = torch.zeros((K - 1) * N, dtype=torch.complex64)
    hist_j = np.zeros((K - 1) * N, np.complex64)
    for _ in range(2):
        x = cnoise(rng, 128 * N)
        y_t, hist_t = chan.channelize_block(torch.from_numpy(x), hist_t,
                                            torch.from_numpy(w))
        y_j, hist_j = jchan.channelize_block(x, hist_j, w, n_channels=N)
        assert y_t.shape == (128, N)
        assert rel_err(y_t.numpy(), np.asarray(y_j)) <= 1e-5
        np.testing.assert_array_equal(hist_t.numpy(), np.asarray(hist_j))


def test_channel_tone_lands_in_its_channel():
    """A tone at channel 3's center comes out of column 3 at unit gain."""
    n = 256 * N
    t = np.arange(n)
    f3 = DESIGN.center_freqs_hz()[3]
    x = np.exp(2j * np.pi * f3 * t / DESIGN.fs_in).astype(np.complex64)
    y, _ = chan.channelize_block(
        torch.from_numpy(x), torch.zeros((K - 1) * N, dtype=torch.complex64),
        torch.from_numpy(weights()))
    p = (y[K:].abs() ** 2).mean(dim=0).numpy()
    assert np.argmax(p) == 3 and abs(p[3] - 1.0) < 0.05
    assert np.delete(p, 3).max() < 1e-4 * p[3]


@pytest.mark.parametrize("up,down,fs", [(1, 4, 192e3), (1, 1, 48e3),
                                        (3, 4, 64e3)])
def test_resample_block_batched_matches_jax_per_channel(up, down, fs):
    """Each channel's own weight row and history, two blocks: 1e-5 of the
    largest output (f32 matmul summation order)."""
    rng = np.random.default_rng(4)
    bws = [0.0, 10e3, 5e3]
    wbank = resample.pack_weight_bank(
        fir.video_filter_bank(fs, up, down, bws, taps_per_phase=16),
        up, down)
    rows = np.array([0, 2, 1, 0])
    w = wbank[rows]
    kp1 = resample.history_len(16 * up, up)
    hist_t = torch.zeros((4, kp1), dtype=torch.complex64)
    hist_j = [np.zeros(kp1, np.complex64) for _ in range(4)]
    for _ in range(2):
        x = cnoise(rng, 4, 96 * down)
        y_t, hist_t = resample.resample_block(
            torch.from_numpy(x), hist_t, torch.from_numpy(w), up=up,
            down=down)
        assert y_t.shape == (4, 96 * up)
        for c in range(4):
            y_j, hist_j[c] = jres.resample_block(x[c], hist_j[c], w[c],
                                                 up=up, down=down)
            assert rel_err(y_t[c].numpy(), np.asarray(y_j)) <= 1e-5, c
            np.testing.assert_array_equal(hist_t[c].numpy(),
                                          np.asarray(hist_j[c]))
