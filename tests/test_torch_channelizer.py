"""Parity of the port's channelizer ops against pysdr_tpu.ops.channelizer
(JAX on the CPU) at N = 8 channels, K = 12 taps per branch, over two
consecutive blocks so the history carries; and of the channel-batched
resample_block against JAX resample_block run per channel."""

import os
import re

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


# ---- csrc/pfb.cu's tiled decomposition, emulated in numpy ----
#
# The kernel cannot run here. emulate_pfb_branch repeats its
# decomposition (row tiles x 64-branch tiles, the view rows each block
# stages from the wire in its copy unit, the hist rows read from global
# memory, each thread's run of rows, the new history from the last row
# tile) at the constants of csrc/pfb.cu, checks that every sample it
# reads from the staged rows was staged, and is held against the twin
# and the JAX branch filter.

def cu_constants(name):
    """The `constexpr int kName = <literal>;` constants of a kernel
    source."""
    with open(os.path.join(os.path.dirname(chan.__file__), os.pardir,
                           "csrc", name)) as f:
        return {k: int(v) for k, v in
                re.findall(r"constexpr int (\w+) = (\d+);", f.read())}


def pfb_stage(raw, src, rows, seg, stride, pair, base):
    """stage() of csrc/pfb.cu: the staged bytes and the copy unit, for a
    wire block whose storage starts at address `base`."""
    one = seg == stride
    n_rows, length = (1, rows * seg) if one else (rows, seg)
    unit = 16
    while unit > pair and ((base + src) | (0 if one else stride)
                           | length) & (unit - 1):
        unit //= 2
    assert length % unit == 0 and (base + src) % unit == 0
    out = np.concatenate([raw[src + r * stride:src + r * stride + length]
                          for r in range(n_rows)])
    return out, unit


def emulate_pfb_branch(xw, hist, taps, base=256):
    """pfb_branch_kernel's decomposition: xw a numpy wire block (n, 2),
    hist complex64 ((K-1)*N,), taps (N, K). Returns (v, new_hist, the
    copy units used)."""
    c = cu_constants("pfb.cu")
    n, nch, k = xw.shape[0], taps.shape[0], taps.shape[1]
    m_rows, h_rows = n // nch, k - 1
    pair = 2 * xw.itemsize
    raw = xw.reshape(-1).view(np.uint8)
    scale = (None if xw.dtype == np.float32 else
             np.float32(1.0 / (127.0 if xw.dtype == np.int8 else 32767.0)))
    nbf = min(nch, c["kBranches"])
    tile = c["kThreads"] // nbf * c["kRun"]
    staged = k <= c["kMaxTaps"]
    v = np.full((m_rows, nch), np.nan, np.complex64)
    new_hist = np.full(h_rows * nch, np.nan, np.complex64)
    units = set()
    for bx in range(-(-m_rows // tile)):
        for by in range(-(-nch // c["kBranches"])):
            m0, c0 = bx * tile, by * c["kBranches"]
            nb = min(nch - c0, c["kBranches"])
            jlo = max(m0, h_rows)
            jhi = min(m0 + tile + h_rows, m_rows + h_rows)
            if staged and jhi > jlo:
                smem, unit = pfb_stage(raw, ((jlo - h_rows) * nch + c0) * pair,
                                       jhi - jlo, nb * pair, nch * pair,
                                       pair, base)
                units.add(unit)
                sx = smem.view(xw.dtype).reshape(-1, 2)

            def at(j, b):
                """Samples (view rows j, branches c0 + b), broadcast."""
                j, b = np.broadcast_arrays(j, b)
                out = np.empty(j.shape, np.complex64)
                old = j < h_rows
                out[old] = hist[j[old] * nch + c0 + b[old]]
                jw, bw = j[~old], b[~old]
                if staged:
                    assert ((jw >= jlo) & (jw < jhi)).all()
                    p = sx[(jw - jlo) * nb + bw]
                else:
                    p = xw[(jw - h_rows) * nch + c0 + bw]
                p = p.astype(np.float32)
                if scale is not None:
                    p = p * scale
                out[~old] = p[:, 0] + 1j * p[:, 1]
                return out

            b = np.arange(nb)
            for g in range(c["kThreads"] // nbf):
                ma = m0 + g * c["kRun"]
                rows = np.arange(ma, min(ma + c["kRun"], m_rows))
                if not len(rows):
                    continue
                re_, im_ = (np.zeros((len(rows), nb), np.float32)
                            for _ in range(2))
                for kk in range(k):           # k = 0 first, as the kernel
                    s = at(rows[:, None] + k - 1 - kk, b[None, :])
                    w = taps[c0 + b, kk][None, :]
                    re_ = re_ + w * s.real
                    im_ = im_ + w * s.imag
                assert np.isnan(v[rows[:, None], c0 + b[None, :]]).all()
                v[rows[:, None], c0 + b[None, :]] = re_ + 1j * im_
            if bx == -(-m_rows // tile) - 1:
                r = np.arange(h_rows)[:, None]
                new_hist[(r * nch + c0 + b[None, :]).reshape(-1)] = \
                    at(m_rows + r, b[None, :]).reshape(-1)
    return v, new_hist, units


# (M, N, K, wire): chan64's tile and one row short of and past it over 3
# tiles, fewer rows than K - 1, 128 branches in two tiles, a last
# partial branch tile, odd N, one tap, and K above the register window
PFB_TILE_CASES = [(300, 64, 12, "i8"), (127, 64, 12, "i8"),
                  (129, 64, 12, "f32"), (5, 64, 12, "i8"),
                  (40, 128, 12, "i16"), (40, 100, 2, "i8"),
                  (9, 3, 5, "i16"), (20, 4, 1, "f32"), (33, 8, 17, "i8")]


@pytest.mark.parametrize("m,nch,k,wire", PFB_TILE_CASES)
def test_pfb_tiling_emulation_matches_twin_and_jax(m, nch, k, wire):
    """Every output and history sample written once, every staged read
    inside the staged rows; v within 1e-6 of the twin and the JAX filter,
    the new history bit-equal to both."""
    rng = np.random.default_rng(m + nch + k)
    x = rng.uniform(-1.0, 1.0, (m * nch, 2)).astype(np.float32)
    xw = cplx.quantize_host(x, wire)
    hist = cnoise(rng, (k - 1) * nch)
    taps = rng.standard_normal((nch, k)).astype(np.float32)
    v, new_hist, units = emulate_pfb_branch(xw, hist, taps)
    xd = np.ascontiguousarray(cplx.dequantize(torch.from_numpy(xw)).numpy())
    v_t, h_t = chan.branch_filter_ref(
        torch.from_numpy(xd).view(torch.complex64)[:, 0],
        torch.from_numpy(hist), torch.from_numpy(taps))
    v_j, h_j = jchan.branch_filter(xd.view(np.complex64)[:, 0], hist, taps,
                                   nch)
    assert not np.isnan(v).any() and not np.isnan(new_hist).any()
    assert rel_err(v, v_t.numpy()) <= 1e-6
    assert rel_err(v, np.asarray(v_j)) <= 1e-6
    np.testing.assert_array_equal(new_hist, h_t.numpy())
    np.testing.assert_array_equal(new_hist, np.asarray(h_j))
    if (m, nch, wire) == (300, 64, "i8"):
        assert units == {16}          # chan64's rows: whole 16-byte units
