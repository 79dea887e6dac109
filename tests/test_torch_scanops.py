"""Parity of the torch port's scans, AGC, overlap-save FIR and fused
mix+resample against pysdr_tpu (JAX on the CPU). On the CPU the scans run
their plain torch twins; tests/test_torch_kernels.py holds the CUDA
kernels against those twins, and the tests at the end hold a plain torch
emulation of the kernels' tiled decomposition against both."""

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
from pysdr_tpu_torch.kernels import scan as kscan
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


# ---- the CUDA kernels' tiled decomposition, emulated in plain torch ----
#
# csrc/scan.cu cannot run here. These helpers repeat its decomposition
# (tiles, per-run composites, the runs' scan inside a tile, prefixes
# carried from tile to tile, the rescan of each run) in plain torch, at
# the tile sizes kernels.scan picks, and hold it against the twins and
# against the JAX package.

def compose(e, lt):
    """(a1, b1) then (a2, b2) = (a1*a2, a2*b1 + b2), elementwise."""
    return e[0] * lt[0], lt[0] * e[1] + lt[1]


def emulate_linrec(a, b, y_prev, tile, run):
    """linrec_kernel's decomposition: b, a (B, n, k) (a may be expanded),
    y_prev (B, k). Returns (y, y_last)."""
    B, n, k = b.shape
    tiles, runs = -(-n // tile), tile // run
    pad = tiles * tile - n
    A = torch.cat([a, torch.ones(B, pad, k)], 1).reshape(B, tiles, runs, run,
                                                         k)
    Bv = torch.cat([b, torch.zeros(B, pad, k)], 1).reshape(B, tiles, runs,
                                                          run, k)
    # each thread folds its run of one column into a composite
    rc = (torch.ones(B, tiles, runs, k), torch.zeros(B, tiles, runs, k))
    for i in range(run):
        rc = compose(rc, (A[:, :, :, i], Bv[:, :, :, i]))
    # the runs' inclusive scan inside each tile
    ia, ib = rc[0].clone(), rc[1].clone()
    for r in range(1, runs):
        ia[:, :, r], ib[:, :, r] = compose((ia[:, :, r - 1], ib[:, :, r - 1]),
                                           (rc[0][:, :, r], rc[1][:, :, r]))
    ea = torch.cat([torch.ones(B, tiles, 1, k), ia[:, :, :-1]], 2)
    eb = torch.cat([torch.zeros(B, tiles, 1, k), ib[:, :, :-1]], 2)
    # prefixes carried tile to tile from (1, y_prev): the carry into tile
    # t is the b of the composite of every tile before it
    carry = torch.empty(B, tiles, k)
    e = (torch.ones(B, k), y_prev.clone())
    for t in range(tiles):
        carry[:, t] = e[1]
        e = compose(e, (ia[:, t, -1], ib[:, t, -1]))
    # each run rescanned from its carried-in value
    yv = ea * carry[:, :, None] + eb
    ys = []
    for i in range(run):
        yv = A[:, :, :, i] * yv + Bv[:, :, :, i]
        ys.append(yv)
    y = torch.stack(ys, 3).reshape(B, tiles * tile, k)[:, :n]
    return y, y[:, -1]


def emulate_sr_latch(s, r, g_prev, tile, run):
    """sr_latch_kernel's decomposition: s, r bool (B, n), g_prev (B,)."""
    B, n = s.shape
    tiles, lanes = -(-n // tile), tile // run
    pad = tiles * tile - n
    cmd = torch.where(s, 1, torch.where(r, -1, 0))
    cmd = torch.cat([cmd, torch.zeros(B, pad, dtype=cmd.dtype)], 1) \
        .reshape(B, tiles, lanes, run)

    def later_wins(e, lt):
        return torch.where(lt != 0, lt, e)
    agg = torch.zeros(B, tiles, lanes, dtype=cmd.dtype)
    for i in range(run):                       # each lane's 16 commands
        agg = later_wins(agg, cmd[..., i])
    inc = agg.clone()
    for ln in range(1, lanes):                 # the warp's scan
        inc[:, :, ln] = later_wins(inc[:, :, ln - 1], agg[:, :, ln])
    ex = torch.cat([torch.zeros(B, tiles, 1, dtype=cmd.dtype),
                    inc[:, :, :-1]], 2)
    # look-back: the nearest tile with a command, or g_prev
    before = torch.empty(B, tiles, dtype=cmd.dtype)
    cur = torch.where(g_prev > 0.5, 1, -1)
    for t in range(tiles):
        before[:, t] = cur
        cur = later_wins(cur, inc[:, t, -1])
    cur = torch.where(ex != 0, ex, before[:, :, None])
    out = []
    for i in range(run):
        cur = later_wins(cur, cmd[..., i])
        out.append(cur)
    gate = (torch.stack(out, 3).reshape(B, tiles * tile)[:, :n] > 0) \
        .to(torch.float32)
    return gate, gate[:, -1]


def _rows_vs_jax(fn, rows, *arrays):
    """fn (a jitted JAX scan) on each listed row of the numpy arrays."""
    return [fn(*(jnp.asarray(x[i]) for x in arrays)) for i in rows]


def _edge_ns(tile):
    return [tile - 1, tile, tile + 1, 1, 200_000]


# the main paths' shapes; n around the short tile (few rows) and the long
# one (enough rows to take it)
LINREC_CASES = ([(4, 24576, 4), (4, 24576, 2), (4, 384, 1),
                 (64, 12288, 4), (64, 12288, 2), (64, 192, 1)]
                + [(2, n, 2) for n in _edge_ns(512)]
                + [(130, n, 1) for n in (1023, 1024, 1025)])


@pytest.mark.parametrize("shape", LINREC_CASES)
def test_linrec_tiling_emulation_matches_twin_and_jax(shape):
    B, n, k = shape
    tile, threads, tiles = kscan.linrec_geometry(B, n, k)
    assert threads == 64 * k and tile // 64 in kscan.LINREC_RUNS
    assert tiles == -(-n // tile)
    rng = np.random.default_rng(B * 7 + n + k)
    a = rng.uniform(0.9, 1.0, shape).astype(np.float32)
    b = rng.uniform(-1.0, 1.0, shape).astype(np.float32)
    yp = rng.uniform(-1.0, 1.0, (B, k)).astype(np.float32)
    ta, tb, typ = (torch.from_numpy(x) for x in (a, b, yp))
    y, last = emulate_linrec(ta, tb, typ, tile, tile // 64)
    y_ref, l_ref = scanops.linrec_ref(ta, tb, typ)
    assert rel_err(y.numpy(), y_ref.numpy()) <= 1e-5
    assert rel_err(last.numpy(), l_ref.numpy()) <= 1e-5
    for i, (yj, lj) in zip((0, B - 1), _rows_vs_jax(j_linrec, (0, B - 1),
                                                    a, b, yp)):
        assert rel_err(y[i].numpy(), yj) <= 1e-5
        assert rel_err(last[i].numpy(), lj) <= 1e-5


@pytest.mark.parametrize("alpha", ["columns", "scalar"])
def test_linrec_tiling_emulation_with_a_per_column(alpha):
    """The main path's a: a per-column constant (1 - alpha) at stride 0
    along n, or one scalar, over 48 tiles a row."""
    rng = np.random.default_rng(31)
    x = torch.from_numpy(rng.standard_normal((4, 24576, 4))
                         .astype(np.float32))
    yp = torch.from_numpy(rng.standard_normal((4, 4)).astype(np.float32))
    al = (torch.tensor([0.1, 0.01, 0.001, 0.5]) if alpha == "columns"
          else torch.full((4,), 0.0623))
    a = (1.0 - al).expand(x.shape)
    assert a.stride(1) == 0
    tile = kscan.linrec_geometry(*x.shape)[0]
    y, last = emulate_linrec(a, al * x, yp, tile, tile // 64)
    y_ref, l_ref = scanops.one_pole(x, al if alpha == "columns"
                                    else 0.0623, yp)
    assert rel_err(y.numpy(), y_ref.numpy()) <= 1e-5
    assert rel_err(last.numpy(), l_ref.numpy()) <= 1e-5


LATCH_CASES = ([(4, 24576), (64, 12288)]
                + [(3, n) for n in _edge_ns(512)]
                + [(130, n) for n in (2047, 2048, 2049)])


@pytest.mark.parametrize("sparse", [False, True])
@pytest.mark.parametrize("shape", LATCH_CASES)
def test_sr_latch_tiling_emulation_matches_twin_and_jax(shape, sparse):
    """Random commands, and (sparse) commands only near the start and the
    end, so that the carry crosses runs of dozens of tiles with no
    command (the look-back's window is 32 tiles)."""
    B, n = shape
    tile, threads, tiles = kscan.sr_latch_geometry(B, n)
    assert tile == threads * kscan.LATCH_RUN and tiles == -(-n // tile)
    rng = np.random.default_rng(B + n + sparse)
    s = rng.random(shape) < 0.01
    r = rng.random(shape) < 0.01
    if sparse:
        quiet = np.ones(n, bool)
        quiet[:37] = quiet[-5:] = False
        s[:, quiet] = r[:, quiet] = False
        s[0, :] = r[0, :] = False             # row 0: no command at all
    gp = (np.arange(B) % 2).astype(np.float32)
    ts, tr, tg = (torch.from_numpy(x) for x in (s, r, gp))
    g, last = emulate_sr_latch(ts, tr, tg, tile, kscan.LATCH_RUN)
    g_ref, l_ref = scanops.sr_latch_ref(ts, tr, tg)
    assert torch.equal(g, g_ref) and torch.equal(last, l_ref)
    for i, (gj, lj) in zip((0, B - 1), _rows_vs_jax(j_sr_latch, (0, B - 1),
                                                    s, r, gp)):
        np.testing.assert_array_equal(g[i].numpy(), np.asarray(gj))
        assert float(last[i]) == float(lj)
    if sparse:
        assert bool((g[0] == gp[0]).all())


def test_dc_block_matches_jax_chunked():
    """dc_block over three chunks with its state carried equals the JAX
    one (<= 1e-5 relative), and the carried state matches."""
    rng = np.random.default_rng(41)
    x = (rng.standard_normal(3000) * 0.1 + 0.7).astype(np.float32)
    st_t = (0.0, 0.0)
    st_j = (jnp.float32(0.0), jnp.float32(0.0))
    for lo, hi in ((0, 1000), (1000, 1001), (1001, 3000)):
        y_t, st_t = scanops.dc_block(torch.from_numpy(x[lo:hi]), 0.9985,
                                     st_t)
        y_j, st_j = jscan.dc_block(jnp.asarray(x[lo:hi]), 0.9985, st_j)
        assert rel_err(y_t.numpy(), y_j) <= 1e-5, (lo, hi)
        assert float(st_t[0]) == float(st_j[0])
        assert abs(float(st_t[1]) - float(st_j[1])) <= 1e-5
    # the DC is gone by the end
    assert abs(y_t[-500:].mean().item()) < 0.02


@pytest.mark.parametrize("n_stages", [1, 3])
def test_one_pole_cas_matches_jax(n_stages):
    """A cascade of one-pole sections, scalar alpha over (n,) and a
    per-column alpha over (n, k): outputs and each stage's last value
    against the JAX cascade (<= 1e-5 relative)."""
    rng = np.random.default_rng(42 + n_stages)
    x = rng.standard_normal((2048, 3)).astype(np.float32)
    alpha = np.asarray([0.1, 0.01, 0.3], np.float32)
    yp = rng.standard_normal((n_stages, 3)).astype(np.float32)
    y_t, l_t = scanops.one_pole_cas(torch.from_numpy(x),
                                    torch.from_numpy(alpha),
                                    torch.from_numpy(yp), n_stages)
    y_j, l_j = jscan.one_pole_cas(jnp.asarray(x), jnp.asarray(alpha),
                                  jnp.asarray(yp), n_stages)
    assert y_t.shape == (2048, 3) and l_t.shape == (n_stages, 3)
    assert rel_err(y_t.numpy(), y_j) <= 1e-5
    assert rel_err(l_t.numpy(), l_j) <= 1e-5
    y_t, l_t = scanops.one_pole_cas(torch.from_numpy(x[:, 0]), 0.05,
                                    torch.from_numpy(yp[:, 0]), n_stages)
    y_j, l_j = jscan.one_pole_cas(jnp.asarray(x[:, 0]), 0.05,
                                  jnp.asarray(yp[:, 0]), n_stages)
    assert rel_err(y_t.numpy(), y_j) <= 1e-5
    assert rel_err(l_t.numpy(), l_j) <= 1e-5
