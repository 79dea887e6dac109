"""The hand-written CUDA kernels (pysdr_tpu_torch/csrc/scan.cu, pfb.cu,
rtty.cu) against their plain torch twins, and the twins against a serial
loop; on a card also the CUDA graphs of the banks' steps, the --mesh
shards, the display's panes and the RTTY decoder's filterbank against
their eager twins, and the host pulls that must not wait on a bank step.

Imports no jax, so it also runs on a card host without the JAX package:

    python -m pytest --noconftest -q tests/test_torch_kernels.py

The `cuda`-marked tests skip on a host without a CUDA device (the kernels
have no CPU mode); the rest run everywhere.
"""

import numpy as np
import pytest
import torch

from pysdr_tpu_torch import kernels
from pysdr_tpu_torch.config import PipelineConfig, ReceiverConfig
from pysdr_tpu_torch.device import leaves, map_tensors
from pysdr_tpu_torch.kernels import build
from pysdr_tpu_torch.kernels import pfb as kpfb
from pysdr_tpu_torch.kernels import rtty as krtty
from pysdr_tpu_torch.kernels import scan as kscan
from pysdr_tpu_torch.models.channelizer_bank import (ChannelizerBankConfig,
                                                     ChannelizerBank)
from pysdr_tpu_torch.models import rtty
from pysdr_tpu_torch.models.receiver import ReceiverBank
from pysdr_tpu_torch.ops import channelizer, cplx, demod, scanops
from pysdr_tpu_torch.tables import Mode

torch.set_num_threads(1)

# the main path's scan shapes at bank4: pass A, pass B, the AGC windows
MAIN_SHAPES = [(4, 24576, 4), (4, 24576, 2), (4, 384, 1)]
# the same at chan64 (64 channels, 12288-sample audio blocks)
CHAN64_SHAPES = [(64, 12288, 4), (64, 12288, 2), (64, 192, 1)]
# the branch filter's (M, N, K) at chan64 and two small ones; then edge
# shapes of its tiling (128 rows x 64 branches a block at N = 64): one
# row short of and past a tile, fewer rows than K - 1 (the new history
# reaches into the old), 128 branches in two tiles, a last partial
# branch tile, odd N, and K above the kernel's register window
PFB_SHAPES = [(49152, 64, 12), (5, 8, 12), (3, 4, 1),
              (127, 64, 12), (129, 64, 12), (5, 64, 12), (64, 128, 12),
              (40, 100, 2), (9, 3, 5), (33, 8, 17)]
# rtty_scores' (F, nfft, C, T): the 100-channel decoder at 96 kHz without
# and with a carried soft tail, one channel, a short call with no
# scores (T + F < L), 77 offsets (not a multiple of the kernel's 4-offset
# groups or 32-offset pass) and 289 offsets (two 256-offset chunks)
RTTY_SHAPES = [(43, 4096, 100, 0), (43, 4096, 100, 64), (43, 4096, 1, 64),
               (5, 512, 3, 20), (43, 4096, 100, 65), (300, 512, 3, 20)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def serial_linrec(a, b, y_prev):
    y = np.empty_like(a, dtype=np.float64)
    acc = y_prev.astype(np.float64)
    for i in range(a.shape[1]):
        acc = a[:, i] * acc + b[:, i]
        y[:, i] = acc
    return y


def serial_latch(s, r, g_prev):
    out = np.empty(s.shape, np.float32)
    g = g_prev > 0.5
    for i in range(s.shape[1]):
        g = np.where(s[:, i], True, np.where(r[:, i], False, g))
        out[:, i] = g
    return out


def scan_inputs(shape, seed):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.9, 1.0, shape).astype(np.float32)
    b = rng.uniform(0.0, 1.0, shape).astype(np.float32)
    yp = rng.uniform(0.0, 1.0, (shape[0], shape[2])).astype(np.float32)
    return a, b, yp


def latch_inputs(shape, seed):
    rng = np.random.default_rng(seed)
    s = rng.random(shape) < 0.01
    r = rng.random(shape) < 0.01
    gp = (rng.random(shape[0]) < 0.5).astype(np.float32)
    return s, r, gp


@pytest.mark.parametrize("shape", [(2, 3000, 3), (1, 1, 1), (3, 37, 2)])
def test_linrec_ref_matches_serial_loop(shape):
    a, b, yp = scan_inputs(shape, 1)
    y, last = scanops.linrec_ref(torch.from_numpy(a), torch.from_numpy(b),
                                 torch.from_numpy(yp))
    ref = serial_linrec(a, b, yp)
    assert np.abs(y.numpy() - ref).max() / np.abs(ref).max() <= 1e-5
    np.testing.assert_array_equal(last.numpy(), y.numpy()[:, -1])


@pytest.mark.parametrize("shape", [(4, 3000), (1, 1), (2, 33)])
def test_sr_latch_ref_matches_serial_loop(shape):
    s, r, gp = latch_inputs(shape, 2)
    gate, last = scanops.sr_latch_ref(torch.from_numpy(s),
                                      torch.from_numpy(r),
                                      torch.from_numpy(gp))
    ref = serial_latch(s, r, gp)
    np.testing.assert_array_equal(gate.numpy(), ref)
    np.testing.assert_array_equal(last.numpy(), ref[:, -1])


def test_non_cpu_tensor_never_takes_the_plain_version():
    """A tensor off the CPU goes to the kernel wrapper, which raises for
    anything but a CUDA tensor: no silent fallback to the plain twin."""
    a = torch.empty((1, 8, 1), device="meta")
    with pytest.raises(ValueError, match="CUDA tensor"):
        scanops.linrec(a, a, torch.zeros((1, 1), device="meta"))
    s = torch.empty((1, 8), dtype=torch.bool, device="meta")
    with pytest.raises(ValueError, match="CUDA tensor"):
        scanops.sr_latch(s, s, torch.zeros(1, device="meta"))
    with pytest.raises(ValueError, match="CUDA tensor"):
        kscan.linrec(torch.zeros(1, 8, 1), torch.zeros(1, 8, 1),
                     torch.zeros(1, 1))
    with pytest.raises(ValueError, match="CUDA tensor"):
        kscan.sr_latch(torch.zeros(1, 8, dtype=torch.bool),
                       torch.zeros(1, 8, dtype=torch.bool), torch.zeros(1))


def pfb_inputs(m, nch, k, wire, seed):
    """A wire block of m*nch pairs, a non-zero history, random taps."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1.0, 1.0, (m * nch, 2)).astype(np.float32)
    hist = (rng.standard_normal((k - 1) * nch)
            + 1j * rng.standard_normal((k - 1) * nch)).astype(np.complex64)
    taps = rng.standard_normal((nch, k)).astype(np.float32)
    return (torch.from_numpy(cplx.quantize_host(x, wire)),
            torch.from_numpy(hist), torch.from_numpy(taps))


def serial_branch_filter(x, hist, taps):
    """v[m, r] = sum_k taps[r, k] * xp[(m + K-1-k)*N + r], in float64."""
    nch, k = taps.shape
    xp = np.concatenate([hist, x]).astype(np.complex128)
    m_out = len(x) // nch
    v = np.zeros((m_out, nch), np.complex128)
    for m in range(m_out):
        for r in range(nch):
            for kk in range(k):
                v[m, r] += taps[r, kk] * xp[(m + k - 1 - kk) * nch + r]
    return v, xp[len(x):]


@pytest.mark.parametrize("m,nch,k", [(6, 8, 12), (3, 4, 1), (1, 2, 5)])
def test_branch_filter_ref_matches_serial_loop(m, nch, k):
    xw, hist, taps = pfb_inputs(m, nch, k, "f32", 7)
    x = torch.view_as_complex(xw)
    v, new_hist = channelizer.branch_filter_ref(x, hist, taps)
    v_ref, h_ref = serial_branch_filter(x.numpy(), hist.numpy(),
                                        taps.numpy())
    assert np.abs(v.numpy() - v_ref).max() / np.abs(v_ref).max() <= 1e-6
    np.testing.assert_array_equal(new_hist.numpy(), h_ref.astype(np.complex64))


def test_cpu_branch_filter_never_reaches_the_kernel(monkeypatch):
    """A CPU wire block takes the plain twin (the kernel wrapper is never
    called); a tensor off the CPU goes to the wrapper, which raises for
    anything but a CUDA tensor: no silent fallback."""
    def refuse(*a):
        raise AssertionError("kernel wrapper called with a CPU tensor")
    monkeypatch.setattr(kpfb, "pfb_branch", refuse)
    for wire in ("f32", "i16", "i8"):
        xw, hist, taps = pfb_inputs(5, 8, 12, wire, 8)
        v, _ = channelizer.branch_filter(xw, hist, taps)
        assert v.shape == (5, 8)
    monkeypatch.undo()
    with pytest.raises(ValueError, match="CUDA tensor"):
        channelizer.branch_filter(
            torch.empty((16, 2), device="meta"),
            torch.empty(88, dtype=torch.complex64, device="meta"),
            torch.empty((8, 12), device="meta"))


def test_pfb_wrapper_rejects_a_wrong_dtype_or_shape():
    xw, hist, taps = pfb_inputs(5, 8, 12, "i8", 9)
    with pytest.raises(ValueError, match="float32 or torch.int16"):
        kpfb.pfb_branch(xw.to(torch.int32), hist, taps)
    with pytest.raises(ValueError, match="complex64"):
        kpfb.pfb_branch(xw, hist.real.contiguous(), taps)
    with pytest.raises(ValueError, match="shape"):
        kpfb.pfb_branch(xw, hist[:-1], taps)
    with pytest.raises(ValueError, match="multiple of N"):
        kpfb.pfb_branch(xw[:-1], hist, taps)
    with pytest.raises(ValueError, match="CUDA tensor"):
        kpfb.pfb_branch(xw, hist, taps)


@pytest.mark.parametrize("shape,tile", [
    ((4, 24576, 4), 512), ((4, 24576, 2), 512), ((4, 384, 1), 512),
    ((64, 12288, 4), 1024), ((64, 12288, 2), 1024), ((64, 192, 1), 512),
    ((2, 200000, 4), 1024), ((2, 1, 4), 512)])
def test_scan_geometry(shape, tile):
    """A block per (row, tile): the longer tile (1024 samples for linrec,
    2048 for the latch's four warps) where it still gives >= 128 blocks,
    else the short one (512), so bank4's 4 rows get 192 blocks and
    chan64's 64 rows 768 (linrec) and 384 (latch)."""
    B, n, k = shape
    got, threads, tiles = kscan.linrec_geometry(B, n, k)
    assert (got, threads, tiles) == (tile, 64 * k, -(-n // tile))
    assert B * tiles >= min(kscan.MIN_BLOCKS, B * -(-n // 512))
    ltile, lthreads, ltiles = kscan.sr_latch_geometry(B, n)
    assert ltile == 2048 if tile == 1024 else ltile == 512
    assert lthreads == ltile // kscan.LATCH_RUN and ltiles == -(-n // ltile)
    assert B * ltiles >= min(kscan.MIN_BLOCKS, B * -(-n // 512))


def test_every_wrapper_counts_launches_from_import():
    """A fresh process: each kernel wrapper carries its launch count
    before any reset (a missing count would fail the first launch)."""
    import subprocess
    import sys
    out = subprocess.run(
        [sys.executable, "-c", "from pysdr_tpu_torch import kernels; "
         "print({f.__name__: f.launches for f, _, _ in kernels.KERNELS})"],
        capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == str({"linrec": 0, "sr_latch": 0,
                                      "pfb_branch": 0, "rtty_scores": 0})


def test_lookback_bookkeeping():
    """The status words and the control words (the epoch, the finished
    blocks and the row tickets, which the kernels keep on the card) grow
    together and both start at 0, so the epoch starts again with clean
    words; a claim that fits keeps both as the launches left them; neither
    shrinks."""
    lb = kscan._Lookback(torch.device("cpu"), torch.int64, 3, 3)
    lb.claim(10, 4)
    assert lb.words.numel() == 32
    assert lb.ctl.numel() == kscan.CTL_HEAD + 4
    assert not lb.words.any() and not lb.ctl.any()
    lb.words.fill_(7)                      # as launches leave them
    lb.ctl[0] = 2
    words, ctl = lb.words, lb.ctl
    lb.claim(10, 3)
    lb.claim(5, 4)
    assert lb.words is words and lb.ctl is ctl and int(lb.ctl[0]) == 2
    lb.claim(11, 5)                        # more slots and rows
    assert lb.words.numel() == 64 and lb.ctl.numel() == kscan.CTL_HEAD + 8
    assert not lb.words.any() and not lb.ctl.any()
    lb.words.fill_(7)
    lb.claim(1, 9)                         # more rows alone: both anew
    assert lb.words.numel() == 64 and lb.ctl.numel() == kscan.CTL_HEAD + 16
    assert not lb.words.any() and not lb.ctl.any()


def test_scan_a_reaches_the_kernel_uncopied(monkeypatch):
    """scanops hands the wrapper a per-column 1 - alpha expanded along n
    (stride 0: no copy, no fill) and a scalar alpha as a python float."""
    seen = []

    def capture(a, b, y_prev):
        seen.append(a)
        return torch.empty_like(b), torch.empty_like(y_prev)
    monkeypatch.setattr(kscan, "linrec", capture)
    x = torch.empty((4, 24576, 4), device="meta")
    scanops.one_pole(x, torch.empty(4, device="meta"),
                     torch.empty((4, 4), device="meta"))
    assert seen[-1].shape == x.shape and seen[-1].stride() == (0, 0, 1)
    scanops.one_pole(x[..., :1], 0.0623, torch.empty((4, 1), device="meta"))
    assert seen[-1] == float(np.float32(1.0) - np.float32(0.0623))
    scanops.linrec(torch.empty(4, device="meta").expand(4, 100, 4),
                   torch.empty((4, 100, 4), device="meta"),
                   torch.empty((4, 4), device="meta"))
    assert seen[-1].stride() == (0, 0, 1)


def test_scan_wrapper_rejects_an_a_it_does_not_take():
    b = torch.zeros((2, 8, 3))
    with pytest.raises(ValueError, match="stride 0 along n"):
        kscan._a_layout(torch.zeros((2, 3, 8)).transpose(1, 2), b.shape,
                        b.device)
    with pytest.raises(ValueError, match="shape"):
        kscan._a_layout(torch.zeros((2, 8, 2)), b.shape, b.device)
    with pytest.raises(ValueError, match="CUDA tensor"):
        kscan._a_layout(torch.zeros((2, 8, 3)), b.shape, b.device)
    with pytest.raises(ValueError, match="k <= 4"):
        kscan.linrec(0.5, torch.zeros((1, 8, 5)), torch.zeros((1, 5)))
    assert kscan._a_layout(0.5, b.shape, b.device)[0] == 0
    # one sample: a per-column constant expanded over 2 rows has a
    # stride along n that no element uses
    a1 = torch.zeros(3, device="meta").expand(2, 1, 3)
    assert a1.stride() == (0, 3, 1) and not a1.is_contiguous()
    with pytest.raises(ValueError, match="CUDA tensor"):
        kscan._a_layout(a1, (2, 1, 3), torch.device("cpu"))


def test_one_pole_scalar_alpha_equals_per_column_alpha():
    """A python-scalar alpha (kept off the device) gives bit for bit what
    the same alpha as a per-column tensor gives."""
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.standard_normal((2, 500, 3)).astype(np.float32))
    yp = torch.from_numpy(rng.standard_normal((2, 3)).astype(np.float32))
    alpha = 0.0623
    y_s, last_s = scanops.one_pole(x, alpha, yp)
    y_t, last_t = scanops.one_pole(
        x, torch.full((3,), alpha, dtype=torch.float32), yp)
    assert torch.equal(y_s, y_t) and torch.equal(last_s, last_t)


def test_demod_scan_constants_are_made_once_per_design_and_device():
    design = demod.DemodDesign(fs_out=48e3)
    alphas_a, alpha_click, a_b = demod.scan_constants(design,
                                                      torch.device("cpu"))
    assert demod.scan_constants(demod.DemodDesign(fs_out=48e3),
                                torch.device("cpu"))[0] is alphas_a
    assert alphas_a.shape == (4,) and a_b.shape == (2,)
    assert isinstance(alpha_click, float)
    np.testing.assert_allclose(a_b.numpy(), [1 - alpha_click, 0.9985],
                               rtol=1e-7)


def rtty_inputs(f, nfft, nch, t_rows, seed):
    """Random magnitudes, mark bins with the first one low enough that its
    space bin wraps below 0 (passed unwrapped, as a negative bin, and
    wrapped), a soft tail in [-1, 1] and the 32 templates of 32 frames."""
    rng = np.random.default_rng(seed)
    mags = rng.uniform(0.0, 3.0, (f, nfft)).astype(np.float32)
    mark = rng.integers(0, nfft, nch).astype(np.int32)
    space = mark - 7
    if nch:
        mark[0], space[0] = 2, -5
    if nch > 1:
        space[1] = (mark[1] - 7) % nfft
    tail = rng.uniform(-1.0, 1.0, (t_rows, nch)).astype(np.float32)
    tmpl = rtty.char_templates(rtty.RTTYDesign(fs=96e3))
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in
                 (mags, mark, space.astype(np.int32), tail, tmpl))


def serial_rtty_scores(mags, mark, space, tail, tmpl):
    """soft and scores by loops, in float64."""
    nfft = mags.shape[1]
    m = mags[:, mark % nfft].astype(np.float64)
    s = mags[:, space % nfft].astype(np.float64)
    soft = np.concatenate([tail, (m - s) / (m + s + 1e-9)])
    L = tmpl.shape[1]
    n_off = max(len(soft) - L + 1, 0)
    sc = np.zeros((n_off, soft.shape[1], 32))
    for o in range(n_off):
        for c in range(soft.shape[1]):
            sc[o, c] = tmpl.astype(np.float64) @ soft[o:o + L, c]
    return soft, sc


@pytest.mark.parametrize("shape", RTTY_SHAPES[1:])
def test_rtty_scores_ref_matches_serial_loop(shape):
    args = rtty_inputs(*shape, seed=21)
    soft, sc = rtty.rtty_scores_ref(*args)
    soft_ref, sc_ref = serial_rtty_scores(*(a.numpy() for a in args))
    assert soft.shape == soft_ref.shape and sc.shape == sc_ref.shape
    assert np.abs(soft.numpy() - soft_ref).max() <= 1e-6
    assert sc.numel() == 0 or np.abs(sc.numpy() - sc_ref).max() <= 1e-5


def test_cpu_rtty_scores_never_reach_the_kernel(monkeypatch):
    """A CPU tensor takes the plain twin: neither the wrapper nor the
    library is touched. The wrapper itself refuses a CPU tensor before it
    loads the library."""
    def refuse(*a):
        raise AssertionError("kernel path reached with a CPU tensor")
    monkeypatch.setattr(krtty, "rtty_scores", refuse)
    monkeypatch.setattr(build, "library", refuse)
    soft, sc = rtty.rtty_scores(*rtty_inputs(43, 512, 4, 64, 22))
    assert soft.shape == (107, 4) and sc.shape == (76, 4, 32)
    monkeypatch.undo()
    monkeypatch.setattr(build, "library", refuse)
    with pytest.raises(ValueError, match="CUDA tensor"):
        krtty.rtty_scores(*rtty_inputs(43, 512, 4, 64, 22))
    with pytest.raises(ValueError, match="CUDA tensor"):
        rtty.rtty_scores(*(torch.empty(a.shape, dtype=a.dtype, device="meta")
                           for a in rtty_inputs(43, 512, 4, 64, 22)))


@pytest.mark.parametrize("case", ["dtype", "shape", "contiguous", "rows",
                                  "dims"])
def test_rtty_wrapper_rejects_what_the_kernel_does_not_take(case):
    mags, mark, space, tail, tmpl = rtty_inputs(43, 512, 4, 64, 23)
    if case == "dtype":
        mark, match = mark.long(), "torch.int32"
    elif case == "shape":
        tail, match = tail[:, :3].contiguous(), "shape"
    elif case == "contiguous":
        mags, match = mags.t().contiguous().t(), "contiguous"
    elif case == "rows":
        tmpl, match = tmpl[:31].contiguous(), r"templates: expected shape \(32"
    else:
        mags, match = mags.reshape(-1), "dimensions"
    with pytest.raises(ValueError, match=match):
        krtty.rtty_scores(mags, mark, space, tail, tmpl)


# ---- on the card ----

@pytest.mark.cuda
@pytest.mark.parametrize("shape", MAIN_SHAPES + [(2, 7, 3), (1, 1, 1),
                                                 (3, 100003, 1)])
def test_linrec_kernel_matches_plain(cuda, shape):
    a, b, yp = (torch.from_numpy(v) for v in scan_inputs(shape, 3))
    y_ref, l_ref = scanops.linrec_ref(a, b, yp)
    before = kscan.linrec.launches
    y, last = kscan.linrec(a.to(cuda), b.to(cuda), yp.to(cuda))
    torch.cuda.synchronize()
    assert kscan.linrec.launches == before + 1
    scale = y_ref.abs().max().item()
    # f32 reassociation over up to 1e5 steps
    assert (y.cpu() - y_ref).abs().max().item() / scale <= 1e-4
    assert (last.cpu() - l_ref).abs().max().item() / scale <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("shape", CHAN64_SHAPES)
def test_linrec_kernel_matches_plain_at_chan64(cuda, shape):
    a, b, yp = (torch.from_numpy(v) for v in scan_inputs(shape, 10))
    y_ref, l_ref = scanops.linrec_ref(a, b, yp)
    y, last = kscan.linrec(a.to(cuda), b.to(cuda), yp.to(cuda))
    torch.cuda.synchronize()
    scale = y_ref.abs().max().item()
    assert (y.cpu() - y_ref).abs().max().item() / scale <= 1e-4
    assert (last.cpu() - l_ref).abs().max().item() / scale <= 1e-4


# n around one 512-sample tile, one sample, and 391 tiles a row
EDGE_NS = [511, 512, 513, 1, 200_000]


@pytest.mark.cuda
@pytest.mark.parametrize("a_kind", ["dense", "columns", "scalar"])
@pytest.mark.parametrize("n", EDGE_NS)
def test_linrec_kernel_edge_shapes(cuda, n, a_kind):
    """Tiles that end one short of, on and one past a tile, a single
    sample, and a long row; a dense, a per-column constant at stride 0
    along n (never copied), or a python scalar."""
    a, b, yp = (torch.from_numpy(v) for v in scan_inputs((3, n, 4), 14))
    if a_kind == "columns":
        a = a[:, :1].expand(3, n, 4)
    a_dev = (0.9921875 if a_kind == "scalar" else a.to(cuda))
    if a_kind == "scalar":
        a = torch.full_like(b, 0.9921875)
    if a_kind == "columns":
        a_dev = a_dev[:, :1].expand(3, n, 4)
        assert a_dev.stride(1) == 0 or n == 1
    y_ref, l_ref = scanops.linrec_ref(a, b, yp)
    y, last = kscan.linrec(a_dev, b.to(cuda), yp.to(cuda))
    torch.cuda.synchronize()
    scale = y_ref.abs().max().item()
    assert (y.cpu() - y_ref).abs().max().item() / scale <= 1e-4
    assert (last.cpu() - l_ref).abs().max().item() / scale <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1023, 1024, 1025, 2047, 2048, 2049])
def test_scan_kernels_long_tile_edges(cuda, n):
    """130 rows take the long tiles (linrec 1024 samples, the latch's
    four warps 2048): n one short of, on and one past them."""
    a, b, yp = (torch.from_numpy(v) for v in scan_inputs((130, n, 2), 18))
    assert kscan.linrec_geometry(130, n, 2)[0] == 1024
    y_ref, l_ref = scanops.linrec_ref(a, b, yp)
    y, last = kscan.linrec(a.to(cuda), b.to(cuda), yp.to(cuda))
    s, r, gp = (torch.from_numpy(v) for v in latch_inputs((130, n), 19))
    assert kscan.sr_latch_geometry(130, n)[0] == 2048
    g_ref, gl_ref = scanops.sr_latch_ref(s, r, gp)
    g, gl = kscan.sr_latch(s.to(cuda), r.to(cuda), gp.to(cuda))
    torch.cuda.synchronize()
    scale = y_ref.abs().max().item()
    assert (y.cpu() - y_ref).abs().max().item() / scale <= 1e-4
    assert (last.cpu() - l_ref).abs().max().item() / scale <= 1e-4
    assert torch.equal(g.cpu(), g_ref) and torch.equal(gl.cpu(), gl_ref)


@pytest.mark.cuda
def test_scan_kernels_repeat_exactly(cuda):
    """Many launches through one look-back buffer (epochs past the
    latch's wrap at 31, shapes that grow and shrink it) give the same
    bits each time for the same inputs, linrec's float carry too."""
    a, b, yp = (torch.from_numpy(v).to(cuda)
                for v in scan_inputs((4, 24576, 4), 15))
    s, r, gp = (torch.from_numpy(v).to(cuda)
                for v in latch_inputs((4, 24576), 16))
    y0, _ = kscan.linrec(a, b, yp)
    g0, _ = kscan.sr_latch(s, r, gp)
    for i in range(40):
        kscan.linrec(a[:, :1000, :1].contiguous(), b[:, :1000, :1]
                     .contiguous(), yp[:, :1].contiguous())
        kscan.sr_latch(s[:1, :700].contiguous(), r[:1, :700].contiguous(),
                       gp[:1])
        y, _ = kscan.linrec(a, b, yp)
        g, _ = kscan.sr_latch(s, r, gp)
        torch.cuda.synchronize()
        assert torch.equal(g, g0), i
        # the carry composes every predecessor's aggregate in a fixed
        # order, whichever finished first: the same bits
        assert torch.equal(y, y0), i


@pytest.mark.cuda
@pytest.mark.parametrize("n", EDGE_NS)
def test_sr_latch_kernel_edge_shapes(cuda, n):
    """As for linrec, with commands only in the first and last few
    samples of rows 1-2 and none in row 0: the carry crosses up to 390
    tiles with no command."""
    s, r, gp = latch_inputs((3, n), 17)
    quiet = np.ones(n, bool)
    quiet[:37] = quiet[-5:] = False
    s[:, quiet] = r[:, quiet] = False
    s[0] = r[0] = False
    s, r, gp = (torch.from_numpy(v) for v in (s, r, gp))
    g_ref, l_ref = scanops.sr_latch_ref(s, r, gp)
    g, last = kscan.sr_latch(s.to(cuda), r.to(cuda), gp.to(cuda))
    torch.cuda.synchronize()
    assert torch.equal(g.cpu(), g_ref) and torch.equal(last.cpu(), l_ref)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(4, 24576), (3, 5), (1, 1),
                                   (2, 100003), (64, 12288)])
def test_sr_latch_kernel_matches_plain(cuda, shape):
    s, r, gp = (torch.from_numpy(v) for v in latch_inputs(shape, 4))
    g_ref, l_ref = scanops.sr_latch_ref(s, r, gp)
    g, last = kscan.sr_latch(s.to(cuda), r.to(cuda), gp.to(cuda))
    torch.cuda.synchronize()
    assert torch.equal(g.cpu(), g_ref) and torch.equal(last.cpu(), l_ref)


@pytest.mark.cuda
def test_dispatch_takes_the_kernel_on_cuda(cuda):
    kernels.reset_launch_counts()
    a = torch.full((64, 2), 0.5, device=cuda)
    scanops.one_pole(a, 0.1, torch.zeros(2, device=cuda))
    scanops.sr_latch(a[:, 0] > 0, a[:, 0] < 0, 1.0)
    torch.cuda.synchronize()
    assert kernels.launch_counts() == {"linrec": 1, "sr_latch": 1,
                                       "pfb_branch": 0, "rtty_scores": 0}


@pytest.mark.cuda
def test_bank_step_does_not_wait_on_the_card(cuda):
    """A 4-RX bank step, one graph replay, launches every scan kernel
    (counted through the replays) and makes no blocking copy or stream
    sync: sync debug mode 'error' raises on any (the demod's scan
    constants cleared first, as for the channelizer bank). The capture,
    which synchronizes, comes first (bank.prepare)."""
    demod.scan_constants.cache_clear()
    cfg = PipelineConfig(
        fs_in=512e3, fs_out=48e3, out_block=3072, foffset_hz=60e3,
        receivers=tuple(ReceiverConfig(fc_hz=f, mode=m) for f, m in (
            (10e6, Mode.AM), (10.03e6, Mode.NFM), (9.97e6, Mode.USB),
            (10.06e6, Mode.CW))))
    bank = ReceiverBank(cfg, audio_wire="i16", device=cuda)
    rng = np.random.default_rng(5)
    n = bank.design.in_block
    xbs = [bank.to_device_block((rng.standard_normal(n)
                                 + 1j * rng.standard_normal(n)) * 0.1)
           for _ in range(3)]
    bank.prepare(torch.float32, n)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    torch.cuda.set_sync_debug_mode("error")
    try:
        # each step's output is the graph's, rewritten by the next step
        outs = [bank.step_device(xb).clone() for xb in xbs]
    finally:
        torch.cuda.set_sync_debug_mode(0)
    # per step: linrec for pass A, pass B and the AGC; sr_latch once
    assert kernels.launch_counts() == {"linrec": 9, "sr_latch": 3,
                                       "pfb_branch": 0, "rtty_scores": 0}
    assert bank.graph_count == 1
    for out in outs:
        assert out.dtype == torch.int16
        assert out.shape == (bank.n_rx * cfg.out_block * 2,)
        assert out.abs().max().item() > 0


@pytest.mark.cuda
def test_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    a = torch.zeros((2, 8, 3), device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        kscan.linrec(a.transpose(0, 1).contiguous().transpose(0, 1), a,
                     torch.zeros((2, 3), device=cuda))
    with pytest.raises(ValueError, match="float32"):
        kscan.linrec(a.double(), a, torch.zeros((2, 3), device=cuda))
    with pytest.raises(ValueError, match="shape"):
        kscan.linrec(a, a, torch.zeros((2, 2), device=cuda))


@pytest.mark.cuda
@pytest.mark.parametrize("wire", ["i8", "i16", "f32"])
@pytest.mark.parametrize("m,nch,k", PFB_SHAPES)
def test_pfb_branch_kernel_matches_plain(cuda, m, nch, k, wire):
    """On every wire, with a non-zero history: 1e-5 of the largest output
    (fused multiply-adds against separate ones), the new history exact."""
    xw, hist, taps = pfb_inputs(m, nch, k, wire, 11)
    v_ref, h_ref = channelizer.branch_filter(xw, hist, taps)
    before = kpfb.pfb_branch.launches
    v, new_hist = channelizer.branch_filter(xw.to(cuda), hist.to(cuda),
                                            taps.to(cuda))
    torch.cuda.synchronize()
    assert kpfb.pfb_branch.launches == before + 1
    assert v.shape == (m, nch) and v.dtype == torch.complex64
    assert (v.cpu() - v_ref).abs().max().item() \
        / v_ref.abs().max().item() <= 1e-5
    assert torch.equal(new_hist.cpu(), h_ref)


@pytest.mark.cuda
def test_pfb_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    xw, hist, taps = (t.to(cuda) for t in pfb_inputs(5, 8, 12, "i16", 12))
    with pytest.raises(ValueError, match="contiguous"):
        kpfb.pfb_branch(xw.t().contiguous().t(), hist, taps)
    with pytest.raises(ValueError, match="CUDA tensor"):
        kpfb.pfb_branch(xw, hist.cpu(), taps)
    with pytest.raises(ValueError, match="shape"):
        kpfb.pfb_branch(xw, hist, taps[:, :-1].contiguous())


@pytest.mark.cuda
def test_chanbank_step_does_not_wait_on_the_card(cuda):
    """An 8-channel bank step, one graph replay, launches every kernel
    (the branch filter once, the scans as in the receiver bank; counted
    through the replays) and makes no blocking copy or stream sync: sync
    debug mode 'error' raises on any. The demod's scan constants are
    cleared first, so the bank's constructor alone must have put them on
    the device (under the key the step uses)."""
    demod.scan_constants.cache_clear()
    cfg = ChannelizerBankConfig(fs_in=8 * 192e3, n_channels=8,
                                out_block=2048, fc_hz=100e6)
    bank = ChannelizerBank(cfg, audio_wire="i8", device=cuda)
    rng = np.random.default_rng(13)
    n = bank.design.in_block
    xbs = [torch.from_numpy(cplx.quantize_host(
        rng.uniform(-0.5, 0.5, (n, 2)).astype(np.float32), "i8")).to(cuda)
        for _ in range(3)]
    bank.prepare(torch.int8, n)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    torch.cuda.set_sync_debug_mode("error")
    try:
        outs = [bank.step_device(xb).clone() for xb in xbs]
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert kernels.launch_counts() == {"linrec": 9, "sr_latch": 3,
                                       "pfb_branch": 3, "rtty_scores": 0}
    assert bank.graph_count == 1
    for out in outs:
        assert out.dtype == torch.int8
        assert out.shape == (8 * cfg.out_block * 2,)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", RTTY_SHAPES + [(43, 4096, 0, 64)])
def test_rtty_scores_kernel_matches_plain(cuda, shape):
    """Soft rows bit-equal to the twin (exact division, the same
    operations); scores within 1e-4 (32 fused multiply-adds against the
    twin's matmul). C = 0 launches nothing."""
    args = rtty_inputs(*shape, seed=24)
    soft_ref, sc_ref = rtty.rtty_scores_ref(*args)
    before = krtty.rtty_scores.launches
    soft, sc = rtty.rtty_scores(*(a.to(cuda) for a in args))
    torch.cuda.synchronize()
    assert krtty.rtty_scores.launches == before + (shape[2] > 0)
    assert soft.shape == soft_ref.shape and sc.shape == sc_ref.shape
    assert torch.equal(soft.cpu(), soft_ref)
    if sc.numel():
        assert (sc.cpu() - sc_ref).abs().max().item() <= 1e-4


@pytest.mark.cuda
def test_rtty_wrapper_rejects_mixed_devices(cuda):
    mags, mark, space, tail, tmpl = (a.to(cuda) for a in
                                     rtty_inputs(43, 512, 4, 64, 25))
    with pytest.raises(ValueError, match="CUDA tensor"):
        krtty.rtty_scores(mags, mark, space, tail.cpu(), tmpl)


@pytest.mark.cuda
def test_rtty_templates_too_long_for_shared_memory_fail_the_launch(cuda):
    """The kernel stages the 32 templates and one chunk of soft rows in
    one block's shared memory (48 KB without opting in: templates up to
    363 frames); a length past that bound is refused by the
    library and raised by the wrapper, and counts no launch."""
    mags, mark, space, tail, _ = (a.to(cuda) for a in
                                  rtty_inputs(43, 512, 4, 64, 26))
    tmpl = torch.ones((32, 400), dtype=torch.float32, device=cuda)
    before = krtty.rtty_scores.launches
    with pytest.raises(RuntimeError, match="rtty_scores kernel launch "
                                           "failed"):
        krtty.rtty_scores(mags, mark, space, tail, tmpl)
    assert krtty.rtty_scores.launches == before


# ---- the executive's host copies and the sharded processors ----

def _small_bank(cuda, audio_wire="i16", agc=True):
    cfg = PipelineConfig(
        fs_in=512e3, fs_out=48e3, out_block=9600, foffset_hz=60e3,
        receivers=tuple(ReceiverConfig(fc_hz=f, mode=m, agc_enabled=agc)
                        for f, m in ((10e6, Mode.AM), (10.03e6, Mode.NFM),
                                     (9.97e6, Mode.USB), (10.06e6, Mode.CW))))
    return cfg, ReceiverBank(cfg, audio_wire=audio_wire, device=cuda)


def _noise_blocks(n, count, seed):
    rng = np.random.default_rng(seed)
    return [((rng.standard_normal(n) + 1j * rng.standard_normal(n)) * 0.1)
            .astype(np.complex64) for _ in range(count)]


@pytest.mark.cuda
def test_drain_waits_for_its_block_alone(cuda):
    """The executive's drain of block k-D waits on that block's host copy
    alone: with the card held busy behind step k (torch.cuda._sleep), the
    drain of block k-1 returns long before the sleep ends, with that
    block's audio."""
    import time
    from pysdr_tpu_torch.runtime.executive import drain, start_host_copy
    cfg, bank = _small_bank(cuda)
    xs = _noise_blocks(bank.design.in_block, 2, 31)
    xbs = [bank.to_device_block(x) for x in xs]
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    torch.cuda._sleep(10 ** 7)
    b.record()
    b.synchronize()
    cycles_a_ms = 10 ** 7 / a.elapsed_time(b)
    first = (start_host_copy(bank.step_device(xbs[0])), None)   # block k-D
    step_k = bank.step_device(xbs[1])                           # block k
    torch.cuda._sleep(int(cycles_a_ms * 1500))                  # ~1.5 s busy
    second = (start_host_copy(step_k), None)
    t0 = time.perf_counter()
    audio0, _ = drain(bank, first)
    waited = time.perf_counter() - t0
    assert waited < 0.5, waited
    audio1, _ = drain(bank, second)
    ref = ReceiverBank(cfg, audio_wire="i16", device=cuda)
    np.testing.assert_allclose(audio0, ref.step(xs[0]), atol=1e-6)
    np.testing.assert_allclose(audio1, ref.step(xs[1]), atol=1e-6)


@pytest.mark.cuda
def test_a_read_that_outlasts_stop_leaves_a_capture_alone(cuda):
    """A prefetch read still in progress when the executive's stop()
    returns (a source slower than stop's wait, as the synth is at chan64)
    ends inside another graph's capture without a device call: the
    capture, under capture_error_mode "global", succeeds."""
    import threading
    from pysdr_tpu_torch.models import graphstep
    from pysdr_tpu_torch.runtime.executive import Executive
    _, bank = _small_bank(cuda)
    xs = _noise_blocks(bank.design.in_block, 5, 33)
    gate, waiting = threading.Event(), threading.Event()

    class GatedSource:
        k = 0

        def read_data(self, n, loop=True):
            if self.k == 4:
                waiting.set()
                gate.wait()
            self.k += 1
            return xs[self.k - 1]

    ex = Executive(bank, GatedSource())
    ex.run(n_blocks=3)
    assert waiting.wait(timeout=30.0)          # the 5th read has begun
    ex.stop()
    y = torch.zeros(8, device=cuda)

    def body(_outs):
        gate.set()                             # the read ends in here
        ex._pf_thread.join(timeout=30.0)
        y.add_(1.0)

    cap, _ = graphstep.capture(cuda, lambda: (), body, lambda: (y,),
                               what="y")
    assert not ex._pf_thread.is_alive() and ex._pf_error is None
    cap.replay()
    torch.cuda.synchronize()
    assert float(y[0]) == 1.0


@pytest.mark.cuda
def test_stream_shards_on_one_card_match_the_serial_bank(cuda):
    """A 2 x 2 grid of one card, each shard a CUDA graph replayed in
    turn from this thread: every shard runs the scan kernels (three
    linrec passes and one sr_latch a shard a call), and the audio matches
    the serial bank on the card."""
    from pysdr_tpu_torch.parallel import mesh as mesh_mod
    from pysdr_tpu_torch.parallel.adapter import ShardedStreamBank
    cfg, serial = _small_bank(cuda, "f32", agc=False)
    _, bank = _small_bank(cuda, "f32", agc=False)
    ad = ShardedStreamBank(bank, mesh_mod.make_mesh(
        2, 2, devices=[cuda] * 4))
    xs = _noise_blocks(bank.design.in_block, 8, 32)
    ref = np.concatenate([serial.step(x) for x in xs], axis=1)
    outs = []
    # one graph a shard, captured before the count starts (the capture's
    # warm-up launches the kernels once more)
    ad.prepare(torch.float32, ad.design.in_block)
    assert ad.graph_count == 4
    kernels.reset_launch_counts()
    for k in range(4):
        x = np.concatenate(xs[2 * k:2 * k + 2])
        outs.append(ad.audio_from_wire(ad.step_device(
            serial.to_device_block(x))))
    assert kernels.launch_counts() == {"linrec": 48, "sr_latch": 16,
                                       "pfb_branch": 0, "rtty_scores": 0}
    got = np.concatenate(outs, axis=1)
    skip = 16384
    err = np.sum(np.abs(got[:, skip:] - ref[:, skip:]) ** 2, axis=1)
    sig = np.sum(np.abs(ref[:, skip:]) ** 2, axis=1)
    assert (10 * np.log10(sig / err)).min() > 55.0


@pytest.mark.cuda
@pytest.mark.filterwarnings("ignore:stream segment")
def test_channel_shards_on_one_card_match_the_serial_bank(cuda):
    """Channel shards of one card: pfb_branch runs once a shard a call and
    each shard's channels equal the serial bank's."""
    from pysdr_tpu_torch.parallel import chanshard, mesh as mesh_mod
    cfg = ChannelizerBankConfig(fs_in=768e3, n_channels=8, fs_out=48e3,
                                out_block=1024, fc_hz=100e6)
    serial = ChannelizerBank(cfg, device=cuda)
    xs = _noise_blocks(serial.design.in_block, 3, 33)
    ref = np.concatenate([serial.step(x) for x in xs], axis=1)
    kernels.reset_launch_counts()
    got = chanshard.run_sharded(ChannelizerBank(cfg, device=cuda),
                                np.concatenate(xs),
                                mesh_mod.single_axis_mesh(
                                    "ch", [cuda] * 4), n_blocks=3)
    assert kernels.launch_counts()["pfb_branch"] == 12
    np.testing.assert_allclose(got, ref, atol=2e-4)
    # the streaming adapter over the same grid, graphed (one graph a
    # shard, pfb_branch once a replay) and eager, bit for bit
    from pysdr_tpu_torch.parallel.adapter import ShardedChannelizerBank
    ads = [ShardedChannelizerBank(
        ChannelizerBank(cfg, device=cuda),
        mesh_mod.single_axis_mesh("ch", [cuda] * 4), graph=graph)
        for graph in (True, False)]
    for ad in ads:
        ad.prepare(torch.float32, ad.design.in_block)
    assert [ad.graph_count for ad in ads] == [4, 0]
    for x in xs:
        xb = serial.to_device_block(x)
        counts, held = [], []
        for ad in ads:
            kernels.reset_launch_counts()
            held.append([p.clone() for p in ad.step_device(xb)])
            torch.cuda.synchronize()
            counts.append(kernels.launch_counts())
        assert counts[0] == counts[1] and counts[0]["pfb_branch"] == 4
        for p, q in zip(*held):
            assert torch.equal(p, q)


# ---- the banks' step captured as a CUDA graph (models/graphstep) ----

def _graph_bank(kind, cuda, graph):
    """The bench's device-only configs at full width: bank4 (i16 audio),
    modes1ch (f32 audio) and chan64 (mu-law i8 audio)."""
    if kind == "chan64":
        cfg = ChannelizerBankConfig(fs_in=64 * 192e3, n_channels=64,
                                    fs_out=48e3, out_block=3072,
                                    fc_hz=100e6)
        return ChannelizerBank(cfg, audio_wire="i8", device=cuda,
                               graph=graph)
    if kind == "bank4":
        fs, modes, out, spacing, foff, wire = (
            8e6, (Mode.AM, Mode.NFM, Mode.USB, Mode.CW), 24576, 500e3,
            750e3, "i16")
    else:
        fs, modes, out, spacing, foff, wire = (2.048e6, (Mode.AM,), 16384,
                                               0.0, 120e3, "f32")
    cfg = PipelineConfig(
        fs_in=fs, fs_out=48e3, out_block=out, foffset_hz=foff,
        receivers=tuple(ReceiverConfig(fc_hz=100e6 + spacing * i, mode=m)
                        for i, m in enumerate(modes)))
    return ReceiverBank(cfg, audio_wire=wire, device=cuda, graph=graph)


def _wire_blocks(n, wire, count, seed, cuda):
    """count (n, 2) RF wire blocks on the card from a seeded generator:
    normals of rms 0.3, quantized as the host would."""
    gen = torch.Generator(device=cuda).manual_seed(seed)
    out = []
    for _ in range(count):
        x = 0.3 * torch.randn((n, 2), generator=gen, device=cuda)
        if wire != "f32":
            s = cplx.WIRES[wire].scale
            x = torch.clamp(torch.round(x * s), -s, s).to(
                cplx.WIRES[wire].torch_dtype)
        out.append(x)
    return out


def _modes1ch_controls(bank, k):
    """modes1ch's three modes on one bank: AM, then NFM with squelch 10
    dB, then USB with AGC, as params writes."""
    if k == 21:
        bank.set_mode(0, Mode.NFM)
        bank.set_squelch(0, 10.0)
    elif k == 42:
        bank.set_mode(0, Mode.USB)
        bank.set_squelch(0, -150.0)


@pytest.mark.cuda
@pytest.mark.parametrize("wire", ["i8", "i16", "f32"])
@pytest.mark.parametrize("kind", ["bank4", "modes1ch", "chan64"])
def test_graphed_step_equals_eager(cuda, kind, wire):
    """64 blocks, past sr_latch's epoch wrap at 31 launches, through the
    graphed bank and an eager twin fed the same blocks: each block's
    audio wire and every tensor of the new state bit-equal (the same
    kernels on the same inputs; linrec's look-back composes in a fixed
    order). modes1ch changes mode twice and stays one graph."""
    g = _graph_bank(kind, cuda, graph=True)
    e = _graph_bank(kind, cuda, graph=False)
    xbs = _wire_blocks(g.design.in_block, wire, 8, 41, cuda)
    for k in range(64):
        if kind == "modes1ch":
            for b in (g, e):
                _modes1ch_controls(b, k)
        a_g, a_e = g.step_device(xbs[k % 8]), e.step_device(xbs[k % 8])
        torch.cuda.synchronize()
        assert torch.equal(a_g, a_e), (kind, wire, k)
        for i, (sg, se) in enumerate(zip(leaves(g.state), leaves(e.state))):
            assert torch.equal(sg, se), (kind, wire, k, i)
    assert g.graph_count == 1 and e.graph_count == 0


@pytest.mark.cuda
def test_scans_replay_in_one_graph(cuda):
    """96 linrec and 64 sr_latch launches back to back in one captured
    graph (on the graph's own look-back buffers, linrec's epoch wrapping
    every 5 launches, sr_latch's every 31), replayed three times: every
    output equals its twin each time (linrec the eager kernel's bits),
    and the tally holds the launches a replay adds."""
    from pysdr_tpu_torch.kernels import build as kbuild
    lin = []
    for shape, seed in (((4, 24576, 4), 51), ((4, 24576, 2), 52),
                        ((64, 12288, 4), 53)):
        a, b, yp = (torch.from_numpy(v).to(cuda)
                    for v in scan_inputs(shape, seed))
        a = a[:, :1].expand(shape)          # a per-column constant
        lin.append((a, b, yp, kscan.linrec(a, b, yp)))
    lat = []
    for shape, seed in (((4, 24576), 54), ((64, 12288), 55)):
        s, r, gp = (torch.from_numpy(v).to(cuda)
                    for v in latch_inputs(shape, seed))
        lat.append((s, r, gp, scanops.sr_latch_ref(s, r, gp)))
    lbs = kscan.Lookbacks()
    lbs.get("linrec", cuda).max_epoch = 5
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side), kscan.lookback_scope(lbs):
        for a, b, yp, _ in lin:             # size the graph's buffers
            kscan.linrec(a, b, yp)
        for s, r, gp, _ in lat:
            kscan.sr_latch(s, r, gp)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    outs = []
    with kbuild.capture_tally() as tally, kscan.lookback_scope(lbs), \
            torch.cuda.graph(graph, stream=side):
        for _ in range(32):
            for i, (a, b, yp, _) in enumerate(lin):
                outs.append(("linrec", i, kscan.linrec(a, b, yp)))
            for i, (s, r, gp, _) in enumerate(lat):
                outs.append(("sr_latch", i, kscan.sr_latch(s, r, gp)))
    assert tally == {"linrec": 96, "sr_latch": 64}
    for _ in range(3):
        graph.replay()
        torch.cuda.synchronize()
        for kind, i, (y, last) in outs:
            if kind == "linrec":
                y0, l0 = lin[i][3]
                assert torch.equal(y, y0) and torch.equal(last, l0), i
            else:
                g_ref, l_ref = lat[i][3]
                assert torch.equal(y, g_ref) and torch.equal(last, l_ref), i
    a, b, yp, (y0, _) = lin[2]
    y_ref, _ = scanops.linrec_ref(a, b, yp)
    assert (y0 - y_ref).abs().max().item() <= \
        1e-4 * y_ref.abs().max().item()


@pytest.mark.cuda
def test_a_capture_must_name_its_lookback_buffers(cuda):
    """A scan launched inside a capture without lookback_scope raises
    rather than take a stream's eager buffers (or make new ones inside
    the graph)."""
    a, b, yp = (torch.from_numpy(v).to(cuda)
                for v in scan_inputs((2, 700, 2), 57))
    kscan.linrec(a, b, yp)
    graph = torch.cuda.CUDAGraph()
    with pytest.raises(RuntimeError, match="lookback_scope"):
        with torch.cuda.graph(graph):
            kscan.linrec(a, b, yp)


@pytest.mark.cuda
def test_rebinding_the_state_after_a_capture_raises(cuda):
    """The replay checks that the bank holds the tensors it captured."""
    cfg, bank = _small_bank(cuda)
    xb = bank.to_device_block(_noise_blocks(bank.design.in_block, 1, 58)[0])
    bank.step_device(xb)
    bank.state = map_tensors(torch.clone, bank.state)
    with pytest.raises(RuntimeError, match="rebound"):
        bank.step_device(xb)


# ---- the --mesh adapters, one CUDA graph a shard (parallel/adapter) ----

def _mesh_adapter(kind, cuda, graph):
    """bank4-shaped (2 x 2) or chan64-shaped (1 x 4) adapter on a grid of
    the card four times, at the bench's full width."""
    from pysdr_tpu_torch.parallel import mesh as mesh_mod
    from pysdr_tpu_torch.parallel.adapter import (ShardedChannelizerBank,
                                                  ShardedStreamBank)
    bank = _graph_bank(kind, cuda, graph=True)
    if kind == "bank4":
        return ShardedStreamBank(bank, mesh_mod.make_mesh(
            2, 2, devices=[cuda] * 4), graph=graph)
    return ShardedChannelizerBank(bank, mesh_mod.make_mesh(
        1, 4, devices=[cuda] * 4), graph=graph)


def _carried(ad):
    return [ad._tail, ad._nb, ad._bb, *leaves(ad._dstate)]


@pytest.mark.cuda
@pytest.mark.filterwarnings("ignore:stream segment")
@pytest.mark.parametrize("kind", ["bank4", "chan64"])
def test_graphed_mesh_adapter_equals_eager(cuda, kind):
    """40 calls, past sr_latch's epoch wrap at 31 launches, through the
    graphed adapter (one graph a shard) and an eager twin fed the same
    i8 blocks, a retune and a set_mode posted partway: every audio
    piece and every carried tensor bit-equal, and a call's replays
    launch the kernels the eager call launches."""
    g = _mesh_adapter(kind, cuda, graph=True)
    e = _mesh_adapter(kind, cuda, graph=False)
    n = g.design.in_block
    for ad in (g, e):
        ad.prepare(torch.int8, n)
    assert g.graph_count == 4 and e.graph_count == 0
    xbs = _wire_blocks(n, "i8", 4, 61, cuda)
    for k in range(40):
        for ad in (g, e):
            if k == 13:
                ad.retune(1, 100.501e6 if kind == "bank4" else 4e3)
            elif k == 27:
                ad.set_mode(0, Mode.NFM)
        counts, held = [], []
        for ad in (g, e):
            kernels.reset_launch_counts()
            held.append([p.clone() for p in ad.step_device(xbs[k % 4])])
            torch.cuda.synchronize()
            counts.append(kernels.launch_counts())
        assert counts[0] == counts[1], (kind, k, counts)
        assert counts[0]["linrec"] == 12, (kind, k, counts)
        for i, (p, q) in enumerate(zip(*held)):
            assert torch.equal(p, q), (kind, k, i)
        for i, (p, q) in enumerate(zip(_carried(g), _carried(e))):
            assert torch.equal(p, q), (kind, k, "carried", i)
    assert int(g.params.demod.mode[0]) == int(Mode.NFM)


@pytest.mark.cuda
@pytest.mark.filterwarnings("ignore:stream segment")
def test_mesh_executive_depth_2_drains_as_depth_1(cuda):
    """The executive over a graphed 2 x 2 stream adapter on the card (i16
    RF and audio wires, prefetch on): depth 2, where each call's audio
    pieces wait in the pipeline while the next call replays over the
    same static outputs, drains the audio of depth 1, bit for bit."""
    from pysdr_tpu_torch.parallel import mesh as mesh_mod
    from pysdr_tpu_torch.parallel.adapter import ShardedStreamBank
    from pysdr_tpu_torch.runtime.executive import Executive

    class Blocks:
        def __init__(self, xs):
            self.xs = list(xs)

        def read_data(self, n, loop=False):
            return self.xs.pop(0) if self.xs else np.zeros(0, np.complex64)

    got = {}
    for depth in (1, 2):
        cfg, bank = _small_bank(cuda)
        ad = ShardedStreamBank(bank, mesh_mod.make_mesh(
            2, 2, devices=[cuda] * 4))
        xs = _noise_blocks(ad.design.in_block, 6, 62)
        out = got[depth] = []
        ex = Executive(ad, Blocks(xs), loop_source=False, wire="i16",
                       pipeline_depth=depth,
                       psd_callback=lambda ex, audio, out=out:
                       out.append(audio.copy()))
        ex.run(n_blocks=len(xs))
        ex.stop()
        assert ad.graph_count == 4 and len(out) == len(xs)
    for k, (a, b) in enumerate(zip(got[1], got[2])):
        np.testing.assert_array_equal(a, b, err_msg=str(k))


# ---- the display's panes, one CUDA graph a (pane, block length) ----

def _display_pair(cuda):
    """A bank (_small_bank) and two display engines on it with RF, AF
    and BB panes: graphed (prepared) and eager (graph=False)."""
    from pysdr_tpu_torch.models.display import DisplayEngine
    _, bank = _small_bank(cuda)
    g = DisplayEngine(bank, show_baseband=True)
    e = DisplayEngine(bank, show_baseband=True, graph=False)
    for eng in (g, e):
        eng.prepare()
    return bank, g, e


def _frames_equal(a, b) -> bool:
    return all(np.array_equal(x, y) for x, y in zip(a, b))


def _pane_controls(box, k):
    """The controls between updates: a retune, a dynamic-range change,
    a clear and a peak-height change."""
    if k == 11:
        box.retune(box.fc_hz + 40 * box.design.fs / box.cfg.nfft)
    elif k == 23:
        box.cfg.pan_dr_db = 30.0
    elif k == 37:
        box.clear()
    elif k == 45:
        box.cfg.peak_height_db = 15.0


@pytest.mark.cuda
def test_graphed_display_equals_eager(cuda):
    """64 updates of each pane kind (RF at in_block, AF and BB at
    out_block) through the graphed engine and its eager twin, fed the
    same host blocks with the same controls between them: every frame
    bit-equal; one graph a (pane, block length), none eager."""
    bank, g, e = _display_pair(cuda)
    d = bank.design
    blocks = {"RF": _noise_blocks(d.in_block, 8, 61),
              "AF0": _noise_blocks(d.out_block, 8, 62),
              "BB0": _noise_blocks(d.out_block, 8, 63)}
    for tag, xs in blocks.items():
        bg = next(b for b in g.panes if b.tag == tag)
        be = next(b for b in e.panes if b.tag == tag)
        for k in range(64):
            for box in (bg, be):
                _pane_controls(box, k)
            fg, fe = bg.update(xs[k % 8]), be.update(xs[k % 8])
            assert _frames_equal(fg, fe), (tag, k)
            assert np.isfinite(fg.psd_db).all()
    assert g.graph_count == len(g.panes) == 1 + 2 * bank.n_rx
    assert all(b.graph_count == 1 for b in g.panes)
    assert e.graph_count == 0


@pytest.mark.cuda
def test_display_dr_change_shows_in_the_next_frame(cuda):
    """The dynamic range is a device scalar copied in at each update:
    changed between two updates it reaches the graph's next frame (the
    image differs from a twin left at 60 dB and equals the eager
    pane's), with no new capture."""
    import dataclasses
    from pysdr_tpu_torch.models.display import ThreeBox
    bank, g, e = _display_pair(cuda)
    keep = ThreeBox(dataclasses.replace(g.rf.cfg), device=cuda)
    keep.prepare(bank.design.in_block)
    xs = _noise_blocks(bank.design.in_block, 4, 64)
    for x in xs[:3]:
        for box in (g.rf, e.rf, keep):
            box.update(x)
    g.rf.cfg.pan_dr_db = e.rf.cfg.pan_dr_db = 20.0
    fg, fe, fk = (box.update(xs[3]) for box in (g.rf, e.rf, keep))
    assert _frames_equal(fg, fe)
    assert not np.array_equal(fg.waterfall_u8, fk.waterfall_u8)
    assert g.rf.graph_count == 1


@pytest.mark.cuda
def test_display_pulls_do_not_wait_on_a_bank_step(cuda):
    """With the card's default stream held busy behind a bank step
    (torch.cuda._sleep), a graphed update of every pane kind, on the
    display's own stream, returns long before the sleep ends, with the
    frame of an update made while the card was idle."""
    import time
    bank, g, e = _display_pair(cuda)
    d = bank.design
    xs = {"RF": _noise_blocks(d.in_block, 1, 65)[0],
          "AF0": _noise_blocks(d.out_block, 1, 66)[0],
          "BB0": _noise_blocks(d.out_block, 1, 67)[0]}
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    torch.cuda._sleep(10 ** 7)
    b.record()
    b.synchronize()
    cycles_a_ms = 10 ** 7 / a.elapsed_time(b)
    xb = bank.to_device_block(_noise_blocks(d.in_block, 1, 68)[0])
    bank.step_device(xb)
    torch.cuda._sleep(int(cycles_a_ms * 1500))                 # ~1.5 s busy
    t0 = time.perf_counter()
    got = {tag: next(p for p in g.panes if p.tag == tag).update(x)
           for tag, x in xs.items()}
    waited = time.perf_counter() - t0
    assert waited < 0.5, waited
    torch.cuda.synchronize()
    for tag, x in xs.items():
        ref = next(p for p in e.panes if p.tag == tag).update(x)
        assert _frames_equal(got[tag], ref), tag


@pytest.mark.cuda
def test_display_raises_on_a_rebound_waterfall_or_length(cuda):
    """On a card a graphed pane raises, and never runs eagerly, when its
    waterfall was rebound after the capture or when it is fed a block
    length it was not prepared for."""
    from pysdr_tpu_torch.models.display import DisplayConfig, ThreeBox
    tb = ThreeBox(DisplayConfig(fs=48e3, nfft=256, rows=8), device=cuda)
    tb.prepare(4096)
    x = _noise_blocks(4096, 1, 69)[0]
    tb.update(x)
    with pytest.raises(ValueError, match="prepared for"):
        tb.update(x[:2048])
    tb._wf = tb._wf.clone()
    with pytest.raises(RuntimeError, match="rebound"):
        tb.update(x)
    assert tb.graph_count == 1


@pytest.mark.cuda
def test_display_capture_with_a_host_sync_raises(cuda):
    """A pane whose step waits on the card inside the capture (a .item())
    fails its capture loudly: prepare raises, in a child process so the
    failed capture leaves this one's card state alone."""
    import subprocess
    import sys
    code = (
        "import torch\n"
        "from pysdr_tpu_torch.models.display import DisplayConfig, "
        "ThreeBox\n"
        "tb = ThreeBox(DisplayConfig(fs=48e3, nfft=256, rows=8))\n"
        "compute = tb._compute\n"
        "def synced(x, wf, dr, height, in_place):\n"
        "    out = compute(x, wf, dr, height, in_place)\n"
        "    out[2].item()\n"
        "    return out\n"
        "tb._compute = synced\n"
        "try:\n"
        "    tb.prepare(4096)\n"
        "except RuntimeError as e:\n"
        "    print('raised', tb.graph_count, type(e).__name__)\n"
        "else:\n"
        "    print('captured', tb.graph_count)\n")
    import os
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300, cwd=root)
    assert p.stdout.strip().startswith("raised 0"), (p.stdout, p.stderr)


# ---- the RTTY decoder: its filterbank graphs and its own stream ----

def _rtty_stations(d, n):
    """n baseband samples at d.fs: station A at -1500 Hz throughout, B at
    +800 Hz from n/3 on and C at +2500 Hz until n/2, each keying Baudot
    text from the end of its idle preamble, over a little noise: its
    rescans add B and expire C."""
    x = (1e-3 * _noise_blocks(n, 1, 72)[0]).astype(np.complex64)
    idle = 4 * d.bits_per_char * d.bit_len
    for text, hz, start, stop in (("RYRY DE AAA ", -1500.0, 0, n),
                                  ("CQ DE BBB ", 800.0, n // 3, n),
                                  ("TEST CCC ", 2500.0, 0, n // 2)):
        s = rtty.synthesize_rtty(text * 200, d, carrier_hz=hz)[idle:]
        x[start:stop] += s[:stop - start]
    return x


def _rtty_state(dec):
    return (dec.channels, dec.last_spectrum, dec._iq_tail, dec._soft_tail)


def _rtty_states_equal(a, b):
    (ca, sa, ia, ta), (cb, sb, ib, tb) = _rtty_state(a), _rtty_state(b)
    return (ca == cb and np.array_equal(sa, sb) and torch.equal(ia, ib)
            and ((ta is None and tb is None) or torch.equal(ta, tb)))


@pytest.mark.cuda
def test_graphed_rtty_decoder_equals_eager(cuda):
    """64 blocks of a three-station synth, whose rescans add a channel and
    expire one, through a graphed decoder and its graph=False twin: every
    call's text, the channels, the spectrum and both tails bit-equal; one
    graph a frame count, all captured by prepare, none eager; rtty_scores
    launched once a block with channels."""
    d = rtty.RTTYDesign(fs=12e3)
    block = 4096
    x = _rtty_stations(d, 64 * block)
    kw = {"rescan_every": 2, "expire_after": 2}
    g = rtty.RTTYDecoder(d, device=cuda, **kw)
    e = rtty.RTTYDecoder(d, device=cuda, graph=False, **kw)
    counts = g.prepare(block)
    assert e.prepare(block) == counts == rtty.frame_counts(d, 0, block)
    assert g.graph_count == len(counts) >= 2 and e.graph_count == 0
    n_ch, texts = set(), {}
    for k in range(64):
        xd = torch.from_numpy(x[k * block:(k + 1) * block]).to(cuda)
        n0 = krtty.rtty_scores.launches
        want = e.decode_block(xd)
        assert krtty.rtty_scores.launches - n0 == (1 if e.channels else 0)
        assert g.decode_block(xd) == want, k
        assert _rtty_states_equal(g, e), k
        n_ch.add(len(g.channels))
        texts.update((c["mark_bin"], c["text"]) for c in g.channels)
    assert len(n_ch) >= 2, n_ch
    assert all(any(s in t for t in texts.values())
               for s in ("AAA", "BBB", "CCC")), texts
    assert g.graph_count == len(counts) and g.frame_counts == counts


@pytest.mark.cuda
def test_rtty_unprepared_frame_count_raises_on_the_card(cuda):
    """A block whose frame count a graphed decoder was not prepared for
    raises and is never run eagerly: no body, the same tail and block
    count, no new capture."""
    d = rtty.RTTYDesign(fs=12e3)
    dec = rtty.RTTYDecoder(d, device=cuda)
    counts = dec.prepare(4096)
    xs = _noise_blocks(4096, 2, 70)
    dec.decode_block(xs[0])
    ran = []
    body = dec._body
    dec._body = lambda inp, outs: (ran.append(1), body(inp, outs))
    tail, n = dec._iq_tail.clone(), dec._n_blocks
    with pytest.raises(ValueError, match="prepared for"):
        dec.decode_block(xs[1][:2000])
    assert not ran and dec._n_blocks == n
    assert torch.equal(dec._iq_tail, tail)
    assert dec.graph_count == len(counts)


@pytest.mark.cuda
def test_rtty_capture_with_a_host_sync_raises(cuda):
    """A filterbank that waits on the card inside the capture (a .item())
    fails its capture loudly: prepare raises, in a child process so the
    failed capture leaves this one's card state alone."""
    import os
    import subprocess
    import sys
    code = (
        "from pysdr_tpu_torch.models import rtty\n"
        "dec = rtty.RTTYDecoder(rtty.RTTYDesign(fs=12e3))\n"
        "fb = dec._filterbank\n"
        "def synced(inp):\n"
        "    out = fb(inp)\n"
        "    out[1][0].item()\n"
        "    return out\n"
        "dec._filterbank = synced\n"
        "try:\n"
        "    dec.prepare(4096)\n"
        "except RuntimeError as e:\n"
        "    print('raised', dec.graph_count, type(e).__name__)\n"
        "else:\n"
        "    print('captured', dec.graph_count)\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300, cwd=root)
    assert p.stdout.strip().startswith("raised 0"), (p.stdout, p.stderr)


def _sleep_cycles_a_ms():
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    torch.cuda._sleep(10 ** 7)
    b.record()
    b.synchronize()
    return 10 ** 7 / a.elapsed_time(b)


@pytest.mark.cuda
def test_rtty_pulls_do_not_wait_on_a_bank_step(cuda):
    """With the card's default stream held busy behind a bank step
    (torch.cuda._sleep) queued after the block's event, a graphed
    decoder, on its own stream, waits on that event alone: both of its
    pulls (the mean spectrum and the scores) return long before the sleep
    ends, with what an eager decoder decodes once the card is idle."""
    import time
    d = rtty.RTTYDesign(fs=12e3)
    block = 4096
    x = _rtty_stations(d, 5 * block)
    g = rtty.RTTYDecoder(d, device=cuda)
    e = rtty.RTTYDecoder(d, device=cuda, graph=False)
    for dec in (g, e):
        dec.prepare(block)
    xds = [torch.from_numpy(x[k * block:(k + 1) * block]).to(cuda)
           for k in range(5)]
    for xd in xds[:4]:                     # the caching allocator warm
        assert g.decode_block(xd) == e.decode_block(xd)
    cycles_a_ms = _sleep_cycles_a_ms()
    _, bank = _small_bank(cuda)
    xb = bank.to_device_block(_noise_blocks(bank.design.in_block, 1, 73)[0])
    torch.cuda.synchronize()
    ready = torch.cuda.Event()
    ready.record()
    bank.step_device(xb)
    torch.cuda._sleep(int(cycles_a_ms * 1500))                 # ~1.5 s busy
    n0 = krtty.rtty_scores.launches
    t0 = time.perf_counter()
    got = g.decode_block(xds[4], ready=[ready])
    waited = time.perf_counter() - t0
    assert waited < 0.5, waited
    assert g.channels and krtty.rtty_scores.launches == n0 + 1
    torch.cuda.synchronize()
    assert got == e.decode_block(xds[4])
    assert _rtty_states_equal(g, e)


@pytest.mark.cuda
def test_baseband_host_copy_does_not_wait_on_a_bank_step(cuda):
    """The baseband's host copy starts with the audio's right after the
    step: with the card held busy behind step k, the drain of block k-1
    returns long before the sleep ends, and that block's host baseband
    equals its device baseband."""
    import time
    from pysdr_tpu_torch.runtime.executive import drain, start_host_copy
    cfg, _ = _small_bank(cuda)
    bank = ReceiverBank(cfg, emit_baseband=True, audio_wire="i16",
                        device=cuda)
    xbs = [bank.to_device_block(x)
           for x in _noise_blocks(bank.design.in_block, 2, 74)]
    cycles_a_ms = _sleep_cycles_a_ms()
    audio_w = bank.step_device(xbs[0])                          # block k-D
    bb0 = bank._last_bb
    first = (start_host_copy(audio_w, bb0), bb0)
    step_k = bank.step_device(xbs[1])                           # block k
    torch.cuda._sleep(int(cycles_a_ms * 1500))                  # ~1.5 s busy
    second = (start_host_copy(step_k, bank._last_bb), bank._last_bb)
    t0 = time.perf_counter()
    _, bb = drain(bank, first)
    waited = time.perf_counter() - t0
    assert waited < 0.5, waited
    host_bb = first[0][1]
    assert bb is bb0 and host_bb.device.type == "cpu" and host_bb.is_pinned()
    np.testing.assert_array_equal(host_bb.numpy(), bb0.cpu().numpy())
    drain(bank, second)
    np.testing.assert_array_equal(second[0][1].numpy(),
                                  second[1].cpu().numpy())
