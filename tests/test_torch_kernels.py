"""The hand-written CUDA kernels (pysdr_tpu_torch/csrc/scan.cu, pfb.cu,
rtty.cu) against their plain torch twins, and the twins against a serial
loop.

Imports no jax, so it also runs on a card host without the JAX package:

    python -m pytest --noconftest -q tests/test_torch_kernels.py

The `cuda`-marked tests skip on a host without a CUDA device (the kernels
have no CPU mode); the rest run everywhere.
"""

import numpy as np
import pytest
import torch

from pysdr_tpu.config import PipelineConfig, ReceiverConfig
from pysdr_tpu.tables import Mode
from pysdr_tpu_torch import kernels
from pysdr_tpu_torch.kernels import build
from pysdr_tpu_torch.kernels import pfb as kpfb
from pysdr_tpu_torch.kernels import rtty as krtty
from pysdr_tpu_torch.kernels import scan as kscan
from pysdr_tpu_torch.models.channelizer_bank import (ChannelizerBankConfig,
                                                     ChannelizerBank)
from pysdr_tpu_torch.models import rtty
from pysdr_tpu_torch.models.receiver import ReceiverBank
from pysdr_tpu_torch.ops import channelizer, cplx, demod, scanops

torch.set_num_threads(1)

# the main path's scan shapes at bank4: pass A, pass B, the AGC windows
MAIN_SHAPES = [(4, 24576, 4), (4, 24576, 2), (4, 384, 1)]
# the same at chan64 (64 channels, 12288-sample audio blocks)
CHAN64_SHAPES = [(64, 12288, 4), (64, 12288, 2), (64, 192, 1)]
# the branch filter's (M, N, K) at chan64 and two small ones
PFB_SHAPES = [(49152, 64, 12), (5, 8, 12), (3, 4, 1)]
# rtty_scores' (F, nfft, C, T): the 100-channel decoder at 96 kHz without
# and with a carried soft tail, one channel, and a short call with no
# scores (T + F < L)
RTTY_SHAPES = [(43, 4096, 100, 0), (43, 4096, 100, 64), (43, 4096, 1, 64),
               (5, 512, 3, 20)]


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


def test_threads_per_block():
    assert kscan._threads(1) == 32
    assert kscan._threads(384) == 32
    assert kscan._threads(24576) == 1024
    assert all(kscan._threads(n) <= 1024 for n in (10 ** 6, 2 ** 24))


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
    """A 4-RX bank step launches every scan kernel and makes no blocking
    copy or stream sync: sync debug mode 'error' raises on any."""
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
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    torch.cuda.set_sync_debug_mode("error")
    try:
        outs = [bank.step_device(xb) for xb in xbs]
    finally:
        torch.cuda.set_sync_debug_mode(0)
    # per step: linrec for pass A, pass B and the AGC; sr_latch once
    assert kernels.launch_counts() == {"linrec": 9, "sr_latch": 3,
                                       "pfb_branch": 0, "rtty_scores": 0}
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
    """An 8-channel bank step launches every kernel (the branch filter
    once, the scans as in the receiver bank) and makes no blocking copy
    or stream sync: sync debug mode 'error' raises on any."""
    cfg = ChannelizerBankConfig(fs_in=8 * 192e3, n_channels=8,
                                out_block=2048, fc_hz=100e6)
    bank = ChannelizerBank(cfg, audio_wire="i8", device=cuda)
    rng = np.random.default_rng(13)
    n = bank.design.in_block
    xbs = [torch.from_numpy(cplx.quantize_host(
        rng.uniform(-0.5, 0.5, (n, 2)).astype(np.float32), "i8")).to(cuda)
        for _ in range(3)]
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    torch.cuda.set_sync_debug_mode("error")
    try:
        outs = [bank.step_device(xb) for xb in xbs]
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert kernels.launch_counts() == {"linrec": 9, "sr_latch": 3,
                                       "pfb_branch": 3, "rtty_scores": 0}
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
    """The kernel stages the 32 templates in one block's shared memory
    (48 KB without opting in); a length past that bound is refused by the
    library and raised by the wrapper, and counts no launch."""
    mags, mark, space, tail, _ = (a.to(cuda) for a in
                                  rtty_inputs(43, 512, 4, 64, 26))
    tmpl = torch.ones((32, 400), dtype=torch.float32, device=cuda)
    before = krtty.rtty_scores.launches
    with pytest.raises(RuntimeError, match="rtty_scores kernel launch "
                                           "failed"):
        krtty.rtty_scores(mags, mark, space, tail, tmpl)
    assert krtty.rtty_scores.launches == before
