"""Parity of the port's spectrum ops and ThreeBox against pysdr_tpu's
(JAX on the CPU): psd_db within 1e-3 dB on bins above -150 dB, the
waterfall image within 1 LSB, the same peak indices; plus the display
engine's decimation phase and a PNG round trip. ThreeBox runs its step
as a body over static buffers (on a card, captured as a CUDA graph):
here it is held against the JAX ThreeBox across a retune, a clear and
a dynamic-range change, against the functional forms of ops/spectrum
inside an App run, and made to raise on a rebound waterfall or a block
length it was not prepared for. tests/test_torch_kernels.py holds the
graphed display against its eager twin on a card."""

import struct
import zlib

import numpy as np
import pytest
import torch

from pysdr_tpu.models import display as jdisp
from pysdr_tpu.ops import spectrum as jspec
from pysdr_tpu_torch.models import display
from pysdr_tpu_torch.ops import spectrum

torch.set_num_threads(1)


def tones(n, fs, freqs, noise=0.01, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / fs
    x = sum(a * np.exp(2j * np.pi * f * t) for f, a in freqs)
    x = x + noise * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
    return x.astype(np.complex64)


def assert_psd_close(got, ref):
    live = ref > -150.0
    assert live.any()
    assert np.abs(got[live] - ref[live]).max() <= 1e-3


@pytest.mark.parametrize("n", [8192, 700, 1024])
def test_periodogram_matches_jax(n):
    """Many segments, a zero-padded short block, exactly one segment."""
    x = tones(n, 1e6, [(100e3, 1.0), (-250e3, 0.1)])
    d = spectrum.SpectrumDesign(fs=1e6, nfft=512)
    w = d.window_array()
    got = spectrum.periodogram(torch.from_numpy(x), torch.from_numpy(w),
                               nfft=512, hop=d.hop)
    ref = np.asarray(jspec.periodogram(x, w, nfft=512, hop=d.hop))
    assert got.shape == ref.shape == (512,)
    assert_psd_close(got.numpy(), ref)
    np.testing.assert_array_equal(d.freqs_hz(5.0),
                                  jspec.SpectrumDesign(
                                      fs=1e6, nfft=512).freqs_hz(5.0))


def test_find_peaks_and_median_match_jax():
    rng = np.random.default_rng(3)
    row = rng.standard_normal(512).astype(np.float32) * 3 - 90
    row[[40, 41, 200, 203, 400]] = [-20, -20, -30, -31, -10]   # a plateau
    for height in (-80.0, -25.0, 0.0):
        i_t, v_t = spectrum.find_peaks(torch.from_numpy(row), height)
        i_j, v_j = jspec.find_peaks(row, np.float32(height))
        np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_j))
        np.testing.assert_array_equal(v_t.numpy(), np.asarray(v_j))
    assert list(i_t.numpy()) == [-1] * 32
    i_t, _ = spectrum.find_peaks(torch.from_numpy(row), -25.0)
    assert list(i_t.numpy()[:2]) == [400, 40]         # one flag per plateau
    for r in (row, row[:511]):
        assert spectrum.background_median(torch.from_numpy(r)).item() == \
            float(jspec.background_median(r))


def test_waterfall_push_shift_clamp_and_image_match_jax():
    rng = np.random.default_rng(4)
    wf = rng.uniform(-120, -20, (10, 64)).astype(np.float32)
    row = rng.uniform(-120, -20, 64).astype(np.float32)
    wf_t = spectrum.waterfall_push(torch.from_numpy(wf), torch.from_numpy(row))
    wf_j = np.asarray(jspec.waterfall_push(wf, row))
    np.testing.assert_array_equal(wf_t.numpy(), wf_j)
    for bins in (5, -7):
        np.testing.assert_array_equal(
            spectrum.waterfall_shift(wf_t, bins).numpy(),
            np.asarray(jspec.waterfall_shift(wf_j, np.int32(bins))))
    c_t = spectrum.clamp_dynamic_range(wf_t, 60.0)
    c_j = jspec.clamp_dynamic_range(wf_j, np.float32(60.0))
    np.testing.assert_array_equal(c_t.numpy(), np.asarray(c_j))
    np.testing.assert_array_equal(spectrum.to_image_u8(c_t, 60.0).numpy(),
                                  np.asarray(jspec.to_image_u8(c_j, 60.0)))


@pytest.mark.parametrize("pan_dir", ["updown", "up", "down"])
def test_threebox_update_matches_jax(pan_dir):
    """Six ticks with a retune after the third: newest PSD row, waterfall
    image, peaks, background and time pane."""
    fs = 1.024e6
    cfg = dict(fs=fs, fc_hz=7.0e6, nfft=256, rows=12, pan_dir=pan_dir)
    tb = display.ThreeBox(display.DisplayConfig(**cfg), tag="RF",
                          device="cpu")
    jb = jdisp.ThreeBox(jdisp.DisplayConfig(**cfg), tag="RF")
    for k in range(6):
        if k == 3:
            tb.retune(7.0e6 + 40e3)
            jb.retune(7.0e6 + 40e3)
        x = tones(4096, fs, [(100e3 + 8e3 * k, 1.0), (-300e3, 0.05)],
                  seed=k)
        ft, fj = tb.update(x), jb.update(x)
        assert_psd_close(ft.psd_db, np.asarray(fj.psd_db))
        assert np.abs(ft.waterfall_u8.astype(int)
                      - np.asarray(fj.waterfall_u8).astype(int)).max() <= 1
        np.testing.assert_array_equal(ft.freqs_hz, fj.freqs_hz)
        np.testing.assert_array_equal(ft.peak_freqs_hz, fj.peak_freqs_hz)
        assert abs(ft.background_db - fj.background_db) <= 1e-3
        np.testing.assert_allclose(ft.time_y, np.asarray(fj.time_y),
                                   rtol=1e-6)
    tb.clear()
    assert tb._wf.max().item() == -200.0


def test_threebox_static_body_matches_jax_across_controls():
    """Nine updates of the static-buffer body against the JAX ThreeBox,
    with a retune, a dynamic-range change, a clear and a peak-height
    change between them, at test_threebox_update_matches_jax's
    tolerances; the waterfall keeps its address throughout."""
    fs = 1.024e6
    cfg = dict(fs=fs, fc_hz=7.0e6, nfft=256, rows=12)
    tb = display.ThreeBox(display.DisplayConfig(**cfg), tag="RF",
                          device="cpu")
    jb = jdisp.ThreeBox(jdisp.DisplayConfig(**cfg), tag="RF")
    wf = tb._wf
    tb.prepare(4096)
    for k in range(9):
        if k == 2:
            tb.retune(7.0e6 - 24e3)
            jb.retune(7.0e6 - 24e3)
        if k == 4:
            tb.cfg.pan_dr_db = jb.cfg.pan_dr_db = 35.0
        if k == 6:
            tb.clear()
            jb.clear()
        if k == 7:
            tb.cfg.peak_height_db = jb.cfg.peak_height_db = 20.0
        x = tones(4096, fs, [(100e3 + 8e3 * k, 1.0), (-300e3, 0.05)],
                  seed=10 + k)
        ft, fj = tb.update(x), jb.update(x)
        assert_psd_close(ft.psd_db, np.asarray(fj.psd_db))
        assert np.abs(ft.waterfall_u8.astype(int)
                      - np.asarray(fj.waterfall_u8).astype(int)).max() <= 1
        np.testing.assert_array_equal(ft.freqs_hz, fj.freqs_hz)
        np.testing.assert_array_equal(ft.peak_freqs_hz, fj.peak_freqs_hz)
        assert abs(ft.background_db - fj.background_db) <= 1e-3
        np.testing.assert_allclose(ft.time_y, np.asarray(fj.time_y),
                                   rtol=1e-6)
        if k == 6:
            # after the clear one row is live, the rest at the floor
            assert (ft.waterfall_u8[1:] == 0).all()
    assert tb._wf is wf and tb.lengths == [4096] and tb.graph_count == 0


def test_rebinding_the_waterfall_raises_at_the_next_update():
    tb = display.ThreeBox(display.DisplayConfig(fs=48e3, nfft=64, rows=4),
                          device="cpu")
    x = tones(1024, 48e3, [(1e3, 1.0)])
    tb.update(x)
    tb._wf = torch.full_like(tb._wf, -200.0)
    with pytest.raises(RuntimeError, match="rebound"):
        tb.update(x)


def test_a_length_not_prepared_raises():
    tb = display.ThreeBox(display.DisplayConfig(fs=48e3, nfft=64, rows=4),
                          device="cpu")
    tb.prepare(1024)
    tb.update(tones(1024, 48e3, [(1e3, 1.0)]))
    with pytest.raises(ValueError, match="prepared for \\[1024\\]"):
        tb.update(tones(2048, 48e3, [(1e3, 1.0)]))
    assert tb.lengths == [1024]


def functional_frames(cfg, xs):
    """The frames of a pane fed xs, by ops/spectrum's functional forms
    over a waterfall rebound at each update (the port's update before
    its step ran over static buffers)."""
    design = spectrum.SpectrumDesign(fs=cfg.fs, nfft=cfg.nfft,
                                     window=cfg.window)
    window = torch.from_numpy(design.window_array())
    lo, hi = {"up": (cfg.nfft // 2, cfg.nfft),
              "down": (0, cfg.nfft // 2 + 1)}.get(cfg.pan_dir,
                                                  (0, cfg.nfft))
    wf = torch.full((cfg.rows, cfg.nfft), -200.0)
    dr = float(np.float32(cfg.pan_dr_db))
    out = []
    for x in xs:
        x = torch.from_numpy(np.ascontiguousarray(x, np.complex64))
        row = spectrum.periodogram(x, window, nfft=cfg.nfft, hop=design.hop)
        wf = spectrum.waterfall_push(wf, row)
        bg = spectrum.background_median(row)
        img = spectrum.to_image_u8(spectrum.clamp_dynamic_range(
            wf[:, lo:hi], dr), dr)
        pidx, pval = spectrum.find_peaks(
            row[lo:hi], bg + float(np.float32(cfg.peak_height_db)),
            min_dist=cfg.peak_dist_bins)
        step = max(1, x.shape[0] // cfg.time_pts)
        out.append((row[lo:hi].numpy(), img.numpy(), pidx.numpy(),
                    pval.numpy(), float(bg),
                    torch.abs(x[: step * cfg.time_pts:step]).numpy()))
    return out


def test_app_display_frames_equal_the_functional_forms():
    """An in-process App run with --psd --psd-every 1 --bb: the display
    prepared with the bank (RF at in_block, AF and BB at out_block), and
    every frame of every pane equal, bit for bit, to the functional
    forms fed the same blocks."""
    from pysdr_tpu_torch import app as app_mod
    a = app_mod.App(app_mod.build_parser().parse_args(
        ["--device", "cpu", "--fs", "0.512", "--block", "2048",
         "--fc", "0.6", "0.62", "--psd", "--psd-every", "1", "--bb",
         "--blocks", "5"]))
    d, disp = a.bank.design, a.display
    seen = {}
    for box in disp.panes:
        def rec(x, box=box, update=box.update):
            fr = update(x)
            seen.setdefault(box.tag, []).append((np.array(x), fr))
            return fr
        box.update = rec
    assert a.run() == 0
    assert disp.rf.lengths == [d.in_block]
    assert all(b.lengths == [d.out_block] for b in (*disp.af, *disp.bb))
    assert sorted(seen) == ["AF0", "AF1", "BB0", "BB1", "RF"]
    for box in disp.panes:
        got = seen[box.tag]
        assert len(got) == 5, box.tag
        ref = functional_frames(box.cfg, [x for x, _ in got])
        for (_, fr), (psd, img, pidx, pval, bg, env) in zip(got, ref):
            np.testing.assert_array_equal(fr.psd_db, psd)
            np.testing.assert_array_equal(fr.waterfall_u8, img)
            ok = pidx >= 0
            np.testing.assert_array_equal(fr.peak_freqs_hz,
                                          box.freqs_hz[pidx[ok]])
            np.testing.assert_array_equal(fr.peak_vals_db, pval[ok])
            assert fr.background_db == bg
            np.testing.assert_array_equal(fr.time_y, env)
    assert disp.frames["RF"] is seen["RF"][-1][1]


def test_engine_updates_af_panes_on_the_rf_phase():
    """The first drained block updates the AF panes (and every
    decimate-th after), so a run shorter than --psd-every still exports
    them; at most 8 AF panes."""
    class Bank:
        class design:
            fs_in, fs_out = 384e3, 48e3
        cfg = type("C", (), {"fc_hz": 1e6})()
        n_rx, device = 12, torch.device("cpu")

    eng = display.DisplayEngine(Bank(), decimate=4)
    assert len(eng.af) == 8 and eng.rf.fc_hz == 1e6
    audio = tones(2048, 48e3, [(1e3, 0.5)])[None].repeat(12, 0)
    updated, prev = [], None
    for _ in range(6):
        eng(None, audio)
        updated.append(eng.frames.get("AF7") is not prev)
        prev = eng.frames.get("AF7")
    assert updated == [True, False, False, False, True, False]
    seen = []
    eng2 = display.DisplayEngine(Bank(), decimate=4, show_baseband=True)
    for n in range(1, 7):
        seen.append(eng2.wants_next_bb())
        eng2(None, audio)
        eng2.update_bb(audio)
    assert seen == [True, False, False, False, True, False]
    assert "BB0" in eng2.frames


def read_png(path):
    """Minimal PNG reader for what write_png writes (RGB8, filter 0)."""
    data = open(path, "rb").read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, chunks = 8, {}
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        (crc,) = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        assert crc == zlib.crc32(tag + body)
        chunks[tag] = chunks.get(tag, b"") + body
        pos += 12 + n
    w, h, depth, ctype = struct.unpack(">IIBB", chunks[b"IHDR"][:10])
    assert (depth, ctype) == (8, 2)
    raw = zlib.decompress(chunks[b"IDAT"])
    rows = np.frombuffer(raw, np.uint8).reshape(h, 1 + 3 * w)
    assert (rows[:, 0] == 0).all()
    return rows[:, 1:].reshape(h, w, 3)


def test_png_round_trip_and_luts_match_jax(tmp_path):
    rng = np.random.default_rng(5)
    img = rng.integers(0, 256, (17, 33), dtype=np.uint8)
    for name in display.colormap_names():
        np.testing.assert_array_equal(display.colormap_lut(name),
                                      jdisp.colormap_lut(name))
    assert display.colormap_names() == jdisp.colormap_names()
    rgb = display.render_rgb(img, display.colormap_lut("viridis"))
    p = str(tmp_path / "wf.png")
    display.write_png(p, rgb)
    np.testing.assert_array_equal(read_png(p), rgb)
    jdisp.write_png(str(tmp_path / "ref.png"), rgb)
    assert open(p, "rb").read() == open(tmp_path / "ref.png", "rb").read()


def test_spots_snap_and_recolor():
    sl = display.SpotList()
    sl.add(7.074e6, "K1ABC")
    sl.add(7.080e6, "W2XYZ")
    assert sl.snap(7.0745e6, 2e3).label == "K1ABC"
    assert sl.snap(7.2e6, 2e3) is None
    assert sl.recolor("W2XYZ", "red") == 1
    assert [s.label for s in sl.in_span(7.079e6, 7.1e6)] == ["W2XYZ"]
    sl.remove_all()
    assert len(sl) == 0
