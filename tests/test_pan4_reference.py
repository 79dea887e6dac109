"""The benchmark's pan4 configuration on the CPU: its plain reference
display (sdrbench/chains/pan.py) against the port's DisplayEngine, update
by update past the waterfall's depth; the reference's RF pane computed
from the RF rounded to bfloat16, which the cell's display limits must
refuse; the display's per-block profiler ranges, stage times and frame
counters; and tiny cells of the chain through the benchmark's harness,
its tap and readers.

    python -m pytest -q tests/test_pan4_reference.py
"""

import numpy as np
import pytest
import torch

from pysdr_tpu_torch import app as app_mod
from pysdr_tpu_torch.models import display
from sdrbench import harness, reference, registry, scene
from sdrbench.tests import tiny

torch.set_num_threads(1)

pan = registry.module("chains", "pan")

FS = 512000.0
SEED = 2**31 + 2027
# the small bank: two receivers 100 kHz apart in a 512 kHz passband
SCENE = {"samples": 400000, "fs": FS, "fc": 100.05e6, "noise_rms": 0.02,
         "level": [0.05, 0.1],
         "stations": [{"kind": "am", "offset_hz": -50e3},
                      {"kind": "usb", "offset_hz": 50e3}]}
ARGV = ["--fs", "0.512", "--fc", "100.0", "100.1", "--modes", "AM", "USB",
        "--block", "1024"]
CHAIN = pan.build({"kind": "pan", "fc_mhz": [100.0, 100.1],
                   "modes": ["AM", "USB"], "fs_in": FS, "fs_out": 48000.0},
                  SCENE["fc"], 1024)
UPDATES = 112                   # past the waterfall's 100 rows
PAN4 = harness.cell("pan4.live_1x")
# The port's pane and the reference's take the same float32 sums in
# another order and shape (a batch of blocks, the mean after the
# division): a power's relative rounding of ~1e-6 is 4e-6 dB, and a dB
# value near -100 has an ulp of 7.6e-6; 1e-4 dB leaves room for both.
PSD_TOL_DB = 1e-4
# a value an ulp off a code's edge lands one code over
CODE_TOL = 1


@pytest.fixture(scope="module")
def capture(tmp_path_factory):
    raw = scene.to_capture(scene.make_scene(SCENE, SEED, "cpu"),
                           scene.capture_format("complex64"))
    path = str(tmp_path_factory.mktemp("pan4") / "scene.dat")
    scene.write_capture(path, raw, scene.capture_format("complex64"), FS,
                        SCENE["fc"])
    return path, raw


@pytest.fixture(scope="module")
def drawn(capture):
    """The port's panes over UPDATES blocks of the small bank (one RF, AF
    and BB pane), each update's input block and frame by pane."""
    a = app_mod.App(app_mod.build_parser().parse_args(
        ["--device", "cpu", *ARGV, "--psd", "--bb", "--psd-every", "1",
         "--blocks", str(UPDATES), "--replay", capture[0]]))
    a.display = display.DisplayEngine(a.bank, show_baseband=True, max_af=1)
    seen = {}
    for box in a.display.panes:
        def rec(x, box=box, update=box.update):
            fr = update(x)
            seen.setdefault(box.tag, []).append((np.array(x), fr))
            return fr
        box.update = rec
    assert a.run() == 0
    return seen


def _reference(pane, xs):
    """The reference pane's frame of every update of the blocks xs."""
    rows, env = pane.stream(torch.from_numpy(np.stack(xs)))
    return [pane.frame(rows[:i + 1].flip(0), env[i])
            for i in range(len(xs))]


def test_reference_display_matches_the_port_update_by_update(drawn):
    """(a) The reference's panes fed the blocks the port's panes were fed
    give each update's PSD row within PSD_TOL_DB, the waterfall's codes
    within CODE_TOL (the waterfall wrapped: 112 updates of 100 rows), the
    same peaks and the same time pane."""
    panes = CHAIN.panes()
    assert sorted(drawn) == ["AF0", "BB0", "RF"]
    for tag, got in drawn.items():
        assert len(got) == UPDATES, tag
        want = _reference(panes[tag], [x for x, _ in got])
        for i, ((_, fr), w) in enumerate(zip(got, want)):
            g = pan.Frame.of(fr)
            assert np.abs(g.psd - w.psd).max() <= PSD_TOL_DB, (tag, i)
            assert np.abs(g.img.astype(int) - w.img).max() <= CODE_TOL, \
                (tag, i)
            np.testing.assert_array_equal(g.peaks, w.peaks, err_msg=tag)
            np.testing.assert_array_equal(g.env, w.env, err_msg=tag)
        assert (w.img > 0).any() and len(w.peaks) > 0, tag


def test_bfloat16_rf_pane_fails_the_display_limits(capture):
    """(b) The reference's RF pane from the RF rounded to bfloat16 (the
    precision below the configuration's float32; TF32, control.py's,
    moves only the audio and the baseband) against its float32 frames,
    every 11th block of 112 and the last: pan4.live_1x's display limits
    refuse it."""
    n = CHAIN.in_block
    x = harness.rf_tensor(capture[1], scene.capture_format("complex64"),
                          "f32", 0, UPDATES * n, "cpu")
    xb = torch.view_as_complex(torch.view_as_real(x).to(torch.bfloat16)
                               .float().contiguous())
    pane = CHAIN.panes()["RF"]
    blocks = [i for i in range(UPDATES) if i % 11 == 0] + [UPDATES - 1]
    f32, b16 = (pane.stream(v.view(UPDATES, n)) for v in (x, xb))
    pairs = [({"RF": pane.frame(b16[0][:i + 1].flip(0), b16[1][i])},
              {"RF": pane.frame(f32[0][:i + 1].flip(0), f32[1][i])})
             for i in blocks]
    got = pan.measures(pairs, {"RF": pane})
    limits = PAN4.checks
    assert not harness.passed({k: (v, limits[k]) for k, v in got.items()}), \
        got
    assert got["display_rf_psd_db_err"] > limits["display_rf_psd_db_err"], \
        got


def test_display_ranges_by_block_id_stage_ms_and_counters():
    """(c) Each domain's updates of a block under a profiler record the
    range pysdr.display_<domain>#<block id>, the id the block's call
    gave; stage_ms sums each domain's
    ms and the pulls' wait (none on the CPU), and counters the frames."""
    class Bank:
        class design:
            fs_in, fs_out, in_block, out_block = 384e3, 48e3, 8192, 1024
        cfg = type("C", (), {"fc_hz": 1e6})()
        n_rx, device = 3, torch.device("cpu")

    eng = display.DisplayEngine(Bank(), show_baseband=True)
    assert eng.counters == {"rf": 0, "af": 0, "bb": 0}
    assert eng.stage_ms == {"rf": 0.0, "af": 0.0, "bb": 0.0, "wait": 0.0}
    rng = np.random.default_rng(1)
    audio = (rng.standard_normal((3, 1024))
             + 1j * rng.standard_normal((3, 1024))).astype(np.complex64)
    rf = (rng.standard_normal(8192)
          + 1j * rng.standard_normal(8192)).astype(np.complex64)
    eng(None, audio, 6)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        eng(None, audio, 7)
        eng.update_rf(rf)
        eng.update_bb(audio)
    names = {e.name for e in prof.events()}
    for domain in display.DOMAINS:
        assert f"pysdr.display_{domain}#7" in names, sorted(names)
    eng.update_rf(rf)
    assert eng.counters == {"rf": 2, "af": 6, "bb": 3}
    ms = eng.stage_ms
    assert all(ms[d] > 0 for d in display.DOMAINS) and ms["wait"] == 0.0
    assert sorted(eng.frames) == ["AF0", "AF1", "AF2", "BB0", "BB1", "BB2",
                                  "RF"]


TINY = dict(tiny.BANK, argv=tiny.BANK["argv"] + ["--psd", "--bb",
                                                 "--psd-every", "1"],
            reference=dict(tiny.BANK["reference"], kind="pan"))
READERS = ("display_rf_ms.live", "display_af_ms.live", "display_bb_ms.live",
           "display_wait_ms.live")


def _tiny_run(monkeypatch, tr, seconds):
    """A tiny pan cell under pan4.live_1x's limits, every 5th block
    compared: (the run's record, {block: the tap's Kept or None} of the
    blocks output_measures was given)."""
    monkeypatch.setattr(pan, "SAMPLE_EVERY", 5)
    given = {}
    measure = pan.Pan.output_measures

    def spy(self, prog, ref):
        given.update(prog)
        return measure(self, prog, ref)
    monkeypatch.setattr(pan.Pan, "output_measures", spy)
    c = harness.Cell("tiny.pan", TINY, tr,
                     dict(PAN4.checks))
    return harness.run_cell(c, SEED, seconds, False, "cpu",
                            log=lambda *a: None), given


def test_tiny_pan_cell_is_correct_through_the_harness(monkeypatch):
    """(d) pan4's chain and traffic on the tiny bank (1.92 MHz), open
    loop on the CPU: correct under pan4.live_1x's limits; the tap keeps
    every 5th block and the window's last two; the four readers read the
    display's stages a block and the counters count its frames."""
    res, given = _tiny_run(monkeypatch, tiny.traffic("open"), 0.8)
    run, checks = res["run"], res["checks"]
    assert harness.correct(res), checks
    for k in pan.MEASURES:
        assert checks[k][0] is not None, k
    window = run.window_blocks
    assert sorted(given) == list(window)
    kept = {i for i, k in given.items() if k is not None}
    sampled = {i for i in window if i % 5 == 0}
    assert kept - sampled == set([i for i in window if i % 5][-2:])
    # the RF pane's last (up to) 100 updates, one a delivered block, each
    # of the block delivered or one dispatched after it
    for i in kept:
        rf = np.array(given[i].rf_blocks)
        assert len(rf) == min(100, i + 1), i
        assert (rf >= i - np.arange(len(rf))).all(), i
        assert (np.diff(rf) <= 0).all(), i
        assert sorted(given[i].frames) == sorted(
            pan.build(TINY["reference"], 0.0, 1024).panes())
    for m in READERS:
        v = harness.reader(m)(run)
        assert v is not None and v >= 0, m
    assert harness.reader("display_rf_ms.live")(run) > 0
    tc = run.tap_counters
    assert (tc["display_rf_frames"], tc["display_af_frames"],
            tc["display_bb_frames"]) == (run.blocks_run, 4 * run.blocks_run,
                                         4 * run.blocks_run)


def test_rf_pane_record_follows_a_late_drain(monkeypatch):
    """Without prefetch a block drains at the take of the block
    pipeline_depth + 1 later, so the RF pane shows a later block than the
    drained one: the tap records the RF blocks shown, the reference's RF
    waterfall follows them, and the closed-loop run is correct."""
    tr = dict(tiny.traffic("closed"), prefetch=False)
    res, given = _tiny_run(monkeypatch, tr, 0.5)
    assert harness.correct(res), res["checks"]
    lead = [k.rf_blocks[0] - i for i, k in given.items() if k is not None]
    # pipeline_depth blocks ahead, fewer at a run's end, where the last
    # blocks drain after the last dispatch
    assert lead and max(lead) == tr["pipeline_depth"] and min(lead) >= 0


def test_compared_blocks_leave_out_an_rf_block_past_the_stream(
        monkeypatch):
    """The last block whose RF pane showed a block past the reference's
    stream (it drained after the next block's dispatch) is not compared;
    the block before it is, and every compared block compares all its
    panes."""
    nb = 7
    rng = np.random.default_rng(3)
    panes = CHAIN.panes()

    def noise(n):
        return torch.from_numpy((rng.standard_normal((nb, n))
                                 + 1j * rng.standard_normal((nb, n)))
                                .astype(np.complex64))
    stream = pan.Stream({
        tag: (p, *p.stream(noise(CHAIN.in_block if tag == "RF"
                                 else CHAIN.out_block)))
        for tag, p in panes.items()})
    assert stream.n_blocks == nb

    class Drawn:
        """A Kept stand-in: the reference's frames of a block, the RF
        pane's from the RF blocks given."""
        def __init__(self, block, rf_blocks):
            self.shown = pan.Shown(stream, block)
            self.rf_blocks = tuple(rf_blocks)

        def pane_frames(self):
            return self.shown.pane_frames(self.rf_blocks)

    # block 6 drained after block 7's dispatch, past the stream's 7 blocks
    prog = {i: Drawn(i, range(i + 1, -1, -1)) for i in (0, 5, 6)}
    pairs = []
    measures = pan.measures
    monkeypatch.setattr(pan, "measures",
                        lambda p, q: pairs.extend(p) or measures(p, q))
    got = CHAIN.output_measures(prog, {i: pan.Shown(stream, i)
                                       for i in prog})
    assert len(pairs) == 2
    for g, w in pairs:
        assert sorted(g) == sorted(w) == sorted(panes)
    assert got == dict.fromkeys(pan.MEASURES, 0.0)


def test_display_readers_read_none_without_counters():
    """The readers read None where the run has no display counters (a
    program without them)."""
    run = harness.Run(loop="open", seconds=1.0, in_block=1, setup_s=1.0,
                      t_open=0.0, t_close=1.0, delivered=[], due=[],
                      window_blocks=range(0), blocks_run=10, stage_ms={},
                      launches={}, host={}, trace_blocks=1, trace=None)
    for m in READERS:
        assert harness.reader(m)(run) is None, m


def test_pan4_config_is_bank4_with_the_display():
    """pan4 is bank4's receivers, scene and reference with `--psd --bb
    --psd-every 1`, cut nowhere; its chain's blocks are bank4's."""
    bank4 = registry.load_json("configs", "bank4")
    pan4 = registry.load_json("configs", "pan4")
    assert pan4["argv"] == bank4["argv"] + ["--psd", "--bb", "--psd-every",
                                            "1"]
    assert pan4["scene"] == bank4["scene"] and pan4["reduced"] == []
    assert pan4["reference"] == dict(bank4["reference"], kind="pan")
    assert len(pan4["source"]) <= 200
    ch = reference.chain_of(pan4["reference"], pan4["scene"]["fc"],
                            PAN4.traffic["block"])
    assert (ch.in_block, ch.out_block) == (171000, 1026)
    assert sorted(ch.panes()) == ["AF0", "AF1", "AF2", "AF3", "BB0", "BB1",
                                  "BB2", "BB3", "RF"]
