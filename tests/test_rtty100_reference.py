"""The benchmark's rtty100 configuration on the CPU: its plain reference
decoder (sdrbench/chains/rtty.py) against the port's RTTYDecoder, block
by block at a small size, and under TF32 against its own float32; the
scene's layout and keying, which the seed does not change; the decoder's
per-block profiler ranges and counters; and a tiny cell of the chain
through the benchmark's harness, its tap and readers.

    python -m pytest -q tests/test_rtty100_reference.py
"""

import math

import numpy as np
import pytest
import torch

from pysdr_tpu_torch.models import rtty as prtty
from sdrbench import harness, reference, registry, scene

torch.set_num_threads(1)

chain = registry.module("chains", "rtty")
fsk = registry.module("stations", "fsk")

FS = 96000.0
BLOCK = 2048
N_CHARS = 17                    # 2.99 s at 96 kHz
# the scores of one block, port (the twin's matmul over unfold windows)
# against the reference (its matmul through Arith): 32-term float32 dot
# products of soft bits of at most 1 from the same spectra, so they agree
# to float32 rounding, a few parts in 2^24; TF32's 10-bit operands move
# them by about 1e-4
SCORE_TOL = 1e-6
SEEDS = (2**31 + 101, 3_000_000_019, 17)


def _stations(n_st: int, n: int, seed: int) -> torch.Tensor:
    """n_st FSK stations at 96 kHz on the 460 Hz pitch around 137 Hz, one
    seeded level each in a 6 dB range, over white noise, complex64."""
    gen = torch.Generator().manual_seed(seed)
    rng = np.random.default_rng(seed)
    x = torch.zeros(n, dtype=torch.complex128)
    for i in range(n_st):
        off = (i - n_st // 2) * 460.0 + 137.0
        s = {"offset_hz": off,
             "tone_phases": [float(rng.uniform(0, 2 * np.pi))]}
        x += rng.uniform(0.5, 1.0) * fsk.baseband(s, n, FS, gen, "cpu") \
            * scene.carrier(0, n, off, FS, "cpu")
    return (x + 0.05 * torch.randn(n, dtype=torch.complex128,
                                   generator=gen)).to(torch.complex64)


def _port(x: torch.Tensor) -> tuple[dict, dict]:
    """The port's decoder over x in BLOCK-sample blocks: {block: (texts,
    marks)} and the scores it pulled, by block."""
    dec = prtty.RTTYDecoder(prtty.RTTYDesign(fs=FS), device="cpu")
    pulled, out = {}, {}
    pull = dec._pull

    def keep(t, slot):
        h = pull(t, slot)
        if slot == "scores":
            pulled[len(out)] = np.array(h)
        return h
    dec._pull = keep
    for i in range(x.shape[0] // BLOCK):
        texts = dec.decode_block(x[i * BLOCK:(i + 1) * BLOCK])
        out[i] = (tuple(texts), tuple(c["mark_bin"] for c in dec.channels))
    return out, pulled


@pytest.fixture(scope="module")
def eight():
    x = _stations(8, N_CHARS * 8 * 2112, 5)
    n = x.shape[0] // BLOCK * BLOCK
    ref = chain.decode_stream(x[:n], BLOCK, chain.Design(FS),
                              reference.Arith(), keep=lambda i: True)
    return x, ref


def _rel(a, b) -> float:
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def test_reference_decoder_matches_the_port_block_by_block(eight):
    """(a) 8 stations at 96 kHz, 3 s in 2048-sample blocks: the plain
    reference gives the port's channels and text in every block, and
    its scores within SCORE_TOL wherever the port pulled some."""
    x, ref = eight
    got, pulled = _port(x)
    assert set(got) == set(ref)
    for i, (texts, marks) in got.items():
        assert (texts, marks) == (ref[i].texts, ref[i].marks), i
        assert (i in pulled) == (ref[i].scores is not None), i
        if i in pulled:
            assert _rel(pulled[i], ref[i].scores) <= SCORE_TOL, i
    assert len(pulled) > 100
    text = "".join("".join(o.texts) for o in ref.values())
    assert len(text) > 8 * N_CHARS // 2


def test_tf32_reference_fails_the_score_tolerance(eight):
    """(b) The same reference with its products' operands rounded to
    TF32 moves the scores past SCORE_TOL."""
    x, ref = eight
    n = x.shape[0] // BLOCK * BLOCK
    tf = chain.decode_stream(x[:n], BLOCK, chain.Design(FS),
                             reference.Arith(tf32=True), keep=lambda i: True)
    worst = max(_rel(tf[i].scores, r.scores) for i, r in ref.items()
                if r.scores is not None)
    assert worst > 10 * SCORE_TOL


def test_rtty100_scene_is_the_same_work_for_every_seed():
    """(c) rtty100's plan at 3 seeds: 100 FSK stations at the same
    offsets, levels within 6 dB, 24 characters a station in a capture of
    the same length, and a scene of that layout as long for each seed."""
    sc = registry.load_json("configs", "rtty100")["scene"]
    lo, hi = sc["level"]
    assert 20 * math.log10(hi / lo) <= 6.03
    plans = [scene.station_plan(sc, s) for s in SEEDS]
    offsets = [s["offset_hz"] for s in plans[0]]
    assert len(offsets) == 100
    assert np.allclose(np.diff(offsets), 460.0)
    for p in plans:
        assert [s["offset_hz"] for s in p] == offsets
        assert {s["kind"] for s in p} == {"fsk"}
        assert all(lo <= s["level"] <= hi for s in p)
    n_chars = fsk.char_count(sc["samples"], sc["fs"])
    assert n_chars == 24
    texts = []
    for seed in SEEDS:
        gen = torch.Generator().manual_seed(seed)
        codes = [fsk.characters(n_chars, gen, "cpu") for _ in range(100)]
        assert all(len(c) == n_chars and c[0] == fsk.LTRS for c in codes)
        texts.append(codes)
    assert texts[0] != texts[1]
    one = dict(sc, samples=8 * fsk.bit_samples(sc["fs"]))
    for seed in SEEDS:
        assert scene.make_scene(one, seed, "cpu").shape == (one["samples"],)


def test_rtty100_loop_is_whole_characters_and_closes_its_phase():
    """(d) The capture is a whole number of 8-bit characters, and a
    station looped keeps its phase where the loop closes: the step from
    its last sample to its first is the step inside its last bit."""
    sc = registry.load_json("configs", "rtty100")["scene"]
    per_char = 8 * fsk.bit_samples(sc["fs"])
    assert sc["samples"] % per_char == 0
    assert sc["samples"] // per_char * per_char == 24 * 8 * 45056
    with pytest.raises(ValueError):
        fsk.char_count(sc["samples"] + 1, sc["fs"])
    n = 3 * 8 * fsk.bit_samples(FS)
    s = {"offset_hz": 1234.5, "tone_phases": [0.7]}
    x = (fsk.baseband(s, n, FS, torch.Generator().manual_seed(3), "cpu")
         * scene.carrier(0, n, s["offset_hz"], FS, "cpu")).numpy()
    inner = np.angle(x[-1] / x[-2])
    seam = np.angle(x[0] / x[-1])
    assert abs(seam - inner) < 1e-3
    assert abs(np.angle(x[0]) - 0.7) < 1e-9


def test_decode_block_ranges_by_block_id_and_counters():
    """(e) decode_block(..., block_id=k) under a profiler records the
    four ranges pysdr.rtty_<stage>#k, and the counters advance: the
    characters decoded, the rescans, the blocks that ran the
    filterbank."""
    x = _stations(4, 12 * 8 * 2112, 9)
    dec = prtty.RTTYDecoder(prtty.RTTYDesign(fs=FS), device="cpu")
    assert dec.counters == {"chars": 0, "rescans": 0,
                            "filterbank_blocks": 0}
    k = 0
    while dec.counters["chars"] == 0 or dec.counters["rescans"] == 0:
        dec.decode_block(x[k * BLOCK:(k + 1) * BLOCK])
        k += 1
    before = dict(dec.counters)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        dec.decode_block(x[k * BLOCK:(k + 1) * BLOCK], block_id=k)
    names = {e.name for e in prof.events()}
    for stage in prtty.STAGES:
        assert f"pysdr.rtty_{stage}#{k}" in names, (stage, sorted(names))
    assert dec.counters["filterbank_blocks"] == \
        before["filterbank_blocks"] + 1 == dec.stage_blocks
    for j in range(k + 1, k + 12):
        dec.decode_block(x[j * BLOCK:(j + 1) * BLOCK], block_id=j)
    assert dec.counters["chars"] > before["chars"]
    assert dec.counters["rescans"] > before["rescans"]


TINY_N_ST = 8
TINY = {
    "argv": ["--fs", "0.384", "--fc", "14.085", "--mode", "RTTY",
             "--fs-out", "96", "--rtty", "0"],
    "scene": {"samples": 12 * 8 * 8448, "fs": 384000.0,
              "fc": 14.085e6 - 60e3, "noise_rms": 0.02,
              "level": [0.05, 0.1],
              "stations": [{"kind": "fsk",
                            "offset_hz": 60e3 + (i - 4) * 460.0 + 137.0}
                           for i in range(TINY_N_ST)]},
    "reference": {"kind": "rtty", "fc_mhz": [14.085], "modes": ["RTTY"],
                  "fs_in": 384000.0, "fs_out": 96000.0,
                  "channels": TINY_N_ST}}


def test_tiny_rtty_cell_is_correct_through_the_harness(monkeypatch):
    """rtty100's chain and traffic at 384 kHz with 8 stations, open loop
    on the CPU: the tap records every delivered block, the run is correct
    under rtty100.live_1x's limits, the decoder's stages reach their
    readers, and the roofline's launch table holds rtty_scores'. The
    scores of every 5th block are compared, so the short window has
    some."""
    monkeypatch.setattr(chain, "SCORE_EVERY", 5)
    tr = dict(registry.load_json("traffic", "live_1x_cu8"), rate=0.5,
              warm_blocks=4, compare_blocks=3, trace_blocks=4)
    c = harness.Cell("tiny.rtty", TINY, tr,
                     dict(harness.cell("rtty100.live_1x").checks))
    res = harness.run_cell(c, 2**31 + 7, 0.6, False, "cpu",
                           log=lambda *a: None)
    run, checks = res["run"], res["checks"]
    assert harness.correct(res), checks
    assert checks["rtty_scores_rel_err"][0] is not None
    assert checks["rtty_channel_mismatch"][0] == 0
    for stage in prtty.STAGES:
        v = harness.reader(f"rtty_{stage}_ms.live")(run)
        assert v is not None and v >= 0, stage
    # every block but the stream's first (2048 samples, under a bit's
    # 2112) completes frames
    assert run.tap_counters["rtty_filterbank_blocks"] == run.blocks_run - 1
    assert run.tap_counters["rtty_chars"] > 0
    (n_bytes, n_ops), = run.launches["rtty_scores"]
    assert n_bytes > 0 and n_ops > 0


def test_decoder_readers_read_none_without_counters():
    """The new readers read None where the run has no decoder counters
    (a program without them) or no trace."""
    run = harness.Run(loop="open", seconds=1.0, in_block=1, setup_s=1.0,
                      t_open=0.0, t_close=1.0, delivered=[], due=[],
                      window_blocks=range(0), blocks_run=10, stage_ms={},
                      launches={}, host={}, trace_blocks=1, trace=None)
    for m in ("rtty_spectrum_ms.live", "rtty_detect_ms.live",
              "rtty_scores_ms.live", "rtty_channels_ms.live",
              "rtty_scores_roofline.live"):
        assert harness.reader(m)(run) is None, m
