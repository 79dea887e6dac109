"""Parity of the port's wideband RTTY decoder against pysdr_tpu's (JAX on
the CPU): the design, templates and synthesizer are equal; the device
functions agree within their tolerances; every scenario of
tests/test_rtty.py gives the same channel lists and the same text per
decode_block call (but where a channel's timing search meets a near-tie
that float rounding decides, which only the 100-station 48 kHz block
does, and which the test proves for each such channel); the
100-station composite at 96 kHz decodes channel
by channel as the JAX decoder does; a port decoder continued from a
JAX decoder's mid-stream state emits what the JAX decoder emits; and the
filterbank over its static buffers, one set a frame count, gives the
JAX decoder's text, spectrum and tails call by call, with the frame
counts prepare() works out equal to those a stream gives."""

import copy
import os
import re

import numpy as np
import pytest
import torch

from pysdr_tpu.models import rtty as jrtty
from pysdr_tpu.ops import cplx as jcplx
from pysdr_tpu_torch import convert
from pysdr_tpu_torch.models import rtty

torch.set_num_threads(1)

FS = (12000.0, 48000.0, 96000.0)
# matched scores, port against JAX: 32 terms of at most 1 in magnitude
# through two FFT libraries
SCORE_TOL = 1e-4


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("fs", FS)
def test_design_templates_and_synth_equal(fs):
    d, jd = rtty.RTTYDesign(fs=fs), jrtty.RTTYDesign(fs=fs)
    for name in ("bit_len", "nfft", "hop", "bin_hz", "shift_bins",
                 "bits_per_char", "frames_per_char"):
        assert getattr(d, name) == getattr(jd, name), name
    np.testing.assert_array_equal(d.window(), jd.window())
    np.testing.assert_array_equal(rtty.char_templates(d),
                                  jrtty.char_templates(jd))
    assert rtty.BAUDOT_LTRS == jrtty.BAUDOT_LTRS
    assert rtty.BAUDOT_FIGS == jrtty.BAUDOT_FIGS
    args = ("RYRY CQ 599 DE AA2IL", )
    kw = dict(carrier_hz=-700.0, amplitude=0.7, snr_db=15.0, seed=3)
    np.testing.assert_array_equal(rtty.synthesize_rtty(*args, d, **kw),
                                  jrtty.synthesize_rtty(*args, jd, **kw))


@pytest.mark.parametrize("fs", FS)
def test_filterbank_block_matches_jax(fs):
    """Magnitudes within 1e-5 of the largest (f32 FFTs of two
    libraries)."""
    d, jd = rtty.RTTYDesign(fs=fs), jrtty.RTTYDesign(fs=fs)
    rng = np.random.default_rng(1)
    n = 9 * d.bit_len + 17
    x = (rng.standard_normal(n) + 1j * rng.standard_normal(n)) \
        .astype(np.complex64)
    want = np.asarray(jrtty.filterbank_block(jcplx.pack(x), jd,
                                             jd.window()))
    got = rtty.filterbank_block(t(x), d, t(d.window())).numpy()
    assert got.shape == want.shape == ((n - d.bit_len) // d.hop + 1, d.nfft)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def score_inputs(seed, frames=43, nfft=4096, n_ch=100, tail=64, L=32):
    """Random magnitudes, bins (space bins of low marks wrap modulo
    nfft), a soft tail in [-1, 1] and the 32 templates of L frames."""
    rng = np.random.default_rng(seed)
    mags = rng.uniform(0.0, 2.0, (frames, nfft)).astype(np.float32)
    mark = rng.integers(0, nfft, n_ch).astype(np.int32)
    mark[:2] = (0, 3)
    space = ((mark - 40) % nfft).astype(np.int32)
    soft_tail = rng.uniform(-1, 1, (tail, n_ch)).astype(np.float32)
    fpb = L // 8
    templates = rtty.char_templates(rtty.RTTYDesign(fs=48e3,
                                                    frames_per_bit=fpb))
    return mags, mark, space, soft_tail, templates


def test_soft_bits_and_scores_match_jax():
    """soft bits within 1e-5 absolute; matched scores (32 terms of at most
    1 in magnitude) within 1e-4 absolute."""
    mags, mark, space, tail, tmpl = score_inputs(2)
    j_soft = np.asarray(jrtty.soft_bits(mags, mark, space))
    soft = rtty.soft_bits(t(mags), t(mark), t(space)).numpy()
    assert np.abs(soft - j_soft).max() <= 1e-5
    full = np.concatenate([tail, j_soft])
    j_sc = np.asarray(jrtty.matched_scores(full, tmpl))
    sc = rtty.matched_scores(t(full), t(tmpl)).numpy()
    assert sc.shape == j_sc.shape == (64 + 43 - 32 + 1, 100, 32)
    assert np.abs(sc - j_sc).max() <= SCORE_TOL
    soft_all, sc_all = rtty.rtty_scores(t(mags), t(mark), t(space), t(tail),
                                        t(tmpl))
    assert np.abs(soft_all.numpy() - full).max() <= 1e-5
    assert np.abs(sc_all.numpy() - j_sc).max() <= SCORE_TOL


@pytest.mark.parametrize("frames,tail", [(10, 0), (20, 11), (0, 5)])
def test_rtty_scores_ref_below_one_character(frames, tail):
    """Fewer than L frames in all: the soft rows, and no scores."""
    mags, mark, space, soft_tail, tmpl = score_inputs(3, frames=frames,
                                                      tail=tail, n_ch=3)
    soft, sc = rtty.rtty_scores_ref(t(mags), t(mark), t(space),
                                    t(soft_tail), t(tmpl))
    assert soft.shape == (frames + tail, 3) and sc.shape == (0, 3, 32)
    np.testing.assert_array_equal(soft[:tail].numpy(), soft_tail)



# ---- csrc/rtty.cu's decomposition, emulated in numpy ----
#
# The kernel cannot run here. emulate_rtty_scores repeats its
# decomposition (a block per channel; offsets in chunks, each chunk's
# soft rows staged with zeros past the last row; warps over groups of
# consecutive offsets, lane = symbol; soft rows written by the chunk that
# owns them) at the constants of csrc/rtty.cu, checks the shared-memory
# bound and that every soft row and score is written once, and is held
# against the twin and the JAX soft bits and matched scores.

def cu_constants(name):
    """The `constexpr int kName = <literal>;` constants of a kernel
    source."""
    with open(os.path.join(os.path.dirname(rtty.__file__), os.pardir,
                           "csrc", name)) as f:
        return {k: int(v) for k, v in
                re.findall(r"constexpr int (\w+) = (\d+);", f.read())}


def emulate_rtty_scores(mags, mark, space, tail, tmpl):
    c = cu_constants("rtty.cu")
    warps, group, chunk = c["kWarps"], c["kGroup"], c["kChunk"]
    f, nfft = mags.shape
    nch, t_rows, L = len(mark), tail.shape[0], tmpl.shape[1]
    rows_total = t_rows + f
    n_off = max(rows_total - L + 1, 0)
    soft = np.full((rows_total, nch), np.nan, np.float32)
    scores = np.full((n_off, nch, 32), np.nan, np.float32)
    chunks = -(-n_off // chunk) if n_off else 1
    for ch in range(nch):
        mb, sb = mark[ch] % nfft, space[ch] % nfft
        for j in range(chunks):
            o0 = j * chunk
            o_end = min(o0 + chunk, n_off)
            write_end = rows_total if j == chunks - 1 else o0 + chunk
            stage_end = max(o_end + group - 1 + L - 1, write_end)
            assert stage_end - o0 <= chunk + group - 1 + L - 1
            r = np.arange(o0, stage_end)
            val = np.zeros(len(r), np.float32)
            old, new = r < t_rows, (r >= t_rows) & (r < rows_total)
            val[old] = tail[r[old], ch]
            m = mags[r[new] - t_rows, mb]
            s = mags[r[new] - t_rows, sb]
            val[new] = (m - s) / (m + s + np.float32(1e-9))
            own = r < write_end
            assert np.isnan(soft[r[own], ch]).all()
            soft[r[own], ch] = val[own]
            starts = [o for w in range(warps)
                      for o in range(o0 + w * group, o_end, warps * group)]
            assert sorted(starts) == list(range(o0, o_end, group))
            for o in starts:
                acc = np.zeros((group, 32), np.float32)
                for t_ in range(L):           # template order
                    acc = acc + val[o - o0 + t_:o - o0 + t_ + group, None] \
                        * tmpl[None, :, t_]
                q = np.arange(group)[o + np.arange(group) < o_end]
                assert np.isnan(scores[o + q, ch]).all()
                scores[o + q, ch] = acc[q]
    return soft, scores


# (frames, n_ch, tail): the 100-channel decoder without and with its
# soft tail, 77 offsets (not a multiple of a group or a pass), fewer
# rows than a character, and 289 offsets in two chunks
RTTY_EMULATION_CASES = [(43, 100, 0), (43, 100, 64), (43, 100, 65),
                        (5, 3, 20), (300, 3, 20)]


@pytest.mark.parametrize("frames,n_ch,tail", RTTY_EMULATION_CASES)
def test_rtty_scores_emulation_matches_twin_and_jax(frames, n_ch, tail):
    """Soft rows bit-equal to the twin's and within 1e-5 of JAX's; scores
    within 1e-5 of the twin and SCORE_TOL of JAX."""
    mags, mark, space, soft_tail, tmpl = score_inputs(
        4 + frames + tail, frames=frames, n_ch=n_ch, tail=tail)
    soft, sc = emulate_rtty_scores(mags, mark, space, soft_tail, tmpl)
    soft_t, sc_t = rtty.rtty_scores_ref(t(mags), t(mark), t(space),
                                        t(soft_tail), t(tmpl))
    assert not np.isnan(soft).any() and not np.isnan(sc).any()
    np.testing.assert_array_equal(soft, soft_t.numpy())
    assert sc.shape == sc_t.shape
    j_soft = np.concatenate([soft_tail, np.asarray(
        jrtty.soft_bits(mags, mark, space))])
    assert np.abs(soft - j_soft).max() <= 1e-5
    if sc.size:
        assert np.abs(sc - sc_t.numpy()).max() <= 1e-5
        j_sc = np.asarray(jrtty.matched_scores(j_soft, tmpl))
        assert np.abs(sc - j_sc).max() <= SCORE_TOL


# ---- the decoder, scenario by scenario (tests/test_rtty.py) ----

def pk(v):
    return np.stack([v.real, v.imag], -1).astype(np.float32)


def sc_single(d):
    return {}, [pk(jrtty.synthesize_rtty("CQ CQ DE AA2IL", d,
                                         carrier_hz=1000.0))], ("CQ", "AA2IL")


def sc_noisy(d):
    return {}, [pk(jrtty.synthesize_rtty("RYRYRY TEST 599", d,
                                         carrier_hz=-800.0,
                                         snr_db=20.0))], ("TEST", "599")


def sc_multi(d):
    xs = [jrtty.synthesize_rtty(m, d, carrier_hz=c) for m, c in
          (("HELLO ONE", -2000.0), ("WORLD TWO", 500.0),
           ("THREE THREE", 3000.0))]
    n = min(len(x) for x in xs)
    return {}, [pk(sum(x[:n] for x in xs).astype(np.complex64))], \
        ("HELLO", "WORLD", "THREE")


def sc_streaming(d):
    x = jrtty.synthesize_rtty("THE QUICK BROWN FOX", d, carrier_hz=1200.0)
    n4 = len(x) // 4
    return {}, [pk(x[i * n4:(i + 1) * n4]) for i in range(4)], \
        ("QUICK", "FOX")


def sc_appears(d):
    blk = 8 * d.bit_len * d.bits_per_char
    xa = jrtty.synthesize_rtty("CQ CQ CQ DE AAA AAA", d, carrier_hz=-1500.0)
    blocks = [pk(xa[i:i + blk]) for i in range(0, len(xa) - blk, blk)]
    xa2 = jrtty.synthesize_rtty("AAA AAA AAA AAA", d, carrier_hz=-1500.0)
    xb = jrtty.synthesize_rtty("DE BBB BBB BBB", d, carrier_hz=2000.0)
    n = min(len(xa2), len(xb))
    both = (xa2[:n] + xb[:n]).astype(np.complex64)
    blocks += [pk(both[i:i + blk]) for i in range(0, n - blk, blk)]
    return {"rescan_every": 1}, blocks, ("AAA", "BBB")


def sc_expires(d):
    blk = 8 * d.bit_len * d.bits_per_char
    x = jrtty.synthesize_rtty("RYRYRYRYRY", d, carrier_hz=1000.0)
    blocks = [pk(x[i:i + blk]) for i in range(0, len(x) - blk, blk)]
    rng = np.random.default_rng(0)
    blocks += [pk(0.001 * (rng.standard_normal(blk)
                           + 1j * rng.standard_normal(blk)))
               for _ in range(4)]
    return {"rescan_every": 1, "expire_after": 2}, blocks, ("RY",)


def sc_reappears(d):
    x = jrtty.synthesize_rtty("RYRY CQ DE AA2IL", d, carrier_hz=1000.0)
    blk = 8192
    quiet = (1e-4 * np.random.default_rng(0).standard_normal(
        (blk, 2))).astype(np.float32)
    blocks = [pk(x[i:i + blk]) for i in range(0, 4 * blk, blk)]
    blocks += [quiet] * 6
    blocks += [pk(x[i:i + blk]) for i in range(4 * blk, len(x) - blk, blk)]
    return {"rescan_every": 1, "expire_after": 1}, blocks, ("AA2IL",)


def sc_hundred(d):
    carriers = (np.arange(100) - 50) * 460.0 + 137.0
    x = composite(d, carriers)
    return {}, [pk(x)], tuple(f"ST{i:02d}" for i in range(100))


SCENARIOS = {"single": (12000.0, sc_single), "noisy": (12000.0, sc_noisy),
             "multi": (12000.0, sc_multi),
             "streaming": (12000.0, sc_streaming),
             "appears": (12000.0, sc_appears),
             "expires": (12000.0, sc_expires),
             "reappears": (48000.0, sc_reappears),
             "hundred": (48000.0, sc_hundred)}


def composite(d, carriers):
    """The 100-station layout of tests/test_rtty.py: station i at
    carriers[i] sending "RYRY STii STii", summed."""
    x = None
    for i, c in enumerate(carriers):
        xi = jrtty.synthesize_rtty(f"RYRY ST{i:02d} ST{i:02d}", d,
                                   carrier_hz=c)
        x = xi.copy() if x is None else x + xi[:len(x)]
    return x.astype(np.complex64)


def jax_pick(win):
    """pysdr_tpu's timing search: the argmax over the whole window."""
    o, sym = np.unravel_index(np.argmax(win), win.shape)
    return int(o), int(sym)


def record_calls(decoder):
    """Keep (scores, channel state before) of each _decode_channel call
    of `decoder`, in channel order; returns the list, emptied per block
    by the caller."""
    seen = []
    inner = decoder._decode_channel

    def recorded(scores, ch):
        seen.append((scores.copy(), copy.deepcopy(ch)))
        return inner(scores, ch)
    decoder._decode_channel = recorded
    return seen


def choices(design, scores, ch, pick=None):
    """The port's state machine on one channel's scores from a copy of
    state `ch`, with the timing rule `pick` (the port's own if None).
    Returns ([(window, offset, symbol) per search], text)."""
    dec = rtty.RTTYDecoder(design, device="cpu")
    pick = pick or dec._pick
    made = []

    def recorded(win):
        o, sym = pick(win)
        made.append((win, o, sym))
        return o, sym
    dec._pick = recorded
    return made, dec._decode_channel(scores, copy.deepcopy(ch))


def assert_parted_at_a_near_tie(design, jax_call, port_call, want, got):
    """A channel whose decode state parted between the decoders in this
    call: the port's state machine with each decoder's scores and timing
    rule gives back each decoder's text, and the first search where the
    two part chose between candidates (or against the gate) whose scores
    lie within twice the window's score difference between the decoders
    (plus the port's tie) in both decoders' scores: the FFTs' rounding
    alone decided it."""
    (j_sc, j_ch), (p_sc, p_ch) = jax_call, port_call
    assert {k: j_ch.get(k) for k in STATE} == {k: p_ch.get(k) for k in STATE}
    j_made, j_text = choices(design, j_sc, j_ch, jax_pick)
    p_made, p_text = choices(design, p_sc, p_ch)
    assert (j_text, p_text) == (want, got)
    gate = 0.5 * design.frames_per_char
    near = 2 * np.abs(j_sc - p_sc).max() + \
        design.frames_per_char * rtty.TIE_PER_FRAME
    for (jw, jo, js), (pw, po, ps) in zip(j_made, p_made):
        if (jo, js) != (po, ps):
            for w in (jw, pw):
                assert abs(w[jo, js] - w[po, ps]) <= near, \
                    (jo, js, po, ps, w[jo, js], w[po, ps], near)
            return
        if (jw[jo, js] > gate) != (pw[po, ps] > gate):
            assert max(abs(jw[jo, js] - gate),
                       abs(pw[po, ps] - gate)) <= near
            return
    raise AssertionError(f"the same choices gave {want!r} and {got!r}")


# the per-channel decode state the two decoders must agree on
STATE = ("pos", "locked", "misses", "figs", "text")
# the two decoders' matched scores for one channel and call: up to 4.6e-3
# apart where a channel's bins hold only noise ((m - s) / (m + s) of small
# magnitudes scales up the FFTs' rounding), ~1e-5 on a station
SCORE_DRIFT = 1e-2


def run_both(jdec, dec, blocks):
    """Feed each block to both decoders; assert the same channel list and,
    per call and channel, matched scores within SCORE_DRIFT and the same
    text and decode state. A channel may part from the JAX decoder only
    at a near-tie of the timing search (assert_parted_at_a_near_tie), and
    may differ from then on. Returns the JAX decoder's texts per call and
    the mark bins of the channels whose text parted."""
    j_seen, p_seen = record_calls(jdec), record_calls(dec)
    texts, parted, text_parted = [], set(), set()
    for k, b in enumerate(blocks):
        del j_seen[:], p_seen[:]
        want = jdec.decode_block(b)
        got = dec.decode_block(b)
        assert [c["mark_bin"] for c in dec.channels] == \
            [c["mark_bin"] for c in jdec.channels], k
        assert len(got) == len(want) and len(j_seen) == len(p_seen), k
        for i, (jc, pc) in enumerate(zip(jdec.channels, dec.channels)):
            if j_seen:
                assert np.abs(j_seen[i][0] - p_seen[i][0]).max() \
                    <= SCORE_DRIFT, (k, i)
            if got[i] != want[i]:
                text_parted.add(jc["mark_bin"])
            if jc["mark_bin"] in parted or all(
                    jc.get(s) == pc.get(s) for s in STATE):
                continue
            assert_parted_at_a_near_tie(dec.design, j_seen[i], p_seen[i],
                                        want[i], got[i])
            parted.add(jc["mark_bin"])
        texts.append(want)
    return texts, text_parted


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_decoder_matches_jax_call_by_call(name):
    """Every scenario of tests/test_rtty.py. In the 100-station 48 kHz
    block, a few channels' timing searches meet idle-to-"RYRY" scores a
    few float32 units apart, and the decoders decode a character apart
    there (ROADMAP Queue 3); in every other scenario each call's text
    agrees on every channel."""
    fs, scenario = SCENARIOS[name]
    jd = jrtty.RTTYDesign(fs=fs)
    kw, blocks, expect = scenario(jd)
    jdec = jrtty.RTTYDecoder(jd, **kw)
    dec = rtty.RTTYDecoder(rtty.RTTYDesign(fs=fs), device="cpu", **kw)
    texts, text_parted = run_both(jdec, dec, blocks)
    assert not text_parted or name == "hundred", text_parted
    # the pins of tests/test_rtty.py, on the port's own text
    text = "".join(c["text"] for c in dec.channels)
    if name == "expires":
        assert not dec.channels and "RY" in "".join(map("".join, texts))
    else:
        assert sum(p in text for p in expect) >= 0.9 * len(expect), text
    np.testing.assert_allclose(dec.last_spectrum, jdec.last_spectrum,
                               rtol=1e-4, atol=1e-6)


def station_of(design, mark_bin, carriers):
    """The station whose mark tone (carrier + shift/2) is nearest the
    channel's mark bin."""
    f = mark_bin * design.bin_hz
    if mark_bin >= design.nfft // 2:
        f -= design.fs
    return int(np.argmin(np.abs(carriers + design.shift_hz / 2 - f)))


def test_hundred_stations_at_96k_in_blocks_match_jax():
    """The full-width layout at fs = 96 kHz, decoded in 24576-sample
    blocks from 0.75 s (past the all-mark idle preamble): the port and
    JAX decoders give the same channels and text call by call, and >= 90
    of the 100 STii strings show up in their own channel's text."""
    fs = 96000.0
    jd = jrtty.RTTYDesign(fs=fs)
    carriers = (np.arange(100) - 50) * 460.0 + 137.0
    x = composite(jd, carriers)[int(0.75 * fs):]
    blocks = [x[i:i + 24576] for i in range(0, len(x) - 24576 + 1, 24576)]
    jdec = jrtty.RTTYDecoder(jd)
    dec = rtty.RTTYDecoder(rtty.RTTYDesign(fs=fs), device="cpu")
    assert run_both(jdec, dec, blocks)[1] == set()
    assert len(dec.channels) >= 90
    got = {station_of(dec.design, ch["mark_bin"], carriers)
           for ch in dec.channels if
           f"ST{station_of(dec.design, ch['mark_bin'], carriers):02d}"
           in ch["text"]}
    assert len(got) >= 90, (len(got), [c["text"] for c in dec.channels])


@pytest.mark.parametrize("name,split", [("streaming", 2), ("appears", 3),
                                        ("reappears", 3)])
def test_port_decoder_continues_a_jax_decoder(name, split):
    """A JAX decoder runs `split` blocks; a port decoder made from its
    state (convert.rtty_state_from_numpy) then emits, call by call, what
    the JAX decoder emits on the remaining blocks."""
    fs, scenario = SCENARIOS[name]
    jd = jrtty.RTTYDesign(fs=fs)
    kw, blocks, _ = scenario(jd)
    jdec = jrtty.RTTYDecoder(jd, **kw)
    for b in blocks[:split]:
        jdec.decode_block(b)
    assert jdec._soft_tail is not None and jdec._iq_tail is not None
    dec = convert.rtty_state_from_numpy(jdec, "cpu")
    assert dec._soft_tail.dtype == torch.float32
    assert dec._iq_tail.dtype == torch.complex64
    assert dec.channels == jdec.channels and \
        dec.channels is not jdec.channels
    assert run_both(jdec, dec, blocks[split:])[1] == set()


def test_rescan_remaps_the_soft_tail():
    """Survivors keep their soft-tail column, a new channel starts from
    zeros, an expired one is dropped (the JAX remap, as index_select)."""
    d = rtty.RTTYDesign(fs=12000.0)
    dec = rtty.RTTYDecoder(d, device="cpu", expire_after=1)
    sb = d.shift_bins
    dec.channels = [dec._new_channel(b) for b in (100, 200)]
    tail = torch.arange(6, dtype=torch.float32).reshape(3, 2)
    dec._soft_tail = tail.clone()
    avg = np.full(d.nfft, 1.0, np.float32)
    for b in (200, 300):                 # 100 goes quiet, 300 appears
        avg[b] = avg[b - sb] = 100.0
    added, removed = dec.rescan(avg)
    assert added == [300] and removed == [100]
    assert [c["mark_bin"] for c in dec.channels] == [200, 300]
    np.testing.assert_array_equal(
        dec._soft_tail.numpy(), np.stack([tail[:, 1].numpy(),
                                          np.zeros(3, np.float32)], 1))


def test_tied_offsets_take_the_earliest_whatever_the_rounding():
    """An idle all-mark stretch scores every frame offset alike. The JAX
    decoder's argmax follows a one-ulp difference between such scores;
    the port takes the earliest of the tied offsets, with or without the
    ulp."""
    d = rtty.RTTYDesign(fs=12000.0)
    fpc = d.frames_per_char
    scores = np.zeros((fpc + 1, 1, 32), np.float32)   # one search window
    scores[:, 0, rtty.LTRS_CODE] = 24.0
    bumped = scores.copy()
    bumped[9, 0, rtty.LTRS_CODE] = np.nextafter(np.float32(24.0),
                                                np.float32(25.0))
    jdec = jrtty.RTTYDecoder(jrtty.RTTYDesign(fs=12000.0))
    for sc, j_pos in ((scores, fpc), (bumped, 9 + fpc)):
        ch, jch = rtty.RTTYDecoder(d, device="cpu")._new_channel(1), \
            jdec._new_channel(1)
        jdec._decode_channel(sc[:, 0, :], jch)
        rtty.RTTYDecoder(d, device="cpu")._decode_channel(sc[:, 0, :], ch)
        assert jch["pos"] == j_pos
        assert ch["pos"] == fpc


# ---- the filterbank over static buffers, one set a frame count ----

def noise(n, seed, scale=0.01):
    rng = np.random.default_rng(seed)
    return (scale * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
            ).astype(np.complex64)


def frames_seen(dec):
    """Record the frame count of every filterbank run of `dec` (its
    static input's length); returns the list."""
    seen = []
    body = dec._body

    def recorded(inp, outs):
        seen.append(rtty.n_frames(inp.shape[0], dec.design))
        return body(inp, outs)
    dec._body = recorded
    return seen


# (fs, block): rtty_cq.dat's layout in the CLI (48 kHz baseband, --block
# 4096), the 100-station layout (96 kHz, 24576), an odd block and one
# shorter than a bit (12 kHz: bit_len 264, hop 66)
FRAME_LAYOUTS = {"fixture": (48000.0, 4096), "hundred": (96000.0, 24576),
                 "odd": (12000.0, 1001), "short": (12000.0, 100)}


@pytest.mark.parametrize("layout", [*FRAME_LAYOUTS, "from_jax"])
def test_prepared_frame_counts_equal_a_streams(layout):
    """The frame counts prepare() works out from the block length and the
    carried tail equal those 40 blocks of a stream run through the
    filterbank; the 100-station layout's are 43 (the first block, no
    tail), 46 and 47. from_jax: a port decoder carried across from a JAX
    decoder after two odd blocks prepares from the JAX tail."""
    fs, block = FRAME_LAYOUTS["odd" if layout == "from_jax" else layout]
    d = rtty.RTTYDesign(fs=fs)
    if layout == "from_jax":
        jdec = jrtty.RTTYDecoder(jrtty.RTTYDesign(fs=fs))
        for k in range(2):
            jdec.decode_block(noise(block, k))
        dec = convert.rtty_state_from_numpy(jdec, "cpu")
        assert rtty.frame_counts(d, 0, block) != \
            rtty.frame_counts(d, len(jdec._iq_tail), block)
    else:
        dec = rtty.RTTYDecoder(d, device="cpu")
    want = rtty.frame_counts(
        d, 0 if dec._iq_tail is None else dec._iq_tail.shape[0], block)
    assert dec.prepare(block) == want == dec.frame_counts
    if layout == "hundred":
        assert want == [43, 46, 47]
    seen = frames_seen(dec)
    for k in range(40):
        dec.decode_block(noise(block, 100 + k))
    assert sorted(set(seen)) == want
    assert dec.graph_count == 0


def sc_frame_counts(d):
    """One station in odd 1001-sample blocks: frames 12, 15 and 16."""
    x = jrtty.synthesize_rtty("CQ CQ DE AA2IL AA2IL", d, carrier_hz=1000.0)
    return {}, [pk(x[i:i + 1001]) for i in range(0, len(x) - 1001, 1001)], \
        ("AA2IL",)


def sc_short(d):
    """Blocks of 150 samples, fewer than a bit's 264, from the end of the
    idle preamble: the first completes no frame, the next 1, then 2 or 3
    a block, the soft bits accumulating to a character's worth."""
    x = jrtty.synthesize_rtty("DE AA2IL", d, carrier_hz=-700.0)[
        4 * d.bits_per_char * d.bit_len:]
    return {}, [pk(x[i:i + 150]) for i in range(0, len(x) - 150, 150)], \
        ("AA2IL",)


@pytest.mark.parametrize("scenario", [sc_frame_counts, sc_appears,
                                      sc_expires, sc_short])
def test_static_buffer_decoder_matches_jax_per_call(scenario):
    """decode_block over the static buffers against the JAX decoder, call
    by call: the text, the channels, last_spectrum (the tolerance of
    test_decoder_matches_jax_call_by_call), the baseband tail (bit-equal)
    and the soft-bit tail (within SCORE_DRIFT: a soft bit of a channel
    whose bins hold only the FFTs' rounding, as a phantom channel of a
    clean synth does, drifts as its scores do); across several frame
    counts, rescans that add a channel (sc_appears) and expire one
    (sc_expires), and blocks that complete no frame (sc_short).
    stage_ms times every block that ran the filterbank."""
    fs = 12000.0
    jd = jrtty.RTTYDesign(fs=fs)
    kw, blocks, expect = scenario(jd)
    jdec = jrtty.RTTYDecoder(jd, **kw)
    dec = rtty.RTTYDecoder(rtty.RTTYDesign(fs=fs), device="cpu", **kw)
    seen = frames_seen(dec)
    n_ch, text, no_frames = set(), "", 0
    for k, b in enumerate(blocks):
        ran = len(seen)
        want = jdec.decode_block(b)
        assert dec.decode_block(b) == want, k
        no_frames += len(seen) == ran
        text += "".join(want)
        assert [c["mark_bin"] for c in dec.channels] == \
            [c["mark_bin"] for c in jdec.channels], k
        n_ch.add(len(dec.channels))
        if getattr(jdec, "last_spectrum", None) is not None:
            np.testing.assert_allclose(dec.last_spectrum,
                                       jdec.last_spectrum, rtol=1e-4,
                                       atol=1e-6)
        np.testing.assert_array_equal(dec._iq_tail.numpy(), jdec._iq_tail)
        if jdec._soft_tail is None:
            assert dec._soft_tail is None, k
        else:
            assert dec._soft_tail.shape == jdec._soft_tail.shape, k
            np.testing.assert_allclose(dec._soft_tail.numpy(),
                                       jdec._soft_tail, rtol=0,
                                       atol=SCORE_DRIFT, err_msg=str(k))
    assert all(p in text for p in expect), text
    assert dec.frame_counts == sorted(set(seen))
    if scenario is sc_frame_counts:
        assert dec.frame_counts == [12, 15, 16]
    if scenario in (sc_appears, sc_expires):
        assert len(n_ch) >= 2, n_ch
    if scenario is sc_short:
        assert no_frames >= 1 and len(set(seen)) >= 2
    assert dec.stage_blocks == len(seen)
    assert set(dec.stage_ms) == set(rtty.STAGES)
    assert all(v >= 0.0 for v in dec.stage_ms.values())


def test_unprepared_frame_count_raises():
    """A block whose frame count the decoder was not prepared for raises
    before it changes anything: no filterbank run, the same tails, block
    count and spectrum."""
    d = rtty.RTTYDesign(fs=12000.0)
    dec = rtty.RTTYDecoder(d, device="cpu")
    assert dec.prepare(1001) == [12, 15, 16]
    dec.decode_block(noise(1001, 1))
    seen = frames_seen(dec)
    tail, spec, n = dec._iq_tail.clone(), dec.last_spectrum, dec._n_blocks
    with pytest.raises(ValueError, match="prepared for"):
        dec.decode_block(noise(500, 2))
    assert seen == [] and dec._n_blocks == n and dec.last_spectrum is spec
    assert torch.equal(dec._iq_tail, tail)
    dec.decode_block(noise(1001, 3))
    assert len(seen) == 1
