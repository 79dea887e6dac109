"""The port's own copies of the JAX package's host modules against their
originals: tables, rate plans, FIR designs, the synth source, the CLI
parser and build_config (the port keeps copies so that it imports
nothing of pysdr_tpu)."""

import argparse
import dataclasses

import numpy as np
import pytest

from pysdr_tpu import app as japp
from pysdr_tpu import rates as jrates
from pysdr_tpu import tables as jtables
from pysdr_tpu.io import synth as jsynth
from pysdr_tpu.ops import fir as jfir
from pysdr_tpu.runtime import hopper as jhopper
from pysdr_tpu.runtime import presets as jpresets
from pysdr_tpu_torch import app, rates, tables
from pysdr_tpu_torch.io import synth
from pysdr_tpu_torch.ops import fir
from pysdr_tpu_torch.runtime import hopper, presets

FS_IN = sorted({*(f * 1e6 for f in tables.RTL_SRATES + tables.SDRPLAY_SRATES),
                0.192e6, 0.768e6, 12.288e6})
FS_OUT = (24e3, 48e3, 96e3, 192e3)


def test_tables_equal():
    for name in ("MODE_NAMES", "AF_BWS_HZ", "VIDEO_BWS_HZ", "PAN_BWS_HZ",
                 "RTL_SRATES", "SDRPLAY_SRATES", "MODE_DEFAULT_AF_BW",
                 "CW_BFO_HZ", "WFM_DEVIATION_HZ", "WFM_PILOT_HZ",
                 "WFM_DEEMPHASIS_S", "NFM_DEVIATION_HZ", "MAX_RX",
                 "STATIONS"):
        assert getattr(tables, name) == getattr(jtables, name), name
    assert [(m.name, int(m)) for m in tables.Mode] == \
        [(m.name, int(m)) for m in jtables.Mode]
    names = [*jtables.Mode.__members__, "am-synch", "AM Synch", "FM",
             "SSB", "RTTY2", "PKTUSB", "wfm2"]
    for n in names:
        assert int(tables.mode_from_name(n)) == int(jtables.mode_from_name(n))
    with pytest.raises(ValueError, match="unknown mode"):
        tables.mode_from_name("nope")
    for bw in np.linspace(0.0, 1.2e6, 97):
        for menu in ("AF_BWS_HZ", "VIDEO_BWS_HZ", "PAN_BWS_HZ"):
            lst = getattr(tables, menu)
            assert tables.find_filter(bw, lst) == jtables.find_filter(bw, lst)
            assert tables.find_filter_index(bw, lst) == \
                jtables.find_filter_index(bw, lst)


@pytest.mark.parametrize("fs_out", FS_OUT)
def test_rate_plans_equal(fs_out):
    for fs_in in FS_IN:
        assert rates.up_dn(fs_in, fs_out) == jrates.up_dn(fs_in, fs_out)
        for out_block in (1000, 1024, 3072, 16384, 24576):
            t = rates.rate_plan(fs_in, fs_out, out_block)
            j = jrates.rate_plan(fs_in, fs_out, out_block)
            assert dataclasses.asdict(t) == dataclasses.asdict(j), \
                (fs_in, out_block)
    assert rates.sweep_table() == jrates.sweep_table()


def test_fir_designs_bit_equal():
    eq = np.testing.assert_array_equal
    for atten in (20.0, 40.0, 60.0, 80.0):
        assert fir.kaiser_beta(atten) == jfir.kaiser_beta(atten)
    for ntaps, cut, fs in ((63, 5e3, 48e3), (256, 2.5e3, 48e3),
                           (129, 90e3, 2.048e6)):
        eq(fir.lowpass(ntaps, cut, fs), jfir.lowpass(ntaps, cut, fs))
        eq(fir.bandpass(300.0, cut, fs, ntaps),
           jfir.bandpass(300.0, cut, fs, ntaps))
        eq(fir.complex_bandpass(-cut, cut / 2, fs, ntaps),
           jfir.complex_bandpass(-cut, cut / 2, fs, ntaps))
    for fs_in, fs_out in ((512e3, 48e3), (8e6, 48e3), (12.288e6, 192e3),
                          (2.048e6, 192e3)):
        up, down = rates.up_dn(fs_in, fs_out)
        eq(fir.video_filter_bank(fs_in, up, down, tables.VIDEO_BWS_HZ),
           jfir.video_filter_bank(fs_in, up, down, jtables.VIDEO_BWS_HZ))
    for fs_out in FS_OUT:
        eq(fir.af_filter_bank_real(fs_out, tables.AF_BWS_HZ),
           jfir.af_filter_bank_real(fs_out, jtables.AF_BWS_HZ))
        # one-sided rows pass [150 Hz, bw]: the menu's 50 and 100 Hz
        # entries have no such band in either package
        bws = [bw for bw in tables.AF_BWS_HZ if bw == 0.0 or bw > 150.0]
        for lsb in (False, True):
            eq(fir.af_filter_bank_cmpx(fs_out, bws, ntaps=128, lsb=lsb),
               jfir.af_filter_bank_cmpx(fs_out, bws, ntaps=128, lsb=lsb))
    h = fir.lowpass(101, 4e3, 48e3)
    for a, b in zip(fir.freq_response(h, 48e3), jfir.freq_response(h, 48e3)):
        eq(a, b)


def test_synth_blocks_bit_equal():
    kinds = ("am", "fm", "usb", "lsb", "cw", "tone", "noise")
    mk = [[mod.SignalSpec(offset_hz=-60e3 + 20e3 * i, mode=k,
                          amplitude=0.1 + 0.1 * i, audio_hz=300.0 + 100 * i)
           for i, k in enumerate(kinds)] for mod in (synth, jsynth)]
    np.testing.assert_array_equal(
        synth.render(mk[0], 256e3, 5000, noise_rms=0.01, seed=3, t0=0.25),
        jsynth.render(mk[1], 256e3, 5000, noise_rms=0.01, seed=3, t0=0.25))
    src = synth.SynthSource(mk[0], 256e3, noise_rms=0.02, seed=9, fc=1e8,
                            rf_gain_db=6.0, ppm=1.5)
    jsrc = jsynth.SynthSource(mk[1], 256e3, noise_rms=0.02, seed=9, fc=1e8,
                              rf_gain_db=6.0, ppm=1.5)
    for blk in range(4):
        if blk == 2:
            src.set_freq(1e8 + 10e3)
            jsrc.set_freq(1e8 + 10e3)
        np.testing.assert_array_equal(src.read_data(4096),
                                      jsrc.read_data(4096))


# options whose help names the package's own tools: the port's trace is
# torch.profiler's and its latency analyzer pysdr_tpu_torch.latency
OWN_HELP = {"--jax-trace": ("torch.profiler", "DIR/trace_<pid>.json",
                            "pysdr.<stage>#<block>"),
            "--watchdog-log": ("python -m pysdr_tpu_torch.latency PATH",)}


def _actions(parser):
    """Every option but --device: its strings and how it parses, and its
    help unless it names the package's own tools."""
    return [(a.option_strings, a.dest, a.default, a.nargs, a.const,
             a.type, a.choices, a.metavar,
             None if set(a.option_strings) & set(OWN_HELP) else a.help,
             type(a))
            for a in parser._actions if "--device" not in a.option_strings]


def test_parsers_equal_apart_from_device():
    tp, jp = app.build_parser(), japp.build_parser()
    assert _actions(tp) == _actions(jp)
    for a in tp._actions:
        for flag in set(a.option_strings) & set(OWN_HELP):
            assert all(w in a.help for w in OWN_HELP[flag]), flag
            assert "jax" not in a.help.replace("--jax-trace", ""), flag
            assert "pysdr_tpu." not in a.help, flag
    dev = [a for a in tp._actions if a.option_strings == ["--device"]]
    assert len(dev) == 1 and dev[0].default == "cuda"
    assert dev[0].choices == ["cuda", "cpu"]
    assert isinstance(tp, argparse.ArgumentParser)


ARGV = {
    "bank4": ["--fs", "8", "--block", "24576", "--fc", "100.0", "100.5",
              "101.0", "101.5", "--modes", "AM", "NFM", "USB", "CW",
              "--wire", "i8", "--audio-wire", "i16", "--squelch", "-20",
              "--mute", "2", "--bfo", "600", "--nfilt", "128"],
    "chan64": ["--channelize", "64", "--fs", "12.288", "--fc", "100.0",
               "--block", "12288", "--wire", "i8", "--audio-wire", "i8",
               "--squelch", "10"],
    "digi": ["--fc", "7.074", "7.080", "--ft8", "--ft4", "--ft44",
             "--mode", "USB", "--fs", "2.048", "--src", "-1", "0"],
    "digi_bands": ["--ft8", "40m", "20m", "--ft4", "30m", "--fs", "24"],
    "wfm": ["--fc", "100.1", "--mode", "WFM", "--auto-mute", "--af-bw",
            "15", "--video-bw", "150", "--no-agc", "--transverter", "125",
            "--foffset", "50"],
}


@pytest.mark.parametrize("name", sorted(ARGV))
def test_build_config_equal(name):
    argv = ARGV[name]
    t = app.build_config(app.build_parser().parse_args(argv))
    j = japp.build_config(japp.build_parser().parse_args(argv))
    assert type(t).__module__ == "pysdr_tpu_torch.config"
    for f in dataclasses.fields(j):
        tv, jv = getattr(t, f.name), getattr(j, f.name)
        if f.name == "receivers":
            assert len(tv) == len(jv)
            for tr, jr in zip(tv, jv):
                assert type(tr.mode) is tables.Mode
                assert dataclasses.asdict(tr) == dataclasses.asdict(jr)
        else:
            assert tv == jv, f.name
    assert dataclasses.asdict(t.plan) == dataclasses.asdict(j.plan)
    assert t.sdr_center_hz == j.sdr_center_hz
    assert t.channel_offsets_hz() == j.channel_offsets_hz()
    assert app._fs_out_hz(app.build_parser().parse_args(argv),
                          [r.mode for r in t.receivers]) == j.fs_out


def test_hopper_bands_and_presets_equal():
    assert hopper.BANDS_KHZ == jhopper.BANDS_KHZ
    for f in np.linspace(1e5, 6e8, 601):
        assert hopper.freq2band(f) == jhopper.freq2band(f)
    got, jgot = presets.load(None), jpresets.load(None)
    assert [dataclasses.astuple(p) for p in got[0]] == \
        [dataclasses.astuple(p) for p in jgot[0]]
    assert got[1] == jgot[1]


def test_wav_copy_equal(tmp_path):
    """io/wav.py: the port's write_wav writes the JAX package's bytes
    (mono, stereo from complex, (n, 2), a peak over 1.0 rescaled, an
    empty block) and read_wav reads them back alike
    (tests/test_io.py:35-36)."""
    from pysdr_tpu.io import wav as jwav
    from pysdr_tpu_torch.io import wav
    rng = np.random.default_rng(4)
    cases = [rng.uniform(-0.9, 0.9, 4800).astype(np.float32),
             (rng.standard_normal(4800)
              + 1j * rng.standard_normal(4800)).astype(np.complex64) * 0.3,
             rng.uniform(-2.0, 2.0, (4800, 2)).astype(np.float32),
             np.zeros(0, np.complex64)]
    for i, a in enumerate(cases):
        p, jp = str(tmp_path / f"t{i}.wav"), str(tmp_path / f"j{i}.wav")
        wav.write_wav(p, a, 48e3)
        jwav.write_wav(jp, a, 48e3)
        assert open(p, "rb").read() == open(jp, "rb").read(), i
        (x, fs), (jx, jfs) = wav.read_wav(p), jwav.read_wav(jp)
        np.testing.assert_array_equal(x, jx)
        assert fs == jfs == 48e3
    wav.write_wav(str(tmp_path / "m.wav"), cases[1], 48e3,
                  stereo_from_complex=False)
    assert wav.read_wav(str(tmp_path / "m.wav"))[0].shape == (4800, 1)


def test_latency_copy_equal(tmp_path, capsys):
    """latency.py: percentile, analyze and main of the port equal the JAX
    package's on a watchdog CSV with samples and both self-heal events
    (the main's usage line names its own package)."""
    from pysdr_tpu import latency as jlatency
    from pysdr_tpu_torch import latency
    log = tmp_path / "LOG2.TXT"
    log.write_text("audio0,1.0,2000,0.0417,0.0417\n"
                   "audio0,3.0,2600,0.0542,0.0450\n"
                   "#LOW,audio0,5.0,300\n"
                   "audio1,3.5,100,0.0021,0.0021\n"
                   "#HIGH,audio2,6.0,900\n\n")
    for q in (0.0, 0.5, 0.95, 1.0):
        vals = sorted(np.random.default_rng(1).uniform(0, 1, 7))
        assert latency.percentile(vals, q) == jlatency.percentile(vals, q)
    assert latency.percentile([], 0.5) == jlatency.percentile([], 0.5)
    assert latency.analyze(str(log)) == jlatency.analyze(str(log))
    outs = []
    for mod in (latency, jlatency):
        rc = mod.main([str(log), str(tmp_path / "missing.csv")])
        outs.append((rc, capsys.readouterr()))
    assert outs[0][0] == outs[1][0] == 1
    assert outs[0][1].out == outs[1][1].out
    assert latency.main([]) == 2
    assert "python -m pysdr_tpu_torch.latency" in capsys.readouterr().err
