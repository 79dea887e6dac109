"""The torch port's CLI and executive on the CPU: the replay corpus
reproduces its pinned outcome, the channelizer CLI writes its wavs and
PNGs, the web viewer drives a channelizer bank, unported flags and a
missing card fail loudly, a bounded run drops no block, and no module
imports jax."""

import json
import os
import struct
import urllib.request
import subprocess
import sys
import textwrap
import wave

import numpy as np
import pytest
import torch

from pysdr_tpu.config import PipelineConfig, ReceiverConfig
from pysdr_tpu.tables import Mode
from pysdr_tpu_torch import app
from pysdr_tpu_torch.models.receiver import ReceiverBank
from pysdr_tpu_torch.runtime.executive import Executive

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIX = os.path.join(ROOT, "tests", "fixtures")


def run_cli(*argv, timeout=240):
    env = dict(os.environ, OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, *argv], capture_output=True,
                         text=True, timeout=timeout, cwd=ROOT, env=env)
    # the whole of both streams, so a failure under load can be triaged
    report = f"rc={out.returncode}\n--- stdout\n{out.stdout}\n" \
             f"--- stderr\n{out.stderr}"
    return out, report


def peak_hz(path):
    w = wave.open(path)
    d = np.frombuffer(w.readframes(w.getnframes()), np.int16).reshape(
        -1, w.getnchannels())[:, 0].astype(np.float32)
    seg = d[len(d) // 3:]
    sp = np.abs(np.fft.rfft(seg * np.hanning(len(seg))))
    frq = np.fft.rfftfreq(len(seg), 1.0 / w.getframerate())
    floor = np.median(sp[5:]) + 1e-9
    return frq[5 + np.argmax(sp[5:])], 20 * np.log10(sp[5:].max() / floor)


def test_cli_replay_corpus_am_tones(tmp_path):
    prefix = str(tmp_path / "am")
    out, report = run_cli(
        "-m", "pysdr_tpu_torch", "--device", "cpu",
        "--replay", os.path.join(FIX, "am_tones.dat"), "--no-loop",
        "--fc", "100.0", "100.04", "--mode", "AM", "--video-bw", "8",
        "--block", "4096", "--wav", prefix)
    assert out.returncode == 0, report
    assert "Msamp/s), 2 RX" in out.stdout, report
    (pk0, snr0), (pk1, snr1) = peak_hz(prefix + "_rx0.wav"), \
        peak_hz(prefix + "_rx1.wav")
    assert abs(pk0 - 400.0) < 10.0 and abs(pk1 - 800.0) < 10.0, (pk0, pk1)
    assert snr0 > 40.0 and snr1 > 40.0, (snr0, snr1)


def test_cli_without_a_card_fails_loudly():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out, report = run_cli("-m", "pysdr_tpu_torch", "--fs", "0.512",
                          "--block", "1024", "--blocks", "1")
    assert out.returncode != 0, report
    assert "cuda" in out.stderr and "--device cpu" in out.stderr, report


def test_cli_channelizer_writes_wavs_and_pngs(tmp_path):
    """--channelize 8 at 96 kHz channels (2:1 to 48 kHz): one wav per
    channel, the synth's station on channel 4 (300 + 50*4 Hz) in channel
    4's wav, RF and AF waterfalls exported as PNG."""
    prefix, png = str(tmp_path / "ch"), tmp_path / "png"
    out, report = run_cli(
        "-m", "pysdr_tpu_torch", "--device", "cpu", "--channelize", "8",
        "--fs", "0.768", "--fc", "100.0", "--block", "4096", "--blocks",
        "3", "--wav", prefix, "--psd", "--png-dir", str(png))
    assert out.returncode == 0, report
    assert "Msamp/s), 8 RX" in out.stdout, report
    wavs = sorted(p.name for p in tmp_path.glob("ch_rx*.wav"))
    assert wavs == [f"ch_rx{i}.wav" for i in range(8)], report
    for ch, hz in ((0, 300.0), (4, 500.0)):
        pk, snr = peak_hz(f"{prefix}_rx{ch}.wav")
        assert abs(pk - hz) < 10.0 and snr > 40.0, (ch, pk, snr)
    names = sorted(p.name for p in png.iterdir())
    assert names == sorted(["RF.png", *(f"AF{i}.png" for i in range(8))])
    for name in names:
        data = (png / name).read_bytes()
        assert data[:8] == b"\x89PNG\r\n\x1a\n", name
        w, h = struct.unpack(">II", data[16:24])
        assert w > 64 and h >= 1, (name, w, h)


def test_cli_channelizer_replays_the_corpus(tmp_path):
    """--channelize 8 over am_tones.dat (256 kHz, center 99.94 MHz): the
    stations at +60 and +100 kHz sit 4 kHz off channels 2 (+64 kHz) and
    3 (+96 kHz), and an AM envelope ignores the offset."""
    prefix = str(tmp_path / "rp")
    out, report = run_cli(
        "-m", "pysdr_tpu_torch", "--device", "cpu", "--channelize", "8",
        "--fs", "0.256", "--replay", os.path.join(FIX, "am_tones.dat"),
        "--no-loop", "--block", "3072", "--wav", prefix)
    assert out.returncode == 0, report
    for ch, hz in ((2, 400.0), (3, 800.0)):
        pk, snr = peak_hz(f"{prefix}_rx{ch}.wav")
        assert abs(pk - hz) < 10.0 and snr > 40.0, (ch, pk, snr, report)


def test_cli_channelize_ignores_bb_like_the_reference(tmp_path, capsys):
    rc, a = app.run_cli(["--device", "cpu", "--channelize", "4", "--fs",
                         "0.192", "--block", "1024", "--blocks", "1",
                         "--bb", "--psd"])
    assert rc == 0 and a.display is not None and a.display.bb == []
    assert "--bb is not available with --channelize" in \
        capsys.readouterr().err


def test_cli_bb_feeds_the_baseband_panes():
    """--bb on the receiver path: the bank emits its baseband, the
    executive carries it with each block, the BB panes show it."""
    rc, a = app.run_cli(["--device", "cpu", "--fs", "0.512", "--block",
                         "1024", "--blocks", "2", "--bb", "--psd-every",
                         "1"])
    assert rc == 0 and a.bank.emit_baseband and a.ex.want_bb
    assert {"RF", "AF0", "BB0"} <= set(a.display.frames)
    assert a.display.frames["BB0"].waterfall_u8.shape[1] == 1024


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=10) as r:
        return r.read()


def test_webview_channelizer_tune_and_frame():
    """The reused web viewer against the port's ChannelizerBank: tuning
    maps the clicked RF frequency to (nearest channel, fine offset); the
    frame carries one row per channel."""
    args = app.build_parser().parse_args(
        ["--device", "cpu", "--channelize", "8", "--fs", "0.768", "--fc",
         "100.0", "--block", "4096", "--web", "0", "--psd-every", "1"])
    a = app.App(args)
    a.start_services()
    try:
        p = a.web.port
        a.ex.run(n_blocks=2)
        fr = json.loads(_get(p, "/frame.json"))
        assert fr["ok"] and fr["n_rx"] == 8 and len(fr["rx"]) == 8
        assert fr["rx"][1]["fc"] == 100e6 + 96e3
        assert "af" in fr and fr["rf"]["rows"] > 0
        # channel centers are fc + fftfreq: channel 1 sits at +96 kHz
        target = 100e6 + 96e3 + 5e3
        _get(p, f"/tune?f={target:.0f}")
        _get(p, "/mode?m=NFM&rx=3")
        a.ex._apply_pending()
        ch = a.bank.channel_of(target)
        assert ch == 1
        assert abs(a.bank._ch_cfgs[ch].fine_offset_hz - 5e3) < 1.0
        assert a.bank._ch_cfgs[3].mode.name == "NFM"
        a.ex.run(n_blocks=1)
        fr = json.loads(_get(p, "/frame.json"))
        assert abs(fr["rx"][1]["fc"] - target) < 1.0
    finally:
        a.stop_services()


@pytest.mark.parametrize("flag", [
    ["--save-iq"], ["--mesh", "1,8"], ["--rtty", "0"], ["--rtl-tcp", "h:1"],
    ["--fifo", "f"], ["--preset", "x"], ["--aux-wav", "f"], ["--hamlib"],
    ["--rig", "h:1"], ["--udp-port", "1"], ["--hop", "1.0"],
    ["--hop-schedule", "f"]])
def test_unported_flag_exits_2(flag, capsys):
    assert app.main(["--device", "cpu", *flag]) == 2
    err = capsys.readouterr().err
    assert f"error: {flag[0]} is not yet ported to pysdr_tpu_torch" in err


class ListSource:
    """Deterministic source: consecutive slices of one array."""

    def __init__(self, x):
        self.x, self.pos = x, 0

    def read_data(self, n, loop=False):
        out = self.x[self.pos:self.pos + n]
        self.pos += n
        return out


@pytest.mark.parametrize("prefetch", [True, False])
def test_bounded_runs_drop_no_block(prefetch):
    cfg = PipelineConfig(fs_in=512e3, fs_out=48e3, out_block=1024,
                         foffset_hz=60e3,
                         receivers=(ReceiverConfig(fc_hz=10e6,
                                                   mode=Mode.AM),))
    rng = np.random.default_rng(11)
    bank = ReceiverBank(cfg, device="cpu")
    n = bank.design.in_block
    x = (rng.standard_normal(5 * n) + 1j * rng.standard_normal(5 * n)) \
        .astype(np.complex64)
    audio = []
    for runs in ((5,), (2, 3, 5)):
        ex = Executive(ReceiverBank(cfg, device="cpu"), ListSource(x),
                       loop_source=False, prefetch=prefetch)
        for total in runs:
            ex.run(n_blocks=total)
        ex.stop()
        assert ex.n_blocks == 5
        audio.append(ex.audio_rings[0].pull(5 * bank.design.out_block))
    np.testing.assert_array_equal(audio[0], audio[1])


def test_every_module_imports_without_jax():
    pkg = os.path.join(ROOT, "pysdr_tpu_torch")
    mods = sorted(
        "pysdr_tpu_torch." + os.path.relpath(os.path.join(d, f), pkg)
        [:-3].replace(os.sep, ".").replace(".__init__", "")
        for d, _, fs in os.walk(pkg) for f in fs if f.endswith(".py"))
    script = textwrap.dedent(f"""
        import importlib, sys
        class NoJax:
            def find_spec(self, name, path=None, target=None):
                if name == "jax" or name.startswith(("jax.", "jaxlib")):
                    raise ImportError("jax import refused: " + name)
        sys.meta_path.insert(0, NoJax())
        for m in {mods!r} + ["pysdr_tpu.runtime.webview"]:
            importlib.import_module(m.removesuffix(".__main__"))
        assert not any(k == "jax" or k.startswith("jax.")
                       for k in sys.modules)
        print("imported", len({mods!r}))
        """)
    out, report = run_cli("-c", script)
    assert out.returncode == 0 and "imported" in out.stdout, report
