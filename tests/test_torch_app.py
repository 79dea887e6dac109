"""The torch port's CLI and executive on the CPU: the replay corpora
reproduce their pinned outcomes (AM tones, the RTTY capture), the
channelizer CLI writes its wavs and PNGs, the web viewer drives a
channelizer bank and serves the RTTY panel, the recording taps, fifo,
aux path, presets, --internals, control servers, rig follow, hop
schedule and rtl_tcp work as in pysdr_tpu.app, the unported flags and a
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


@pytest.mark.parametrize("flag", [["--mesh", "1,8"], ["--jax-trace", "d"]])
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


# ---- the RTTY decoder in the app ----

def rtty_capture(path, fs_rf=512e3):
    """The JAX test_app_rtty_full_chain capture: a station 1 kHz above an
    RX at 100.0 MHz, 120 kHz above the file's center."""
    from pysdr_tpu.io import datfile
    from pysdr_tpu_torch.models import rtty
    x = rtty.synthesize_rtty("RYRY CQ CQ DE AA2IL AA2IL",
                             rtty.RTTYDesign(fs=fs_rf),
                             carrier_hz=120e3 + 1000.0)
    w = datfile.DatWriter(path, fs=fs_rf, fc=100e6 - 120e3)
    w.save_data(x)
    w.close()
    return path


RTTY_ARGV = ["--no-loop", "--fc", "100.0", "--mode", "RTTY", "--block",
             "4096", "--rtty", "0"]


def test_app_rtty_full_chain(tmp_path):
    """--rtty through the whole chain: RF capture -> replay -> NCO and
    decimate (IQ passthrough) -> the baseband as a device tensor -> the
    port's decoder; the RX's bank emits its baseband, the executive
    carries it."""
    path = rtty_capture(str(tmp_path / "rtty_capture.dat"))
    rc, a = app.run_cli(["--device", "cpu", "--replay", path, *RTTY_ARGV])
    assert rc == 0 and a.bank.emit_baseband and a.ex.want_bb
    text = "".join(a.rtty_text)
    assert "AA2IL" in text, (text, a.rtty_text)


def test_cli_rtty_corpus_matches_the_jax_app():
    """The rtty_cq.dat corpus (examples/rtty_decode.sh): the CLI prints
    the pinned text, and the decoder's channels and text equal the JAX
    app's on the same capture."""
    from pysdr_tpu import app as japp
    argv = ["--replay", os.path.join(FIX, "rtty_cq.dat"), *RTTY_ARGV]
    out, report = run_cli("-m", "pysdr_tpu_torch", "--device", "cpu", *argv)
    assert out.returncode == 0, report
    printed = "".join(line.split(": ", 1)[1] for line in
                      out.stdout.splitlines() if line.startswith("RTTY ch"))
    assert "CQ" in printed and "AA2IL" in printed, report
    rc, a = app.run_cli(["--device", "cpu", *argv])
    ja = japp.App(japp.build_parser().parse_args(argv))
    ja.run()
    assert [(c["mark_bin"], c["text"]) for c in a.rtty.channels] == \
        [(c["mark_bin"], c["text"]) for c in ja.rtty.channels]
    assert list(a.rtty_text) == list(ja.rtty_text)


def test_webview_rtty_panel():
    """/rtty.json through the reused viewer: the decoder-band waterfall
    and the per-channel text (the JAX test_webview_rtty_panel check)."""
    args = app.build_parser().parse_args(
        ["--device", "cpu", "--fs", "0.512", "--block", "4096", "--web",
         "0", "--psd-every", "1", "--rtty", "0", "--mode", "RTTY"])
    a = app.App(args)
    a.start_services()
    try:
        fr = json.loads(_get(a.web.port, "/frame.json"))
        assert fr["ok"] is False or fr["rtty"] is True
        a.ex.run(n_blocks=6)
        t0 = json.loads(_get(a.web.port, "/rtty.json"))
        assert "wf_b64" in t0 and t0["rows"] >= 1 and t0["cols"] > 64
        a.rtty.channels = [
            {"mark_bin": 40, "figs": False, "text": "CQ CQ DE W1AW",
             "snr_db": 12.0, "idle_scans": 0}]
        a.rtty_text.append("CQ CQ DE W1AW")
        t = json.loads(_get(a.web.port, "/rtty.json"))
        assert t["channels"][0]["text"].endswith("W1AW")
        assert t["channels"][0]["locked"]
        assert t["channels"][0]["freq_hz"] > 0
        assert t["lines"][-1] == "CQ CQ DE W1AW"
    finally:
        a.stop_services()


@pytest.mark.parametrize("flag", [["--rtty", "0"], ["--hamlib"],
                                  ["--rig", "h:1"], ["--hop", "100.1"],
                                  ["--hop-schedule", "f"],
                                  ["--save-baseband"]])
def test_cli_channelize_ignores_like_the_reference(flag, capsys):
    rc, a = app.run_cli(["--device", "cpu", "--channelize", "4", "--fs",
                         "0.192", "--block", "1024", "--blocks", "1", *flag])
    assert rc == 0 and a.rtty is None and a.hopper is None
    assert not a.hamlib_servers and a.rig is None and a.bb_writer is None
    assert f"{flag[0]} is not available with --channelize; ignoring" in \
        capsys.readouterr().err


# ---- recording taps, fifo, aux ----

def test_recording_taps_parse(tmp_path):
    """--save-iq, --save-baseband and --save-demod: each .dat parses and
    holds the run's blocks at its rate; the demod tap equals the wav's
    audio and the baseband tap carries the AM station (a 400 Hz
    envelope)."""
    from pysdr_tpu.io import datfile
    prefix = str(tmp_path / "w")
    rc, a = app.run_cli(["--device", "cpu", "--fs", "0.512", "--block",
                         "4096", "--blocks", "3", "--save-iq",
                         "--save-baseband", "--save-demod", "--save-dir",
                         str(tmp_path), "--wav", prefix])
    assert rc == 0
    d = a.bank.design
    got = {}
    for tag, fs, n in (("raw_iq", d.fs_in, d.in_block),
                       ("baseband", d.fs_out, d.out_block),
                       ("demod", d.fs_out, d.out_block)):
        names = [f for f in os.listdir(tmp_path) if f.startswith(tag)]
        assert len(names) == 1, (tag, names)
        x, hdr = datfile.read_dat(str(tmp_path / names[0]))
        assert hdr.fs == fs and len(x) == 3 * n, (tag, hdr, x.shape)
        got[tag] = x
    assert datfile.read_dat(str(tmp_path / [
        f for f in os.listdir(tmp_path) if f.startswith("baseband")][0]
    ))[1].tag == "baseband"
    with wave.open(prefix + "_rx0.wav") as w:
        pcm = np.frombuffer(w.readframes(w.getnframes()), np.int16) \
            .reshape(-1, w.getnchannels())[:, 0]
    demod = np.asarray(got["demod"]).reshape(-1)
    # the player writes whole chunks: the wav ends at the last full one
    n = len(pcm)
    assert 0 < len(demod) - n < d.out_block, (len(demod), n)
    ref = np.clip(np.round(demod[:n].real * 32767), -32768, 32767)
    assert np.abs(pcm.astype(np.int64) - ref).max() <= 1
    env = np.abs(np.asarray(got["baseband"]).reshape(-1)[4096:])
    sp = np.abs(np.fft.rfft((env - env.mean()) * np.hanning(len(env))))
    assert abs(np.fft.rfftfreq(len(env), 1 / d.fs_out)[
        5 + np.argmax(sp[5:])] - 400.0) < 10.0


def test_save_iq_replays(tmp_path):
    """A --save-iq recording replays through the port's CLI to the same
    station (the reference's record/replay oracle)."""
    rc, _ = app.run_cli(["--device", "cpu", "--fs", "0.512", "--block",
                         "4096", "--blocks", "6", "--save-iq",
                         "--save-dir", str(tmp_path)])
    assert rc == 0
    dats = [f for f in os.listdir(tmp_path) if f.endswith(".dat")]
    assert len(dats) == 1
    prefix = str(tmp_path / "replayed")
    out, report = run_cli(
        "-m", "pysdr_tpu_torch", "--device", "cpu", "--replay",
        str(tmp_path / dats[0]), "--no-loop", "--block", "4096", "--wav",
        prefix)
    assert out.returncode == 0, report
    pk, snr = peak_hz(prefix + "_rx0.wav")
    assert abs(pk - 400.0) < 10.0 and snr > 40.0, (pk, snr, report)


def test_aux_wav_bandpass(tmp_path):
    """--aux-wav: RX0 audio through the 800-1300 Hz bandpass; the synth's
    400 Hz tone sits in its stopband."""
    prefix, aux = str(tmp_path / "m"), str(tmp_path / "aux.wav")
    rc, a = app.run_cli(["--device", "cpu", "--fs", "0.512", "--block",
                         "4096", "--blocks", "8", "--wav", prefix,
                         "--aux-wav", aux])
    assert rc == 0

    def pcm(path):
        with wave.open(path) as w:
            return np.frombuffer(w.readframes(w.getnframes()), np.int16) \
                .reshape(-1, w.getnchannels()).astype(np.float32)
    m, x = pcm(prefix + "_rx0.wav")[:, 0], pcm(aux)
    # mono, one sample per audio sample of every block
    assert x.shape == (8 * a.bank.design.out_block, 1)
    x = x[:, 0]
    rms = lambda v: np.sqrt(np.mean(v[len(v) // 2:] ** 2))  # noqa: E731
    assert rms(x) < 0.15 * rms(m)


def test_fifo_loopback_audio(tmp_path):
    """--fifo tees RX0's audio into a named pipe as s16le PCM."""
    import threading
    fifo = str(tmp_path / "audio.fifo")
    chunks = []

    def reader():
        with open(fifo, "rb") as f:
            while b := f.read(4096):
                chunks.append(b)
    args = app.build_parser().parse_args(
        ["--device", "cpu", "--fs", "0.512", "--block", "4096", "--blocks",
         "8", "--fifo", fifo])
    a = app.App(args)                # creates the fifo
    t = threading.Thread(target=reader, daemon=True)
    t.start()
    a.run()
    t.join(timeout=5)
    pcm = np.frombuffer(b"".join(chunks), "<i2").astype(np.float32)
    assert len(pcm) > 4096 * 4
    seg = pcm[len(pcm) // 2:]
    sp = np.abs(np.fft.rfft(seg * np.hanning(len(seg))))
    assert abs(np.fft.rfftfreq(len(seg), 1 / 48e3)[
        5 + np.argmax(sp[5:])] - 400.0) < 10.0


# ---- presets, internals ----

def test_list_presets_and_preset(capsys):
    rc, a = app.run_cli(["--device", "cpu", "--list-presets"])
    assert rc == 0 and a is None
    assert "KFMB" in capsys.readouterr().out
    rc, a = app.run_cli(["--device", "cpu", "--fs", "0.512", "--block",
                         "1024", "--blocks", "1", "--preset", "kfmb"])
    assert rc == 0 and a.cfg.receivers[0].fc_hz == 760e3
    assert app.main(["--device", "cpu", "--preset", "nope"]) == 2
    assert "unknown preset 'nope'" in capsys.readouterr().err


def test_internals_match_the_jax_bank(tmp_path, capsys):
    """--internals writes the JAX bank's dump: same keys, same values."""
    from pysdr_tpu import app as japp
    argv = ["--fs", "0.512", "--block", "4096", "--fc", "0.6", "0.62",
            "--modes", "AM", "USB", "--af-bw", "3"]
    path = str(tmp_path / "int.npz")
    rc, _ = app.run_cli(["--device", "cpu", *argv, "--internals", path])
    assert rc == 0 and f"wrote {path}" in capsys.readouterr().out
    got = np.load(path, allow_pickle=True)
    want = japp.App(japp.build_parser().parse_args(argv)) \
        .bank.dump_internals()
    assert sorted(got.files) == sorted(want)
    for k, v in want.items():
        if k == "af_banks":
            g = got[k].item()
            assert sorted(g) == sorted(v)
            for i in v:
                np.testing.assert_array_equal(g[i], np.asarray(v[i]))
        else:
            np.testing.assert_array_equal(got[k], np.asarray(v))


# ---- control plane ----

def free_port():
    """A TCP port free right now: `--hamlib-port 0` means the default
    base port 4575, which other test files bind too."""
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_hamlib_and_udp_reach_the_bank():
    """--hamlib/--udp-port: a rigctl retune and a UDP SO2V command reach
    bank._rx_cfgs at the next block boundary."""
    import socket
    import time
    args = app.build_parser().parse_args(
        ["--device", "cpu", "--fs", "0.512", "--block", "4096", "--hamlib",
         "--hamlib-port", str(free_port()), "--udp-port", "0"])
    a = app.App(args)
    a.start_services()
    try:
        s = socket.create_connection(("127.0.0.1", a.hamlib_servers[0].port),
                                     timeout=5)
        s.sendall(b"F 700000\n")
        assert s.recv(64).startswith(b"RPRT 0")
        u = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        u.sendto(b"SO2V:ON\n", ("127.0.0.1", a.udp_server.port))
        u.close()
        deadline = time.monotonic() + 10
        while a.ex._cmd_q.qsize() < 3 and time.monotonic() < deadline:
            time.sleep(0.02)
        a.ex.run(n_blocks=2)
        s.sendall(b"f\n")
        reply = s.recv(64)
        s.close()
        assert b"700000" in reply, reply
        assert a.bank._rx_cfgs[0].fc_hz == 700000.0
        assert a.bank._rx_cfgs[0].auto_mute and not a.bank._rx_cfgs[0].muted
    finally:
        a.stop_services()


def test_udp_spots_reach_the_display():
    import socket
    import time
    args = app.build_parser().parse_args(
        ["--device", "cpu", "--fs", "0.512", "--block", "4096", "--psd",
         "--udp-port", "0"])
    a = app.App(args)
    a.start_services()
    try:
        lst = [("K6XYZ", 601.4, "b"), ("W1AW", 608.0, "k")]
        s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        s.sendto(f"SpotList:20m:{lst!r}\n".encode(),
                 ("127.0.0.1", a.udp_server.port))
        s.close()
        deadline = time.monotonic() + 5
        while time.monotonic() < deadline and not len(a.display.rf.spots):
            time.sleep(0.05)
        assert sorted((sp.label, sp.freq_hz) for sp in a.display.rf.spots) \
            == [("K6XYZ", 601400.0), ("W1AW", 608000.0)]
    finally:
        a.stop_services()


def test_rig_follows_the_hamlib_server():
    """--rig against the reused hamlib server of another port app: the
    follower reads the rig's frequency and retunes RX0 to it."""
    rig_args = app.build_parser().parse_args(
        ["--device", "cpu", "--fs", "0.512", "--fc", "0.61", "--block",
         "1024", "--hamlib", "--hamlib-port", str(free_port())])
    rig = app.App(rig_args)
    rig.start_services()
    try:
        args = app.build_parser().parse_args(
            ["--device", "cpu", "--fs", "0.512", "--block", "1024", "--rig",
             f"127.0.0.1:{rig.hamlib_servers[0].port}"])
        a = app.App(args)
        try:
            assert a.rig.active and a.web is None
            a.follower.poll_once()
            a.ex._apply_pending()
            assert a.bank._rx_cfgs[0].fc_hz == 610000.0
        finally:
            a.rig.close()
    finally:
        rig.stop_services()


def test_hop_schedule_retunes_rx0(tmp_path):
    """--hop-schedule: the hopper posts the hour's first entry at start;
    the next block boundary retunes RX0 and sets its mode."""
    sched = tmp_path / "hops"
    sched.write_text("0-23: 0.62 0.64\n")
    args = app.build_parser().parse_args(
        ["--device", "cpu", "--fs", "0.512", "--block", "1024",
         "--hop-schedule", str(sched), "--dwell", "60"])
    a = app.App(args)
    a.start_services()
    try:
        import time
        deadline = time.monotonic() + 5
        while a.hopper.n_hops < 1 and time.monotonic() < deadline:
            time.sleep(0.02)
        a.ex.run(n_blocks=1)
        assert a.bank._rx_cfgs[0].fc_hz == 620000.0
        assert a.bank._rx_cfgs[0].mode == Mode.IQ
    finally:
        a.stop_services()


def test_memmon_logs(tmp_path):
    path = tmp_path / "mem.txt"
    rc, _ = app.run_cli(["--device", "cpu", "--fs", "0.512", "--block",
                         "1024", "--blocks", "2", "--memmon", str(path)])
    assert rc == 0 and path.read_text().strip()


def test_host_services_run_without_jax(tmp_path):
    """The CLI with the reused host services on (taps, aux, RTTY, hamlib,
    UDP, hopper, fldigi sync, memmon, display, web viewer) runs to its end
    with every jax import refused: nothing they load at run time reaches
    jax, as on a card host without it."""
    sched = tmp_path / "hops"
    sched.write_text("0-23: 0.62\n")
    argv = ["--device", "cpu", "--fs", "0.512", "--block", "1024",
            "--blocks", "2", "--hamlib", "--hamlib-port", str(free_port()),
            "--udp-port", "0", "--hop-schedule", str(sched), "--memmon",
            str(tmp_path / "mem.txt"), "--fldigi-ports", str(free_port()),
            "--save-iq", "--save-baseband", "--save-demod", "--save-dir",
            str(tmp_path), "--aux-wav", str(tmp_path / "aux.wav"), "--rtty",
            "0", "--wav", str(tmp_path / "w"), "--psd", "--web", "0"]
    script = textwrap.dedent(f"""
        import sys
        class NoJax:
            def find_spec(self, name, path=None, target=None):
                if name == "jax" or name.startswith(("jax.", "jaxlib")):
                    raise ImportError("jax import refused: " + name)
        sys.meta_path.insert(0, NoJax())
        from pysdr_tpu_torch import app
        rc = app.main({argv!r})
        assert not any(k == "jax" or k.startswith("jax.")
                       for k in sys.modules)
        print("rc", rc)
        """)
    out, report = run_cli("-c", script)
    assert out.returncode == 0 and "rc 0" in out.stdout, report
    assert len([f for f in os.listdir(tmp_path) if f.endswith(".dat")]) == 3


# ---- rtl_tcp ----

def am_iq(fs, n, offset_hz, audio_hz=400.0, amp=0.4):
    t = np.arange(n) / fs
    return (amp * (1 + 0.5 * np.sin(2 * np.pi * audio_hz * t))
            * np.exp(2j * np.pi * offset_hz * t)).astype(np.complex64)


@pytest.mark.parametrize("bank", ["receiver", "channelizer"])
def test_rtl_tcp_feeds_both_banks(tmp_path, bank):
    """--rtl-tcp against the fake dongle: the receiver bank (station at
    the dial, 64 kHz above the derived SDR center) and the channelizer
    bank (station on channel 1's center, +48 kHz) demodulate its 400 Hz
    tone; the dongle was programmed with the rate, frequency and gain."""
    from pysdr_tpu.io import rtltcp
    prefix = str(tmp_path / "net")
    if bank == "receiver":
        fs, ch, extra = 256e3, 0, ["--fc", "100.0"]
        iq = am_iq(fs, 1 << 17, 64e3)
    else:
        fs, ch, extra = 192e3, 1, ["--channelize", "4", "--fc", "100.0"]
        iq = am_iq(fs, 1 << 17, 48e3)
    srv = rtltcp.FakeRtlTcpServer(iq, rate_sps=2 * fs)
    try:
        rc, a = app.run_cli(
            ["--device", "cpu", "--rtl-tcp", f"127.0.0.1:{srv.port}",
             "--fs", str(fs / 1e6), "--block", "4096", "--blocks", "8",
             "--rf-gain", "28", "--wav", prefix, *extra])
        assert rc == 0
        pk, snr = peak_hz(f"{prefix}_rx{ch}.wav")
        assert abs(pk - 400.0) < 10.0 and snr > 30.0, (pk, snr)
        cmds = [c for c, _ in srv.commands]
        assert rtltcp.CMD_SET_SAMPLE_RATE in cmds
        assert rtltcp.CMD_SET_FREQ in cmds
        assert (rtltcp.CMD_SET_GAIN, 280) in srv.commands
    finally:
        srv.stop()


def test_rtl_tcp_unreachable_exits_2():
    out, report = run_cli("-m", "pysdr_tpu_torch", "--device", "cpu",
                          "--rtl-tcp", "127.0.0.1:9", "--rtl-tcp-retries",
                          "0", "--blocks", "1")
    assert out.returncode == 2, report
    assert "error:" in out.stderr and "Traceback" not in out.stderr, report
