"""The port's `--mesh S,C` CLI and its probe on the CPU (mirrors of
tests/test_app.py:155-171, 368-420 and 482, and of the probe's device
listing): a 2 x 2 stream x ch run and a 2 x 4 channelizer run write the
synth tones into their wavs, a 2-stream run with the i16 audio wire
still decodes the RTTY capture through the baseband tap, and a mesh the
host cannot hold exits 2 with a one-line error. On the CPU the grid is
the one CPU device repeated, the counterpart of the JAX package's
virtual CPU devices."""

import ctypes
import gc
import wave

import numpy as np
import pytest
import torch

from pysdr_tpu_torch import app, probe
from pysdr_tpu_torch.io import datfile
from pysdr_tpu_torch.models import rtty as rtty_mod

torch.set_num_threads(1)


@pytest.fixture(autouse=True, scope="module")
def release_heap():
    """After this module, give its freed heap back to the OS, so that the
    next test module in this worker process (tests/test_parity.py's RSS
    growth check among them) starts without megabytes of free but
    resident heap that a new allocation would reuse unseen."""
    yield
    gc.collect()
    getattr(ctypes.CDLL(None), "malloc_trim", lambda pad: 0)(0)

def run_cli(capsys, *argv):
    """`python -m pysdr_tpu_torch *argv` in this process: (exit code,
    captured stdout and stderr, a report of all three for the asserts).
    An exception that escapes the CLI fails the test with its traceback."""
    try:
        rc = app.main(list(argv))
    except SystemExit as e:                        # argparse's own errors
        rc = e.code
    out = capsys.readouterr()
    return rc, out, f"rc={rc}\n--- stdout\n{out.out}\n--- stderr\n{out.err}"


def wav_mono(path):
    with wave.open(path) as w:
        d = np.frombuffer(w.readframes(w.getnframes()), np.int16).reshape(
            -1, w.getnchannels())[:, 0].astype(np.float32)
        return d, w.getframerate()


def peak_hz(d, fs):
    seg = d[len(d) // 2:]
    sp = np.abs(np.fft.rfft(seg * np.hanning(len(seg))))
    return np.fft.rfftfreq(len(seg), 1.0 / fs)[5 + np.argmax(sp[5:])]


def test_app_mesh_cli(tmp_path, capsys):
    """A 2 x 2 stream x ch run from the CLI demodulates the synth tone of
    RX0 (400 Hz) into its wav, 4 super-blocks of 2 stream segments."""
    prefix = str(tmp_path / "mesh")
    rc, _, report = run_cli(capsys, "--device", "cpu", "--fs", "0.512",
                            "--block", "4096", "--blocks", "4", "--fc",
                            "0.6", "0.62", "--mesh", "2,2", "--wav", prefix)
    assert rc == 0, report
    d, fs = wav_mono(prefix + "_rx0.wav")
    assert len(d) > 4096 * 4, report
    assert abs(peak_hz(d, fs) - 400.0) < 10.0, report


def test_app_channelize_mesh_cli(tmp_path, capsys):
    """--channelize 8 with --mesh 2,4: the sharded channelizer from the
    CLI; channel 0 carries the synth's 300 Hz station."""
    prefix = str(tmp_path / "chmesh")
    rc, _, report = run_cli(capsys, "--device", "cpu", "--channelize", "8",
                            "--fs", "0.768", "--fc", "100.0", "--block",
                            "4096", "--blocks", "3", "--mesh", "2,4",
                            "--wav", prefix)
    assert rc == 0, report
    d, fs = wav_mono(prefix + "_rx0.wav")
    assert len(d) > 4096 * 2, report
    assert abs(peak_hz(d, fs) - 300.0) < 10.0, report


def test_app_rtty_composes_with_mesh_and_audio_wire(tmp_path):
    """--mesh does not exclude --audio-wire and --rtty: the sharded bank
    quantizes the audio inside each shard and emits the baseband tap, so
    a 2-stream run with the i16 audio wire decodes the RTTY text."""
    fs_rf = 512e3
    dsig = rtty_mod.RTTYDesign(fs=fs_rf)
    x = rtty_mod.synthesize_rtty("RYRY CQ CQ DE AA2IL AA2IL", dsig,
                                 carrier_hz=120e3 + 1000.0)
    path = str(tmp_path / "rtty_capture.dat")
    w = datfile.DatWriter(path, fs=fs_rf, fc=100e6 - 120e3)
    w.save_data(x)
    w.close()
    rc, a = app.run_cli(["--device", "cpu", "--replay", path, "--no-loop",
                         "--fc", "100.0", "--mode", "RTTY", "--block",
                         "4096", "--rtty", "0", "--mesh", "2,1",
                         "--audio-wire", "i16"])
    assert rc == 0
    assert a.bank.__class__.__name__ == "ShardedStreamBank"
    text = "".join(a.rtty_text)
    assert "AA2IL" in text, (text, a.rtty_text)


@pytest.mark.parametrize("argv", [["--mesh", "64,64"],
                                  ["--mesh", "0,2"],
                                  ["--rtl-tcp", "127.0.0.1:9"]])
def test_cli_clean_errors_for_config_mistakes(argv, capsys):
    """Operator mistakes exit 2 with one-line errors, not tracebacks."""
    rc, out, report = run_cli(capsys, "--device", "cpu", *argv,
                              "--blocks", "1")
    assert rc == 2, report
    assert "error:" in out.err and "Traceback" not in out.err, report


def test_probe_devices_and_smoke_on_the_cpu(capsys):
    """probe --device cpu --devices 4 --smoke: the CPU's description, the
    --mesh grids of 4 devices, and one block of the ReceiverBank."""
    assert probe.main(["--device", "cpu", "--devices", "4", "--smoke"]) == 0
    out = capsys.readouterr().out
    assert "device[cpu]" in out
    assert "4 device(s); stream x ch mesh shapes: 1x4 2x2 4x1" in out
    assert "smoke: 1 block" in out and "OK" in out


def test_probe_without_a_card_fails_loudly(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert probe.main([]) == 2
    err = capsys.readouterr().err
    assert "error:" in err and "--device cpu" in err
