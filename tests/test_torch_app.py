"""The torch port's CLI and executive on the CPU: the replay corpus
reproduces its pinned outcome, unported flags and a missing card fail
loudly, a bounded run drops no block, and no module imports jax."""

import os
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


@pytest.mark.parametrize("flag", [
    ["--channelize", "8"], ["--mesh", "1,8"], ["--rtty", "0"], ["--psd"],
    ["--bb"], ["--png-dir", "x"], ["--web", "0"], ["--hamlib"],
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
        for m in {mods!r}:
            importlib.import_module(m.removesuffix(".__main__"))
        assert not any(k == "jax" or k.startswith("jax.")
                       for k in sys.modules)
        print("imported", len({mods!r}))
        """)
    out, report = run_cli("-c", script)
    assert out.returncode == 0 and "imported" in out.stdout, report
