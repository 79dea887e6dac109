"""The port's benchmark (pysdr_tpu_torch/bench.py) against the root
bench.py on the CPU: the same .dat bytes, the same helper arithmetic, the
same end-to-end keys and counts from the same replay (less the relay's
keys, plus the port's), the output check on a good and a detuned chain,
the whole run's last line at --device cpu --quick, and no run without a
card unless --device cpu is given."""

import copy
import importlib.util
import json
import os
import subprocess
import sys
import time

import pytest
import torch

from pysdr_tpu_torch import bench

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def jax_bench():
    """The root bench.py, whose top level imports the standard library
    only (its functions import pysdr_tpu)."""
    spec = importlib.util.spec_from_file_location(
        "root_bench", os.path.join(ROOT, "bench.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_bench(*argv, cwd, timeout=600):
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(
                   p for p in (ROOT, os.environ.get("PYTHONPATH")) if p))
    out = subprocess.run([sys.executable, "-m", "pysdr_tpu_torch.bench",
                          *argv], capture_output=True, text=True,
                         timeout=timeout, cwd=cwd, env=env)
    # the whole of both streams, so a failure under load can be triaged
    report = f"rc={out.returncode}\n--- stdout\n{out.stdout}\n" \
             f"--- stderr\n{out.stderr}"
    return out, report


# the suite's three files, cut in length
@pytest.mark.parametrize("fs,offset", [(2.048e6, 120e3), (8e6, 750e3),
                                       (12.288e6, 96e3), (12.288e6, 0.0)])
def test_write_am_dat_bytes_equal_the_root_bench(tmp_path, monkeypatch,
                                                 fs, offset):
    # the header carries the writer's clock
    monkeypatch.setattr(time, "time", lambda: 1.7e9)
    a, b = tmp_path / "port.dat", tmp_path / "jax.dat"
    bench._write_am_dat(str(a), fs=fs, n=1 << 14, offset_hz=offset)
    jax_bench()._write_am_dat(str(b), fs=fs, n=1 << 14, offset_hz=offset)
    assert a.read_bytes() == b.read_bytes()


def test_helpers_equal_the_root_bench():
    jb = jax_bench()
    for wire in ("f32", "i16", "i8"):
        assert bench._wire_bytes(wire) == jb._wire_bytes(wire)
    for rates in ([3.0], [2.0, 5.0], [7.5, 1.25, 4.0, 3.5, 9.0]):
        assert bench._sps_stats(rates, 43712) == jb._sps_stats(rates, 43712)
    out = {"transport_mbps": 30.0,
           "end_to_end_i8": {"samples_per_s": 6.7e6,
                             "wire_bytes_per_rf_sample": 2.188},
           "end_to_end_chan64": {"samples_per_s": 9.1e6,
                                 "wire_bytes_per_rf_sample": 2.5},
           "other": {"samples_per_s": 1.0}}
    a, b = copy.deepcopy(out), copy.deepcopy(out)
    bench._add_ceilings(a, 123.4)
    jb._add_ceilings(b, 123.4)
    assert a == b and "ceiling_msps" in a["end_to_end_i8"]


# what the port's _run_e2e adds to the root bench's keys (the relay's
# keys, first_pull_tax_s and includes_rpc_floor_ms, were never in it)
NEW_E2E_KEYS = {"check_rx", "tone_db", "correct"}
NEW_STAGES = {"quantize", "pin+issue", "handoff", "hold", "drain_wait",
              "decode"}
SMALL = ["--fs", "0.512", "--block", "4096"]


@pytest.fixture(scope="module")
def am_dat(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("e2e") / "e2e.dat")
    bench._write_am_dat(path, fs=0.512e6, n=1 << 18)
    return path


def test_run_e2e_matches_the_root_bench(am_dat):
    """The same replay through both benches: the port's keys are the root
    bench's plus its own, the counts and the source agree, the stages add
    up and the output check passes."""
    argv = ["--replay", am_dat, *SMALL, "--fc", "100.0", "--wire", "i8"]
    kw = dict(n_blocks=4, warm=1, reps=2)
    got = bench._run_e2e(["--device", "cpu", *argv], **kw)
    want = jax_bench()._run_e2e(argv, **kw)
    assert set(got) == set(want) | NEW_E2E_KEYS
    assert set(got["stage_ms"]) == set(want["stage_ms"]) | NEW_STAGES
    for k in ("n_reps", "blocks_per_rep", "in_block", "n_rx",
              "bytes_up_per_block", "bytes_down_per_block",
              "wire_bytes_per_rf_sample", "source"):
        assert got[k] == want[k], k
    st = got["stage_ms"]
    assert st["upload"] == pytest.approx(st["quantize"] + st["pin+issue"],
                                         abs=2e-3)
    assert got["check_rx"] == 0 and got["correct"] is True
    assert got["tone_db"] >= bench.TONE_MIN_DB


@pytest.mark.parametrize("fc,correct", [("100.0", True), ("99.9", False)])
def test_output_check_passes_on_the_station_only(tmp_path, fc, correct):
    """On a capture with noise, the RX on the station carries its 400 Hz
    tone and passes; an RX tuned 100 kHz off it hears noise, its entry
    says "correct": false and failed_checks finds it. (The bench's own
    files carry no noise: there, a filter's stopband leaks the station
    with its tone into any RX, so the check catches a broken chain, not a
    detuned one.)"""
    import numpy as np

    from pysdr_tpu_torch.io import datfile
    fs, n, off = 0.512e6, 1 << 18, 120e3
    t = np.arange(n) / fs
    rng = np.random.default_rng(0)
    x = 0.45 * (1 + 0.5 * np.sin(2 * np.pi * 400.0 * t)) \
        * np.exp(2j * np.pi * off * t) \
        + 0.01 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
    path = str(tmp_path / "noisy.dat")
    w = datfile.DatWriter(path, fs=fs, fc=100e6 - off)
    w.save_data(x.astype(np.complex64))
    w.close()
    res = bench._run_e2e(["--device", "cpu", "--replay", path, *SMALL,
                          "--fc", fc, "--wire", "i8"],
                         n_blocks=4, warm=1, reps=2)
    assert res["check_rx"] == 0 and res["correct"] is correct, res
    assert (res["tone_db"] >= bench.TONE_MIN_DB) is correct
    assert bench.failed_checks({"end_to_end_x": res}) == (
        [] if correct else ["end_to_end_x"])


def test_tone_db_reads_the_tone_over_the_floor():
    import numpy as np
    rng = np.random.default_rng(0)
    t = np.arange(48000) / 48e3
    noise = 1e-3 * rng.standard_normal(len(t))
    assert bench.tone_db(np.sin(2 * np.pi * 400.0 * t) + noise, 48e3) > 60
    assert bench.tone_db(np.sin(2 * np.pi * 700.0 * t) + noise, 48e3) < 20


def test_main_cpu_quick_prints_one_line(tmp_path):
    """The whole bench at --device cpu --quick: every config in its own
    child, none failed, and a last line with no device number."""
    out, report = run_bench("--device", "cpu", "--quick", cwd=tmp_path)
    assert out.returncode == 0, report
    lines = out.stdout.strip().splitlines()
    assert len(lines) == 1, report
    res = json.loads(lines[-1])
    assert res["metric"] == "rf_samples_per_s_4ch_bank", report
    assert res["value"] is None and res["vs_baseline"] is None, report
    extra = res["extra"]
    assert extra["device"] == {"platform": "cpu"}, report
    for name in bench.CONFIGS:
        assert "error" not in extra[name], (name, report)
        assert not bench.failed_checks(extra[name]), (name, report)
    for name in ("am", "nfm_squelch", "ssb_agc"):
        assert set(bench.PROFILE_KEYS) <= set(extra["modes1ch"][name])
    suite = extra["e2e_suite"]
    assert {k for k in suite if k.startswith("end_to_end")} == {
        "end_to_end_f32", "end_to_end_i16", "end_to_end_i8",
        "end_to_end_i8_xl", "end_to_end_bank4",
        "end_to_end_bank4_no_prefetch", "end_to_end_chan64"}
    for name, e in suite.items():
        if name.startswith("end_to_end"):
            assert NEW_STAGES <= set(e["stage_ms"]), name
            assert "pct_of_ceiling" in e, name
    # the checkpoint of the e2e child is gone
    assert not list(tmp_path.glob(".bench_partial_*.json"))


def test_no_card_and_no_cpu_flag_exits_nonzero(tmp_path, capsys):
    """Decided here, not at import: on a host without a card the bench
    refuses to run unless --device cpu is given, in-process and as a
    command, and prints no result."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert bench.main([]) != 0
    assert bench.main(["bank4"]) != 0
    captured = capsys.readouterr()
    assert captured.out == ""
    assert "is_available() is False" in captured.err
    out, report = run_bench(cwd=tmp_path, timeout=120)
    assert out.returncode != 0 and out.stdout.strip() == "", report
