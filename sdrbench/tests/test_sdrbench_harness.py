"""The benchmark's harness on the CPU: the registry, the paced source, the
end-to-end arithmetic, and the checks that guard a run.

    python -m pytest -q sdrbench/tests
"""

from __future__ import annotations

import ast
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time

import pytest

from sdrbench import harness, registry
from sdrbench.tests import tiny

ROOT = harness.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _bench():
    return harness.benchmark()


@pytest.mark.parametrize("w", [w["name"] for w in
                               harness.benchmark()["workloads"]])
def test_cells_found_by_name(w):
    c = harness.cell(w)
    assert c.config["name"] in {x["name"] for x in _bench()["configs"]}
    for key in ("capture", "wire", "audio_wire", "block", "loop",
                "warm_blocks", "compare_blocks", "trace_blocks"):
        assert key in c.traffic
    assert c.checks, "a cell compares at least one number"
    names = {m["name"] for m in harness.cell_metrics(w, _bench(), False)}
    assert "setup_s" in names and len(names) >= 2
    assert harness.cell_metrics(w, _bench(), True)


def test_every_metric_has_a_reader():
    b = _bench()
    for m in b["end_to_end"] + b["per_layer"]:
        assert callable(harness.reader(m["name"])), m["name"]
    # one reader a quantity: a suffix falls back to the quantity's file
    assert harness.reader("drain_ms.live") is harness.reader("drain_ms")
    with pytest.raises(KeyError):
        harness.reader("no_such_metric.live")


@pytest.mark.parametrize("folder", ["captures", "chains", "stations"])
def test_parts_are_found_by_name(folder):
    names = [f.rsplit(".", 1)[0] for f in
             os.listdir(os.path.join(harness.HERE, folder))
             if f.endswith((".json", ".py"))]
    assert names
    for n in names:
        if folder == "captures":
            fmt = registry.load_json(folder, n)
            assert "dtype" in fmt
        else:
            mod = registry.module(folder, n)
            assert callable(getattr(mod, "build", None)
                            or getattr(mod, "baseband", None)), n


def test_a_new_traffic_file_passes_its_flags_to_the_app(tmp_path):
    """A mix that is only a file: its `argv` reaches the App's command
    line (here the display at every block, open question 3's mix), and
    the run is judged as any other."""
    mix = dict(tiny.traffic(), argv=["--psd", "--psd-every", "1"])
    path = tmp_path / "replay_psd.json"
    path.write_text(json.dumps(mix))
    c = harness.Cell("tiny.bank_psd", tiny.BANK,
                     json.loads(path.read_text()),
                     dict(harness.cell("bank4.live_1x").checks))
    frames = []

    def count_frames(app):
        assert app.display is not None and app.display.decimate == 1
        upd = app.display.update_rf

        def counted(x):
            frames.append(1)
            return upd(x)
        app.display.update_rf = counted
    res = harness.run_cell(c, 2**31 + 99, 0.3, False, "cpu",
                           fault=count_frames, log=lambda *a: None)
    assert len(frames) >= res["attempted"] > 0
    assert harness.correct(res), res["checks"]


def test_benchmark_json_keeps_the_contract():
    b = _bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["sdrbench"]
    assert 1 <= b["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in b[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for c in b["configs"]:
        assert os.path.exists(os.path.join(ROOT, c["file"]))
        assert 1 <= len(c["source"]) <= 200 and 1 <= len(c["why"]) <= 200
    for w in b["workloads"]:
        assert len(w["why"]) <= 200 and w["chips"] == 1
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    e2e = {m["name"] for m in b["end_to_end"]}
    assert e2e == {"latency_p50_ms", "setup_s"}
    for m in b["per_layer"]:
        assert m["moves"] in e2e
        for w in m["workloads"]:        # each cell reports what it moves
            assert m["moves"] in {x["name"] for x in
                                  harness.cell_metrics(w, b, False)}
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
    assert len(json.dumps(b)) < 64 * 1024


class _Inner:
    def __init__(self):
        self.reads = 0

    def read_packed(self, n):
        self.reads += 1
        return n


def test_paced_source_keeps_its_schedule_through_a_stall():
    period = 0.02
    src = harness.Source(_Inner(), in_block=1000, fs=1000 / period,
                         rate=1.0)
    src.read_packed(1000)                       # t0, block 0 at t0 + T
    assert src.handed[0] - src.t0 >= period
    time.sleep(4 * period)                      # the consumer stalls
    for _ in range(3):
        src.read_packed(1000)                   # blocks 1-3 are overdue
    for i in range(4):
        assert src.due(i) == pytest.approx(src.t0 + (i + 1) * period)
    # overdue blocks go out at once: the schedule did not slip
    assert src.handed[3] - src.handed[1] < period
    src.read_packed(1000)                       # block 4 waits for its due
    assert src.handed[4] >= src.due(4)


def _run(**kw):
    base = dict(loop="closed", seconds=2.0, in_block=1000, setup_s=1.0,
                t_open=0.0, t_close=2.0, delivered=[], due=None,
                window_blocks=None, blocks_run=0, stage_ms={}, launches={}, host={},
                trace_blocks=1, trace=None)
    base.update(kw)
    return harness.Run(**base)


def test_rf_msps_is_all_work_over_all_the_window():
    # 100 blocks in the first second, a stall, 20 more: 120 blocks in 2 s
    times = [0.01 * (i + 1) for i in range(100)] + \
        [1.5 + 0.02 * i for i in range(20)] + [2.5]
    run = _run(delivered=[-0.5] + times)
    assert harness.reader("rf_msps")(run) == pytest.approx(
        120 * 1000 / 2.0 / 1e6)


def test_latency_p95_is_over_every_due_block():
    n = 100
    due = [float(i) for i in range(n)]
    delivered = [d + 0.010 for d in due]
    for i in range(90, 96):                      # 6 slow: the 95th of 100
        delivered[i] = due[i] + 0.5
    run = _run(loop="open", due=due, delivered=delivered,
               window_blocks=range(0, n))
    assert harness.reader("latency_p95_ms")(run) == pytest.approx(500.0)
    delivered[95] = due[95] + 0.010             # 5 slow: the 95th is fast
    assert harness.reader("latency_p95_ms")(run) == pytest.approx(10.0)
    # a block that never came misses every limit
    run = _run(loop="open", due=due, delivered=delivered[:40],
               window_blocks=range(0, n))
    assert harness.reader("latency_p95_ms")(run) is None


def test_latency_p50_is_the_median_of_every_due_block():
    n = 100
    due = [float(i) for i in range(n)]
    delivered = [d + 0.004 for d in due]
    for i in range(0, 51):                       # 51 slow: the 50th is slow
        delivered[i] = due[i] + 0.020
    run = _run(loop="open", due=due, delivered=delivered,
               window_blocks=range(0, n))
    assert harness.reader("latency_p50_ms")(run) == pytest.approx(20.0)
    delivered[0] = due[0] + 0.004               # 50 slow: the 50th is fast
    assert harness.reader("latency_p50_ms")(run) == pytest.approx(4.0)
    # blocks that never came count as late: over half lose the median
    run = _run(loop="open", due=due, delivered=delivered[:49],
               window_blocks=range(0, n))
    assert harness.reader("latency_p50_ms")(run) is None
    run = _run(loop="open", due=due, delivered=delivered[:60],
               window_blocks=range(0, n))
    assert harness.reader("latency_p50_ms")(run) == pytest.approx(20.0)


def test_keeper_sample_depends_on_the_seed_and_count_alone():
    def pick(seed):
        k = harness.Keeper(4, seed)
        for i in range(10, 500):
            k.offer(i, None)
        return list(k.blocks())
    assert pick(2**31 + 11) == pick(2**31 + 11)
    assert pick(2**31 + 11) != pick(7)
    assert pick(7)[-1] == 499 and len(pick(7)) == 5


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    import pysdr_tpu_torch  # noqa: F401
    base = set(harness.forbidden_modules())
    assert "pysdr_tpu" not in base or "pysdr_tpu" in sys.modules
    monkeypatch.setitem(sys.modules, "pysdr_tpu_torch_extra", object())
    assert set(harness.forbidden_modules()) == base
    monkeypatch.setitem(sys.modules, "jaxlib.xla_client", object())
    assert "jaxlib" in harness.forbidden_modules()


def test_a_run_loads_no_jax():
    """A tiny CPU run in a fresh process leaves no JAX or JAX-package
    module behind (the harness checks the same before its result)."""
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from sdrbench import harness\n"
        "from sdrbench.tests import tiny\n"
        "harness.run_cell(tiny.bank_cell(), 5, 0.3, True, 'cpu',"
        " log=lambda *a: None)\n"
        "print(harness.forbidden_modules())\n") % ROOT
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT,
                         env={**os.environ, "PYTHONPATH": ROOT})
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            yield node.module or ""


def test_the_reference_imports_nothing_of_the_program():
    names = ["reference.py", "scene.py", "roofline.py", "registry.py"] + [
        os.path.join(d, f) for d in ("chains", "stations")
        for f in os.listdir(os.path.join(harness.HERE, d))
        if f.endswith(".py")]
    for name in names:
        for mod in _imports(os.path.join(harness.HERE, name)):
            assert mod.split(".")[0] not in ("pysdr_tpu_torch", "pysdr_tpu",
                                             "jax", "jaxlib"), (name, mod)


def test_no_result_without_a_card_or_without_the_program(tmp_path):
    cmd = [sys.executable, "sdrbench/run.py", "--workload",
           "bank4.live_1x", "--seed", "1", "--seconds", "1", "--trace",
           "0"]
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    out = subprocess.run(cmd, capture_output=True, text=True, timeout=300,
                         cwd=ROOT, env=env)
    assert out.returncode == 3 and not out.stdout.strip(), out.stderr
    assert "needs 1 CUDA device" in out.stderr
    # the benchmark's files alone
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(harness.HERE, tmp_path / "sdrbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(cmd, capture_output=True, text=True, timeout=300,
                         cwd=tmp_path, env={k: v for k, v in env.items()
                                            if k != "PYTHONPATH"})
    assert out.returncode != 0 and not out.stdout.strip()


def test_latency_reader_handles_an_empty_window():
    run = _run(loop="open", due=[], delivered=[], window_blocks=range(0))
    assert harness.reader("latency_p95_ms")(run) is None
    assert harness.reader("latency_p50_ms")(run) is None
    assert not math.isnan(harness.reader("setup_s")(run))
