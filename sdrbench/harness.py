"""One run of one cell of the benchmark of pysdr_tpu_torch.

A cell (BENCHMARK.json `workloads`) is a configuration (configs/<name>.json:
the App's command line, the RF scene, the plain reference's chain) under a
traffic mix (traffic/<name>.json: capture format, wires, block, pipeline,
any further App flags under `argv`, and a closed-loop replay or an
open-loop live pace). The harness finds both, the cell's limits
(checks/<cell>.json), every metric's reader (metrics/<metric>.py, else
metrics/<metric less its last .suffix>.py), the capture format, the
reference chain's kind and the scene's station kinds by name
(registry.py), so a new cell, mix, format, chain or metric is new files
and new BENCHMARK.json entries.

A run:
  1. set-up: makes the RF scene on the device from the seed and writes it
     once as a capture under TMPDIR; builds `pysdr_tpu_torch.app.App` from
     the configuration's and the traffic's argv with `--replay`; attaches
     its own source wrapper (counts reads; in an open loop, paces them),
     a wrapper on the executive's per-block callback (the time each
     block's audio reached the audio rings, and a seeded sample of the
     audio), and host spans around the calls into the program; captures
     the step and runs the warm-up blocks;
  2. the measured window, `--seconds` long, driven through App.ex.run;
  3. with `--trace 1`, a profiled stretch of a few blocks after it;
  4. the program stopped and freed, then the reference over the sampled
     blocks, and the comparison that decides `correct`;
  5. the result: info lines, then on stderr each compared number beside
     its limit, then on stdout one JSON line.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import math
import os
import resource
import statistics
import sys
import tempfile
import time

import numpy as np

from sdrbench import registry

HERE = registry.HERE
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "pysdr_tpu")
WARM_AUDIO_S = 1.0      # reference spans start this much audio earlier


# ------------------------------------------------------------ registry

def benchmark() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def reader(metric: str):
    """The `read(run)` of metrics/<metric>.py, or of the reader of the
    quantity, metrics/<metric less its last .suffix>.py (drain_ms.live
    and drain_ms.replay are both drain_ms.py). A reader returns None
    where the run has nothing for it to read."""
    name = metric
    while not os.path.exists(registry.path("metrics", name, ".py")):
        if "." not in name:
            raise KeyError(f"no reader for metric {metric!r}")
        name = name.rsplit(".", 1)[0]
    return registry.module("metrics", name).read


@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    checks: dict
    chips: int = 1


def cell(name: str, bench: dict | None = None) -> Cell:
    bench = bench or benchmark()
    w = next((w for w in bench["workloads"] if w["name"] == name), None)
    if w is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    return Cell(name=name,
                config=registry.load_json("configs", w["config"]),
                traffic=registry.load_json("traffic", w["traffic"]),
                checks=registry.load_json("checks", name),
                chips=int(w["chips"]))


def cell_metrics(name: str, bench: dict, trace: bool) -> list[dict]:
    """The metrics a run of cell `name` reports: its end-to-end metrics
    untraced, its per-layer metrics traced."""
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or name in m["workloads"]]
    if not trace:
        return e2e
    moved = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (name in m["workloads"] if "workloads" in m
                else m["moves"] in moved)]


def forbidden_modules() -> list[str]:
    """Top-level names in sys.modules that are JAX's or the JAX
    package's, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


# --------------------------------------------------------- attachments

class Source:
    """The source the executive reads, around the one App built: counts
    each block read and the time it was handed out. With `rate`, an open
    loop: block i is handed out no earlier than its due time t0 + (i + 1)
    * in_block / (rate fs), the time of its last sample, t0 being the
    first read; the schedule never waits for the program."""

    def __init__(self, inner, in_block: int, fs: float,
                 rate: float | None = None):
        self.inner = inner
        self.period = in_block / (fs * rate) if rate else None
        self.t0 = None
        self.handed: list[float] = []
        if hasattr(inner, "read_packed"):
            self.read_packed = self._read_packed

    def due(self, i: int) -> float:
        return self.t0 + (i + 1) * self.period

    def _pace(self):
        if self.period is not None:
            if self.t0 is None:
                self.t0 = time.perf_counter()
            wait = self.due(len(self.handed)) - time.perf_counter()
            if wait > 0:
                time.sleep(wait)

    def _read_packed(self, n):
        self._pace()
        x = self.inner.read_packed(n)
        self.handed.append(time.perf_counter())
        return x

    def read_data(self, n, loop=False):
        self._pace()
        x = self.inner.read_data(n, loop=loop)
        self.handed.append(time.perf_counter())
        return x


class Keeper:
    """The audio of a seeded sample of `k` window blocks (reservoir
    sampling, so the sample depends on the seed and the count alone),
    and of the window's last block."""

    def __init__(self, k: int, seed: int):
        self.k = k
        self.rng = np.random.default_rng(int(seed) % (1 << 63) + 1)
        self.slots: list = []
        self.last = None
        self.seen = 0

    def offer(self, block: int, audio):
        item = (block, audio)
        if self.seen < self.k:
            self.slots.append(item)
        else:
            j = int(self.rng.integers(0, self.seen + 1))
            if j < self.k:
                self.slots[j] = item
        self.last = item
        self.seen += 1

    def blocks(self) -> dict:
        out = dict(self.slots)
        if self.last is not None:
            out[self.last[0]] = self.last[1]
        return dict(sorted(out.items()))


class Delivery:
    """Wraps the executive's per-block callback (App's own, if any, still
    runs): the time each block's audio reached the audio rings, and the
    sampled audio of the window's blocks. The executive pushes a block
    into the rings and then calls the callback, in block order."""

    def __init__(self, ex, keeper: Keeper):
        self.inner = ex.psd_callback
        self.keeper = keeper
        self.times: list[float] = []
        self.in_window = lambda i, t: False
        ex.psd_callback = self

    def __call__(self, ex, audio):
        t = time.perf_counter()
        i = len(self.times)
        self.times.append(t)
        if self.in_window(i, t):
            self.keeper.offer(i, audio)
        if self.inner is not None:
            self.inner(ex, audio)


def attach_spans(app):
    """Host spans on the executive's thread, which the profiler records:
    its wait for the next block from the prefetch thread, its dispatch
    into the bank and its drain (instance attributes, and the executive
    module's drain, which the benchmark's process alone sees). Returns
    an undo."""
    from pysdr_tpu_torch.runtime import executive as ex_mod

    from sdrbench import tracing
    ex, bank = app.ex, app.ex.bank

    def wrap(fn, label):
        def inner(*a, **kw):
            with tracing.span(label):
                return fn(*a, **kw)
        return inner
    bank.step_device = wrap(bank.step_device, "dispatch")
    ex._read_block = wrap(ex._read_block, "wait_block")
    drain = ex_mod.drain
    ex_mod.drain = wrap(drain, "drain")

    def undo():
        ex_mod.drain = drain
    return undo


# ------------------------------------------------------------ the run

@dataclasses.dataclass
class Run:
    """What the metric readers read."""
    loop: str
    seconds: float
    in_block: int
    setup_s: float
    t_open: float
    t_close: float
    delivered: list                # host time of each block's delivery
    due: list | None               # open loop: due time of each block
    window_blocks: range | None    # open loop: the blocks due in it
    blocks_run: int                # blocks the window's ex.run drained
    stage_ms: dict                 # stage_ms over those blocks
    launches: dict                 # one step's hand-kernel launches
    host: dict                     # host_use over those blocks
    trace_blocks: int              # blocks of the traced stretch
    trace: object | None           # tracing.Trace of the stretch


def app_argv(cfg: dict, tr: dict, path: str, device: str) -> list[str]:
    """The App's command line: the configuration's, the traffic's wires,
    block and pipeline, the traffic's further flags (`argv`), then the
    replay of the capture."""
    argv = list(cfg["argv"]) + [
        "--wire", tr["wire"], "--audio-wire", tr["audio_wire"],
        "--block", str(tr["block"]),
        "--pipeline-depth", str(tr["pipeline_depth"])]
    if not tr.get("prefetch", True):
        argv.append("--no-prefetch")
    return argv + list(tr.get("argv", [])) + ["--replay", path,
                                              "--device", device]


HOST_FIELDS = ("ru_minflt", "ru_majflt", "ru_utime", "ru_stime", "ru_nvcsw",
               "ru_nivcsw")


def host_use(before, after, blocks: int) -> dict:
    """The process's page faults, CPU ms and context switches over a
    stretch, a block (getrusage)."""
    out = {}
    for f in HOST_FIELDS:
        d = getattr(after, f) - getattr(before, f)
        out[f[3:] + ("_ms" if f.endswith("time") else "")] = \
            (1e3 * d if f.endswith("time") else d) / max(1, blocks)
    return out


def run_cell(c: Cell, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t_start: float | None = None,
             fault=None, log=print) -> dict:
    """One run of cell `c`. `fault`, for the tests: called with the App
    before its step is captured. Returns the run's record (see main)."""
    import torch

    from pysdr_tpu_torch import app as app_mod

    from sdrbench import reference, scene, tracing
    t_start = time.perf_counter() if t_start is None else t_start
    marks = [("imports", time.perf_counter())]
    cfg, tr = c.config, c.traffic
    dev = torch.device(device)
    sc = cfg["scene"]
    fmt = scene.capture_format(tr["capture"])
    raw = scene.to_capture(scene.make_scene(sc, seed, dev), fmt)
    marks.append(("scene", time.perf_counter()))
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    fd, path = tempfile.mkstemp(prefix="sdrbench_", suffix=".dat")
    os.close(fd)
    undo = None
    try:
        scene.write_capture(path, raw, fmt, sc["fs"], sc["fc"])
        marks.append(("capture file", time.perf_counter()))
        app = app_mod.App(app_mod.build_parser().parse_args(
            app_argv(cfg, tr, path, device)))
        marks.append(("App", time.perf_counter()))
        ex, bank = app.ex, app.ex.bank
        d = bank.design
        chain = reference.chain_of(cfg["reference"], sc["fc"], tr["block"])
        if (chain.in_block, chain.out_block) != (d.in_block, d.out_block):
            raise RuntimeError(
                f"reference blocks {chain.in_block}/{chain.out_block} != "
                f"program's {d.in_block}/{d.out_block}")
        open_loop = tr["loop"] == "open"
        src = Source(ex.source, d.in_block, d.fs_in,
                     tr["rate"] if open_loop else None)
        ex.source = src
        keeper = Keeper(tr["compare_blocks"], seed)
        dl = Delivery(ex, keeper)
        undo = attach_spans(app)
        if fault is not None:
            fault(app)
        ex.prepare()
        marks.append(("step capture", time.perf_counter()))
        warm = int(tr["warm_blocks"])
        depth = ex.pipeline_depth
        due = window = None
        if open_loop:
            k = int(math.floor(seconds * tr["rate"] * d.fs_in / d.in_block))
            window = range(warm, warm + k)
            dl.in_window = lambda i, t: i in window
            stage0, n0 = dict(ex.stage_ms), ex.n_blocks
            ru0 = resource.getrusage(resource.RUSAGE_SELF)
            # timed blocks drain in the steady state: depth + 1 past them
            ex.run(n_blocks=warm + k + depth + 1)
            t_open = src.due(warm - 1)
            t_close = t_open + k * src.period
            due = [src.due(i) for i in range(len(src.handed))]
        else:
            ex.run(n_blocks=warm)
            stage0, n0 = dict(ex.stage_ms), ex.n_blocks
            ru0 = resource.getrusage(resource.RUSAGE_SELF)
            t_open = time.perf_counter()
            t_close = t_open + seconds
            dl.in_window = lambda i, t: t <= t_close
            ex.run(duration_s=seconds)
        marks.append(("warm-up and window", time.perf_counter()))
        blocks_run = ex.n_blocks - n0
        host = host_use(ru0, resource.getrusage(resource.RUSAGE_SELF),
                        blocks_run)
        stage = {k: ex.stage_ms[k] - stage0[k] for k in ex.stage_ms}
        peak = (torch.cuda.max_memory_allocated(dev)
                if dev.type == "cuda" else 0)
        trace_data = None
        if trace:
            n1 = ex.n_blocks + int(tr["trace_blocks"])

            def stretch():
                if open_loop:       # paced as the window: the next block
                    # due a period after the profiler has started
                    src.t0 = time.perf_counter() - \
                        len(src.handed) * src.period
                ex.run(n_blocks=n1)
            trace_data = tracing.stretch(stretch, dev)
        source_kind = type(src.inner).__name__
        app.stop_services()
        del app, ex, bank
    finally:
        if undo is not None:
            undo()
        os.unlink(path)
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    run = Run(loop=tr["loop"], seconds=seconds, in_block=d.in_block,
              setup_s=t_open - t_start, t_open=t_open, t_close=t_close,
              delivered=list(dl.times), due=due, window_blocks=window,
              blocks_run=blocks_run, stage_ms=stage,
              launches=chain.launches(tr["wire"]), host=host,
              trace_blocks=int(tr["trace_blocks"]), trace=trace_data)
    if open_loop:
        attempted = len(window)
        failed = sum(1 for i in window if i >= len(dl.times))
        lat = [src.handed[i] - due[i] for i in window
               if i < len(src.handed)]
        log(f"generator: {len(lat)} blocks handed out, late by p50 "
            f"{1e3 * statistics.median(lat):.3f} ms, max "
            f"{1e3 * max(lat):.3f} ms")
    else:
        attempted = sum(1 for t in dl.times if t_open < t <= t_close)
        failed = 0
    log("setup: " + ", ".join(
        f"{k} {b - a:.3f} s" for (_, a), (k, b) in
        zip([("start", t_start)] + marks, marks)))
    log(f"source: {source_kind} (the "
        + ("C++ streamer)" if source_kind == "NativeStreamer"
           else "Python reader)"))
    log(f"window, a block of {blocks_run}: stages ms " + ", ".join(
        f"{k} {v / max(1, blocks_run):.3f}" for k, v in stage.items())
        + "; host " + ", ".join(f"{k} {v:.3f}" for k, v in host.items()))

    sample = keeper.blocks()
    checks = compare(c, chain, raw, sample, dev, log=log)
    return {"run": run, "attempted": attempted, "failed": failed,
            "compared": len(sample), "checks": checks,
            "memory_peak_bytes": int(peak)}


# ------------------------------------------------------- correctness

def reference_audio(chain, raw, fmt: dict, wire: str, block: int,
                    dev, arith):
    """The reference's decoded audio of program block `block`, complex64
    numpy (R, out_block), and whether every latch was settled."""
    import torch

    from sdrbench import reference, scene
    warm = math.ceil(WARM_AUDIO_S * chain.fs_out / chain.out_block)
    b0 = max(0, block - warm)
    n = (block - b0 + 1) * chain.in_block
    x = reference.rf_wire(scene.span(raw, fmt, b0 * chain.in_block, n),
                          fmt, wire)
    xt = torch.view_as_complex(torch.from_numpy(np.ascontiguousarray(x))
                               .to(dev))
    audio, settled = chain.audio(xt, b0, arith,
                                 check_from=(block - b0) * chain.out_block
                                 if b0 > 0 else 0)
    return audio[:, -chain.out_block:], settled


def measures(prog: dict, refd: dict) -> dict:
    """The compared numbers over blocks {i: program audio} against the
    reference's {i: decoded audio}: the relative error of each receiver's
    block (rms of the difference over rms of the reference), its worst
    and its median (steady where the worst swings with a receiver whose
    audio is its noise floor, as a CW receiver keyed off), and the share
    of wire values that differ among those nonzero on either side."""
    rels, diff, active = [], 0, 0
    for i, p in prog.items():
        r = refd[i]
        num = np.linalg.norm((p - r).astype(np.complex128), axis=1)
        den = np.maximum(np.linalg.norm(r.astype(np.complex128), axis=1),
                         1e-3 * math.sqrt(r.shape[1]))
        rels.extend((num / den).tolist())
        pv = p.view(np.float32)
        rv = r.view(np.float32)
        act = (pv != 0) | (rv != 0)
        diff += int(((pv != rv) & act).sum())
        active += int(act.sum())
    return {"audio_rel_err": max(rels, default=0.0),
            "audio_rel_err_median": statistics.median(rels) if rels
            else 0.0,
            "audio_code_mismatch": diff / max(1, active)}


def compare(c: Cell, chain, raw, blocks: dict, dev, log=print,
            arith=None) -> dict:
    """{check: (value, limit)} for the cell's checks; `blocks` the
    program's audio by block."""
    import torch

    from sdrbench import reference, scene
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    arith = arith or reference.Arith(tf32=False)
    tr = c.traffic
    fmt = scene.capture_format(tr["capture"])
    refd, unsettled = {}, 0
    for i in blocks:
        refd[i], settled = reference_audio(chain, raw, fmt, tr["wire"], i,
                                           dev, arith)
        refd[i] = reference.audio_wire(refd[i], tr["audio_wire"])
        unsettled += int((~settled).sum())
    log(f"compared blocks: {sorted(blocks)}")
    got = measures(blocks, refd)
    got["latch_unsettled"] = unsettled
    return {k: (got[k], lim) for k, lim in c.checks.items()}


def passed(checks: dict) -> bool:
    """Each compared number at or under its limit."""
    return all(v <= lim for v, lim in checks.values())


def correct(res: dict) -> bool:
    """A run is correct when it compared some blocks, every compared
    number is at or under its limit, and no block due failed."""
    return res["compared"] > 0 and passed(res["checks"]) \
        and res["failed"] == 0


# ---------------------------------------------------------------- main

def parse(argv):
    ap = argparse.ArgumentParser(prog="sdrbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None, t_start: float | None = None) -> int:
    t_start = time.perf_counter() if t_start is None else t_start
    a = parse(argv)
    bench = benchmark()
    c = cell(a.workload, bench)
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < c.chips:
        print(f"sdrbench: {a.workload} needs {c.chips} CUDA device(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
              f"device_count {torch.cuda.device_count()}", file=sys.stderr)
        return 3
    from sdrbench import roofline
    res = run_cell(c, a.seed, a.seconds, bool(a.trace), "cuda", t_start)
    run, checks = res["run"], res["checks"]
    metrics = {}
    for m in cell_metrics(a.workload, bench, bool(a.trace)):
        v = reader(m["name"])(run)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    found = forbidden_modules()
    if found:
        print(f"sdrbench: the run loaded {found}", file=sys.stderr)
        return 4
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": c.chips,
              "memory_peak_bytes": res["memory_peak_bytes"],
              "power_limit_w": roofline.power_limit_w()}
    out = {"correct": correct(res),
           "attempted": res["attempted"], "failed": res["failed"],
           "metrics": metrics, "device": device}
    if run.trace is not None:
        device["busy_s"] = run.trace.busy_s
        device["window_s"] = run.trace.window_s
        out["breakdown"] = {"device_ops": run.trace.device_ops,
                            "idle_gaps": run.trace.idle_gaps}
    out["checks"] = {k: {"value": v, "limit": lim}
                     for k, (v, lim) in checks.items()}
    for k, (v, lim) in checks.items():
        print(f"check {k} {v!r} limit {lim!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
