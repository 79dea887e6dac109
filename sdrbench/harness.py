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

A run (run.py starts its process with one OpenMP and one MKL thread):
  1. set-up: makes the RF scene on the device from the seed and writes it
     once as a capture under TMPDIR; builds `pysdr_tpu_torch.app.App` from
     the configuration's and the traffic's argv with `--replay`; attaches
     its own source wrapper (counts reads; in an open loop, paces them),
     the chain's tap, if it has one (below), a wrapper on the executive's
     per-block callback (the time each block's output was delivered, and
     a seeded sample of the audio), and host spans around the calls into
     the program; captures the step and runs the warm-up blocks;
  2. the measured window, `--seconds` long, driven through App.ex.run;
  3. with `--trace 1`, a profiled stretch of a few blocks after it;
  4. the program stopped and freed, then the reference over the sampled
     blocks, and the comparison that decides `correct`;
  5. the result: info lines, then on stderr each compared number beside
     its limit, then on stdout one JSON line.

A block is delivered when its output has reached its user: its audio
pushed into the audio rings and, where the App runs a per-block callback
of its own (the display, the RTTY decoder), that callback returned.
Without one, delivery is the audio's arrival at the rings.

The tap, an optional part of a chain's contract (reference.chain_of),
lets a chain check and time the App's own per-block output other than
the bank's audio, such as a decoder's text. A chain with a tap has:
  - `attach(app)`: called once, after the App is built and before its
    step is captured; wraps what it reads in the App and returns a `Tap`,
    which records that output, host values, under the index of the block
    being delivered (every block, warm-up included), and gives cumulative
    counters `{name: number}`. The harness reads the counters where it
    reads the executive's stage_ms and puts the difference in
    `Run.tap_counters`, for the metric readers;
  - `output(x, arith)`: the reference's output `{block: output}` of every
    whole block of x, the RF wire the program saw from the stream's start
    (block 0), under `arith`, so that state kept across blocks (a
    decoder's detection, shift) starts where the program's did; and
    `settle_blocks` (default 0), the first block compared;
  - `output_measures(prog, ref)`: the chain's own compared numbers
    `{name: value}` over the window's blocks from `settle_blocks` on, the
    program's output (None for a block it gave none) against the
    reference's. `compare` merges them with the audio's numbers, so a
    checks file names them with limits and they decide `correct`;
    control.py computes them with the reference's output under TF32 in
    the program's place.
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


class Tap:
    """The base of a chain's tap: the program's per-block output other
    than the bank's audio, {delivery index: output}, and its cumulative
    counters. Delivery sets `block` to the index of the block being
    delivered before the App's per-block callback runs, so what the
    chain's wrappers `record` during it lands under that block."""

    def __init__(self):
        self.block = -1
        self.outputs: dict = {}

    def record(self, out) -> None:
        self.outputs[self.block] = out

    def counters(self) -> dict:
        return {}


def has_tap(chain) -> bool:
    return hasattr(chain, "attach")


def tap_counters(tap: Tap | None) -> dict:
    return {} if tap is None else dict(tap.counters())


def settled(chain, blocks) -> list:
    """The blocks whose tap output is compared: those from the chain's
    `settle_blocks` on."""
    first = getattr(chain, "settle_blocks", 0)
    return [i for i in blocks if i >= first]


class Delivery:
    """Wraps the executive's per-block callback: the time each block was
    delivered, and the sampled audio of the window's blocks. The executive
    pushes a block into the rings and then calls the callback, in block
    order. Without a callback of the App's own, the block is delivered at
    that call, its audio's arrival at the rings; with one, when the App's
    callback returns, and a chain's `tap` learns the block's index
    first."""

    def __init__(self, ex, keeper: Keeper, tap: Tap | None = None):
        self.inner = ex.psd_callback
        if tap is not None and self.inner is None:
            raise RuntimeError("the chain has a tap, but the App runs no "
                               "per-block callback for it to read")
        self.keeper = keeper
        self.tap = tap
        self.times: list[float] = []
        self.in_window = lambda i, t: False
        ex.psd_callback = self.rings if self.inner is None else self.hooked

    def rings(self, ex, audio):
        t = time.perf_counter()
        i = len(self.times)
        self.times.append(t)
        if self.in_window(i, t):
            self.keeper.offer(i, audio)

    def hooked(self, ex, audio):
        t = time.perf_counter()
        i = len(self.times)
        if self.in_window(i, t):
            self.keeper.offer(i, audio)
        if self.tap is not None:
            self.tap.block = i
        self.inner(ex, audio)
        self.times.append(time.perf_counter())


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
    # the chain's tap's counters over those blocks; {} without a tap
    tap_counters: dict = dataclasses.field(default_factory=dict)


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
        tap = chain.attach(app) if has_tap(chain) else None
        dl = Delivery(ex, keeper, tap)
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
            tap0 = tap_counters(tap)
            ru0 = resource.getrusage(resource.RUSAGE_SELF)
            # timed blocks drain in the steady state: depth + 1 past them
            ex.run(n_blocks=warm + k + depth + 1)
            t_open = src.due(warm - 1)
            t_close = t_open + k * src.period
            due = [src.due(i) for i in range(len(src.handed))]
        else:
            ex.run(n_blocks=warm)
            stage0, n0 = dict(ex.stage_ms), ex.n_blocks
            tap0 = tap_counters(tap)
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
        tapc = {k: v - tap0.get(k, 0) for k, v in tap_counters(tap).items()}
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
        if open_loop:
            shown = list(window)
        else:
            shown = [i for i, t in enumerate(dl.times)
                     if t_open < t <= t_close]
        outputs = None if tap is None else {
            i: tap.outputs.get(i) for i in settled(chain, shown)}
        app.stop_services()
        # nothing of the program stays alive for the reference
        dl.inner = dl.tap = tap = None
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
              trace_blocks=int(tr["trace_blocks"]), trace=trace_data,
              tap_counters=tapc)
    if open_loop:
        attempted = len(window)
        failed = sum(1 for i in window if i >= len(dl.times))
        lat = [src.handed[i] - due[i] for i in window
               if i < len(src.handed)]
        log(f"generator: {len(lat)} blocks handed out, late by p50 "
            f"{1e3 * statistics.median(lat):.3f} ms, max "
            f"{1e3 * max(lat):.3f} ms")
    else:
        attempted = len(shown)
        failed = 0
    log("setup: " + ", ".join(
        f"{k} {b - a:.3f} s" for (_, a), (k, b) in
        zip([("start", t_start)] + marks, marks)))
    log(f"source: {source_kind} (the "
        + ("C++ streamer)" if source_kind == "NativeStreamer"
           else "Python reader)"))
    log(f"window, a block of {blocks_run}: stages ms " + ", ".join(
        f"{k} {v / max(1, blocks_run):.3f}" for k, v in stage.items())
        + "; host " + ", ".join(f"{k} {v:.3f}" for k, v in host.items())
        + "".join(f"; tap {k} {v / max(1, blocks_run):.3f}"
                  for k, v in tapc.items()))

    sample = keeper.blocks()
    checks = compare(c, chain, raw, sample, dev, log=log, outputs=outputs)
    return {"run": run, "attempted": attempted, "failed": failed,
            "compared": len(sample), "checks": checks,
            "memory_peak_bytes": int(peak)}


# ------------------------------------------------------- correctness

def rf_tensor(raw, fmt: dict, wire: str, start: int, n: int, dev):
    """Samples [start, start + n) of the looped capture as the program
    computes on them (reference.rf_wire), complex64 on `dev`."""
    import torch

    from sdrbench import reference, scene
    x = reference.rf_wire(scene.span(raw, fmt, start, n), fmt, wire)
    return torch.view_as_complex(torch.from_numpy(np.ascontiguousarray(x))
                                 .to(dev))


def reference_audio(chain, raw, fmt: dict, wire: str, block: int,
                    dev, arith):
    """The reference's decoded audio of program block `block`, complex64
    numpy (R, out_block), and whether every latch was settled."""
    warm = math.ceil(WARM_AUDIO_S * chain.fs_out / chain.out_block)
    b0 = max(0, block - warm)
    xt = rf_tensor(raw, fmt, wire, b0 * chain.in_block,
                   (block - b0 + 1) * chain.in_block, dev)
    audio, settled = chain.audio(xt, b0, arith,
                                 check_from=(block - b0) * chain.out_block
                                 if b0 > 0 else 0)
    return audio[:, -chain.out_block:], settled


def reference_outputs(chain, raw, fmt: dict, wire: str, last: int, dev,
                      arith) -> dict:
    """A tapped chain's reference output {block: output} of blocks 0 to
    `last`, computed from the stream's start."""
    return chain.output(rf_tensor(raw, fmt, wire, 0,
                                  (last + 1) * chain.in_block, dev), arith)


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
            arith=None, outputs: dict | None = None) -> dict:
    """{check: (value, limit)} for the cell's checks; `blocks` the
    program's audio by block, `outputs` a tapped chain's output by block
    (the window's, from its settle_blocks on). A check whose number could
    not be worked out (no output to compare) reads None."""
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
    if outputs:
        ref = reference_outputs(chain, raw, fmt, tr["wire"], max(outputs),
                                dev, arith)
        got.update(chain.output_measures(outputs,
                                         {i: ref[i] for i in outputs}))
        log(f"compared outputs: {len(outputs)} blocks, "
            f"{min(outputs)} to {max(outputs)}")
    return {k: (got.get(k), lim) for k, lim in c.checks.items()}


def passed(checks: dict) -> bool:
    """Each compared number worked out and at or under its limit."""
    return all(v is not None and v <= lim for v, lim in checks.values())


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
