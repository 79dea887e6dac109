#!/usr/bin/env python3
"""Where a live block's RF-to-audio latency goes, block by block: one
traced run of each live cell of the benchmark (sdrbench.harness.run_cell,
`--trace 1`'s path), with the executive's records (Executive.block_spans)
joined to the harness's due and delivery times by block id.

    python3 probes/torch_block_spans.py [--cells C ...] [--seconds S]
        [--seed N] [--ranges-off] [--out DIR]

For each cell it prints, and writes to DIR/block_spans_<cell>.json (DIR
is probe_out/ by default):
  - the mean of each stage (profiler.BLOCK_STAGES) and the source's
    lateness (arrival - due) over the window's blocks at or above the p95
    latency (nearest rank, as latency_p95_ms), the same for the block at
    the median latency and the window's median of each;
  - for each tail block, which part of its releaser (the block whose take
    started its drain) made up its excess hold over the window's median:
    the releaser's lateness at the source, its prepare (quantize +
    pin+issue) or its hand-off;
  - the traced stretch's idle gaps by the executive's `pysdr.<stage>`
    range around them (the harness's profiler records the executive's
    thread), and the `pysdr.*` events the profiler put on the device's
    timeline (none is expected: the ranges are not user annotations);
  - the stretch's wall and the executive's host stages a block;
  - for each run() of the executive, the prefetch thread's CPU time a
    block, read whole from /proc/self/task/<tid> (schedstat's run time in
    ns where the host has it, else stat's utime + stime in clock ticks;
    the result names the source and its step), beside the thread's wall
    in read + quantize + pin+issue. Over a window of ~1000 blocks a
    10 ms step is ~0.01 ms a block.
With --ranges-off, each cell runs again with the ranges switched off
(executive.stage_range a no-op), so the stretch's cost of the ranges
shows.

Needs a CUDA device (--tiny rehearses on the CPU); prints the card's name
and power limit first.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import json
import math
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from pysdr_tpu_torch.runtime import executive, profiler  # noqa: E402
from sdrbench import harness  # noqa: E402

CELLS = ("bank4.live_1x", "chan64.live_1x")
STAGES = [s for s, _, _ in profiler.BLOCK_STAGES]


PROFILE = torch.profiler.profile


class CapturingProfile(PROFILE):
    """torch.profiler.profile that keeps the last instance it closed, so
    the harness's own traced stretch can be read again here."""
    last = None

    def __exit__(self, *exc):
        out = super().__exit__(*exc)
        CapturingProfile.last = self
        return out


def _ms(ns: float) -> float:
    return ns / 1e6


def block_table(run, spans: dict) -> dict:
    """The window's blocks' latency, stages and lateness, the tail's
    means, the median's, and the tail's hold excess by its releaser."""
    rows = {}
    for i in run.window_blocks:
        s = spans.get(i)
        if s is None or i >= len(run.delivered):
            continue
        due_ns = run.due[i] * 1e9
        row = {"latency": _ms(run.delivered[i] * 1e9 - due_ns),
               "lateness": _ms(s.arrival - due_ns), **s.stages_ms(),
               "pushed_to_delivered": _ms(run.delivered[i] * 1e9 - s.pushed),
               "read": _ms(s.arrival - s.read0),
               "released_by": s.released_by}
        rows[i] = row
    lat = sorted(r["latency"] for r in rows.values())
    p95 = lat[math.ceil(0.95 * len(lat)) - 1]
    p50 = lat[math.ceil(0.50 * len(lat)) - 1]
    keys = ["latency", "lateness", *STAGES, "pushed_to_delivered", "read"]
    tail = [i for i, r in rows.items() if r["latency"] >= p95]
    med_block = min(rows, key=lambda i: abs(rows[i]["latency"] - p50))
    median = {k: statistics.median(r[k] for r in rows.values())
              for k in keys}

    def part(r):
        """The releaser's quantities a drain waits for."""
        return {"lateness": r["lateness"],
                "prepare": r["quantize"] + r["pin+issue"],
                "handoff": r["handoff"]}
    med_part = {k: statistics.median(part(r)[k] for r in rows.values())
                for k in ("lateness", "prepare", "handoff")}
    causes = collections.Counter()
    excess = []
    for i in tail:
        r = rows[i]
        rel = rows.get(r["released_by"])
        if rel is None:
            causes["no releaser in the window"] += 1
            continue
        ex = {k: v - med_part[k] for k, v in part(rel).items()}
        cause = max(ex, key=ex.get)
        causes[cause] += 1
        excess.append({"block": i, "released_by": r["released_by"],
                       "hold_excess": r["hold"] - median["hold"],
                       **{f"releaser_{k}_excess": v for k, v in ex.items()},
                       "cause": cause})
    return {"blocks": len(rows), "p95_ms": p95, "p50_ms": p50,
            "tail_blocks": sorted(tail),
            "tail_mean": {k: statistics.fmean(rows[i][k] for i in tail)
                          for k in keys},
            "median_block": {"block": med_block,
                             **{k: rows[med_block][k] for k in keys}},
            "window_median": median,
            "releaser_median": med_part,
            "tail_causes": dict(causes), "tail_excess": excess}


def gaps_by_stage(prof) -> dict:
    """The stretch's device idle gaps by the executive's `pysdr.<stage>`
    range at each gap's middle, and the `pysdr.*` events on the device's
    timeline."""
    dev, ranges, mirrored = [], [], []
    for e in prof.events():
        cuda = e.device_type == torch.autograd.DeviceType.CUDA
        if e.name.startswith("pysdr."):
            (mirrored if cuda else ranges).append(
                (e.time_range.start, e.time_range.end, e.name))
        elif cuda and not e.name.startswith("sdrbench."):
            if e.time_range.end > e.time_range.start:
                dev.append((e.time_range.start, e.time_range.end))
    busy = []
    for a, b in sorted(dev):
        if busy and a <= busy[-1][1]:
            busy[-1][1] = max(busy[-1][1], b)
        else:
            busy.append([a, b])
    by_stage = collections.defaultdict(float)
    largest = []
    for (_, a), (b, _) in zip(busy, busy[1:]):
        mid = 0.5 * (a + b)
        inside = [r for r in ranges if r[0] <= mid <= r[1]]
        name = min(inside, key=lambda r: r[1] - r[0])[2] if inside \
            else "none"
        by_stage[name.split("#")[0]] += (b - a) * 1e-3
        largest.append(((b - a) * 1e-3, name))
    largest.sort(reverse=True)
    return {"idle_ms_by_stage": dict(sorted(by_stage.items(),
                                            key=lambda t: -t[1])),
            "largest_gaps_ms": largest[:8],
            "pysdr_ranges": len(ranges),
            "pysdr_on_device": len(mirrored),
            "pysdr_on_device_names": sorted({m[2].split("#")[0]
                                             for m in mirrored})}


def thread_cpu(thread):
    """(CPU ns the thread has taken, the reading's step in ns, source),
    or None where /proc has no reading of it."""
    if thread is None or not thread.is_alive():
        return None
    task = f"/proc/self/task/{thread.native_id}"
    try:
        with open(f"{task}/schedstat") as f:
            return int(f.read().split()[0]), 1, "schedstat"
    except (OSError, ValueError, IndexError):
        pass
    try:
        with open(f"{task}/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
    except OSError:
        return None
    tick = os.sysconf("SC_CLK_TCK")
    return ((int(fields[11]) + int(fields[12])) * 10**9 // tick,
            10**9 // tick, "stat")


def traced(cell, seed: int, seconds: float, ranges: bool,
           device: str = "cuda") -> dict:
    seen = {}

    def fault(app):
        ex = app.ex
        seen["spans"] = ex.block_spans
        calls = seen.setdefault("calls", [])
        run = ex.run

        def counted(**kw):
            st0, n0 = dict(ex.stage_ms), ex.n_blocks
            # a prefetch thread this run starts has taken nothing yet
            c0 = thread_cpu(ex._pf_thread) or (0, None, None)
            out = run(**kw)
            c1 = thread_cpu(ex._pf_thread)
            n = max(1, ex.n_blocks - n0)
            got = {k: (ex.stage_ms[k] - st0[k]) / n for k in ex.stage_ms}
            if c1 is not None:
                got["prefetch_thread_cpu"] = (c1[0] - c0[0]) / 1e6 / n
                got["prefetch_thread_wall"] = \
                    got["read"] + got["quantize"] + got["pin+issue"]
                got["cpu_source"], got["cpu_step_ms"] = c1[2], c1[1] / 1e6
            calls.append(got)
            return out
        ex.run = counted
    torch.profiler.profile = CapturingProfile
    stage_range = executive.stage_range
    if not ranges:
        executive.stage_range = lambda stage, block_id: \
            contextlib.nullcontext()
    try:
        res = harness.run_cell(cell, seed, seconds, True, device,
                               fault=fault)
    finally:
        executive.stage_range = stage_range
        torch.profiler.profile = PROFILE
    run = res["run"]
    spans = {s.id: s for s in seen["spans"]}
    out = {"cell": cell.name, "seed": seed, "ranges": ranges,
           "correct": harness.correct(res),
           "metrics": {m: harness.reader(m)(run) for m in
                       ("latency_p95_ms", "hold_ms.live", "handoff_ms.live",
                        "dispatch_ms.live", "drain_ms.live",
                        "drain_wait_ms.live", "decode_ms.live",
                        "device_busy_ms.live")},
           "window_stage_ms": {k: v / max(1, run.blocks_run)
                               for k, v in run.stage_ms.items()},
           "host": run.host,
           "stretch_wall_ms_a_block": 1e3 * run.trace.window_s /
           run.trace_blocks,
           "stretch_stage_ms": seen["calls"][-1],
           "run_calls_stage_ms": seen["calls"],
           "trace_gaps": gaps_by_stage(CapturingProfile.last),
           "harness_idle_gaps": run.trace.idle_gaps}
    out["table"] = block_table(run, spans)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="probes/torch_block_spans.py")
    ap.add_argument("--cells", nargs="+", default=list(CELLS))
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--seed", type=int, default=2**31 + 4242)
    ap.add_argument("--ranges-off", action="store_true")
    ap.add_argument("--out", default=os.path.join(ROOT, "probe_out"))
    ap.add_argument("--tiny", action="store_true",
                    help="a rehearsal on the CPU: the CPU tests' tiny "
                         "open-loop cells (sdrbench/tests/tiny.py)")
    a = ap.parse_args(argv)
    if a.tiny:
        from sdrbench.tests import tiny
        cells = [tiny.bank_cell(loop="open"), tiny.chan_cell(loop="open")]
        device = "cpu"
    elif not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    else:
        cells = [harness.cell(c) for c in a.cells]
        device = "cuda"
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60)
        print(smi.stdout.strip().splitlines()[0], torch.__version__,
              flush=True)
    os.makedirs(a.out, exist_ok=True)
    for k, cell in enumerate(cells):
        variants = [True, False] if a.ranges_off else [True]
        if a.ranges_off and k % 2:
            variants.reverse()
        for on in variants:
            r = traced(cell, a.seed + k, a.seconds, on, device)
            tag = cell.name + ("" if on else ".ranges_off")
            with open(os.path.join(a.out, f"block_spans_{tag}.json"),
                      "w") as f:
                json.dump(r, f, indent=1, default=str)
            t = r["table"]
            print(f"{tag}: correct {r['correct']}, p95 {t['p95_ms']:.3f} "
                  f"p50 {t['p50_ms']:.3f} ms over {t['blocks']} blocks; "
                  f"metrics {json.dumps(r['metrics'])}", flush=True)
            print(f"  tail mean {json.dumps(t['tail_mean'])}", flush=True)
            print(f"  median block {json.dumps(t['median_block'])}",
                  flush=True)
            print(f"  tail causes {t['tail_causes']}; releaser median "
                  f"{json.dumps(t['releaser_median'])}", flush=True)
            print(f"  stretch {r['stretch_wall_ms_a_block']:.3f} ms a block,"
                  f" stages {json.dumps(r['stretch_stage_ms'])}", flush=True)
            print(f"  trace {json.dumps(r['trace_gaps'])}", flush=True)
            for c in r["run_calls_stage_ms"]:
                if "prefetch_thread_cpu" in c:
                    print(f"  run(): prefetch thread CPU "
                          f"{c['prefetch_thread_cpu']:.3f} ms a block "
                          f"({c['cpu_source']}, step {c['cpu_step_ms']:g}"
                          f" ms) against read + quantize + pin+issue "
                          f"{c['prefetch_thread_wall']:.3f}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
