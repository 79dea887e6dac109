#!/usr/bin/env python3
"""Smoke test of the PyTorch port (pysdr_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py          # from the root of a checkout

Phases, each of which must pass (exit 1 on the first failure):
  1. device: a CUDA device is present; print its name and power limit.
  2. build: nvcc builds the hand-written kernels (csrc/scan.cu, sm_90a).
  3. kernels: each kernel against its plain torch twin on the card at the
     main path's shapes (linrec <= 1e-4 relative, sr_latch exact), with
     CUDA-event times of both (median of 20 runs).
  4. main path: `python -m pysdr_tpu_torch`'s entry point at the full
     width of the 4-RX bank (8 MHz, AM/NFM/USB/CW, 24576-sample audio
     blocks) from the synth source into wavs; every kernel launched, every
     RX's tone >= 40 dB over the spectral floor.
  5. replay: tests/fixtures/am_tones.dat reproduces its pinned outcome.
  6. CUDA vs CPU: the same bank on the card and on the CPU over identical
     blocks, per-RX audio SNR >= 60 dB; the card's step time per block,
     each step run under torch.cuda.set_sync_debug_mode("error") (it must
     not wait on the card), then torch.profiler's kernel time per step
     against the host's wall time.

The last line is {"ok": true, "device": {...}}; the line before it lists
the kernels with their launches, errors and times. Imports no JAX.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
import wave

ROOT = os.path.dirname(os.path.abspath(__file__))
BANK4 = ["--fs", "8", "--block", "24576",
         "--fc", "100.0", "100.5", "101.0", "101.5",
         "--modes", "AM", "NFM", "USB", "CW"]
KERNEL_SHAPES = {"linrec": [(4, 24576, 4), (4, 24576, 2), (4, 384, 1)],
                 "sr_latch": [(4, 24576)]}


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def phase(name):
    print(f"== {name}", flush=True)


def cuda_ms(fn, reps=20):
    """Median CUDA-event time of fn() in ms, after two warm-up calls."""
    import torch
    for _ in range(2):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def wav_peak(path, skip_frac=1 / 3):
    """(peak Hz, peak over the median spectral floor in dB) of channel 0."""
    import numpy as np
    with wave.open(path) as w:
        fr = w.getframerate()
        d = np.frombuffer(w.readframes(w.getnframes()), np.int16).reshape(
            -1, w.getnchannels())[:, 0].astype(np.float32)
    seg = d[int(len(d) * skip_frac):]
    sp = np.abs(np.fft.rfft(seg * np.hanning(len(seg))))
    frq = np.fft.rfftfreq(len(seg), 1.0 / fr)
    pk = 5 + int(np.argmax(sp[5:]))
    return float(frq[pk]), float(20 * np.log10(
        sp[pk] / max(np.median(sp[5:]), 1e-12)))


def kernel_phase(device):
    import numpy as np
    import torch

    from pysdr_tpu_torch.kernels import scan
    from pysdr_tpu_torch.ops import scanops

    rng = np.random.default_rng(0)
    out = {}
    for shape in KERNEL_SHAPES["linrec"]:
        a = torch.from_numpy(rng.uniform(0.9, 1.0, shape)
                             .astype(np.float32)).to(device)
        b = torch.from_numpy(rng.uniform(0.0, 1.0, shape)
                             .astype(np.float32)).to(device)
        yp = torch.from_numpy(rng.uniform(0.0, 1.0, (shape[0], shape[2]))
                              .astype(np.float32)).to(device)
        y, last = scan.linrec(a, b, yp)
        y_ref, l_ref = scanops.linrec_ref(a, b, yp)
        torch.cuda.synchronize()
        err = max((y - y_ref).abs().max().item(),
                  (last - l_ref).abs().max().item())
        rel = err / y_ref.abs().max().item()
        ms = cuda_ms(lambda: scan.linrec(a, b, yp))
        plain = cuda_ms(lambda: scanops.linrec_ref(a, b, yp))
        print(f"linrec {shape}: max_abs_err {err:.3e} rel {rel:.3e}  "
              f"kernel {ms:.4f} ms  plain {plain:.4f} ms", flush=True)
        # f32 reassociation over 24576 steps: a different summation order
        check(rel <= 1e-4, f"linrec {shape} rel err {rel:.3e} > 1e-4")
        out.setdefault("linrec", []).append((shape, err, ms, plain))
    for shape in KERNEL_SHAPES["sr_latch"]:
        s = torch.from_numpy(rng.random(shape) < 0.01).to(device)
        r = torch.from_numpy(rng.random(shape) < 0.01).to(device)
        gp = torch.from_numpy((rng.random(shape[0]) < 0.5)
                              .astype(np.float32)).to(device)
        g, last = scan.sr_latch(s, r, gp)
        g_ref, l_ref = scanops.sr_latch_ref(s, r, gp)
        torch.cuda.synchronize()
        err = max((g - g_ref).abs().max().item(),
                  (last - l_ref).abs().max().item())
        ms = cuda_ms(lambda: scan.sr_latch(s, r, gp))
        plain = cuda_ms(lambda: scanops.sr_latch_ref(s, r, gp))
        print(f"sr_latch {shape}: max_abs_err {err:.3e}  kernel {ms:.4f} ms"
              f"  plain {plain:.4f} ms", flush=True)
        check(err == 0.0, f"sr_latch {shape} differs from its plain twin")
        out.setdefault("sr_latch", []).append((shape, err, ms, plain))
    return out


def main_path_phase(tmp):
    import torch

    from pysdr_tpu_torch import app, kernels

    prefix = os.path.join(tmp, "bank4")
    argv = ["--device", "cuda", *BANK4, "--wire", "i8", "--audio-wire",
            "i16", "--blocks", "8", "--wav", prefix, "--profile"]
    print("argv: " + " ".join(argv), flush=True)
    kernels.reset_launch_counts()
    rc, a = app.run_cli(argv)
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    check(rc == 0 and a is not None, f"main path exited {rc}")
    print(f"launches: {launches}", flush=True)
    print(f"stage_report ms/block: {a.ex.stage_report()}", flush=True)
    for name, n in launches.items():
        check(n > 0, f"kernel {name} never launched on the main path")
    bank = a.bank
    tensors = [*bank.buffers(), bank.state.hist, bank.state.ch.nco_phase,
               bank.state.ch.demod.agc_env, bank.params.nco_k]
    check(all(t.device.type == "cuda" for t in tensors),
          "bank buffers/state not on cuda")
    # the synth puts a 400*(i+1) Hz tone on RX i; CW beats its carrier
    # down to the RX's own BFO offset
    expect = {"AM": 400.0, "NFM": 800.0, "USB": 1200.0}
    for i, rc_i in enumerate(a.cfg.receivers):
        pk, db = wav_peak(f"{prefix}_rx{i}.wav")
        want = (rc_i.bfo_hz if rc_i.mode.name == "CW"
                else expect[rc_i.mode.name])
        print(f"rx{i} {rc_i.mode.name}: peak {pk:.2f} Hz (want {want}), "
              f"{db:.1f} dB over floor", flush=True)
        check(abs(pk - want) <= 5.0 and db >= 40.0,
              f"rx{i}: peak {pk} Hz / {db:.1f} dB")
    return launches, a


def replay_phase(tmp):
    from pysdr_tpu_torch import app

    prefix = os.path.join(tmp, "am")
    rc, _ = app.run_cli([
        "--device", "cuda", "--replay",
        os.path.join(ROOT, "tests", "fixtures", "am_tones.dat"),
        "--no-loop", "--fc", "100.0", "100.04", "--mode", "AM",
        "--video-bw", "8", "--block", "4096", "--wav", prefix])
    check(rc == 0, f"replay exited {rc}")
    for i, want in enumerate((400.0, 800.0)):
        pk, db = wav_peak(f"{prefix}_rx{i}.wav")
        print(f"am_tones rx{i}: peak {pk:.2f} Hz (want {want}), "
              f"{db:.1f} dB over floor", flush=True)
        check(abs(pk - want) < 10.0 and db >= 40.0,
              f"am_tones rx{i}: {pk} Hz / {db:.1f} dB")


def cuda_vs_cpu_phase():
    import numpy as np
    import torch

    from pysdr_tpu_torch import app
    from pysdr_tpu_torch.models.receiver import ReceiverBank

    args = app.build_parser().parse_args(BANK4)
    cfg = app.build_config(args)
    src, _, _ = app.build_source(args, cfg)
    gpu = ReceiverBank(cfg, device="cuda")
    cpu = ReceiverBank(cfg, device="cpu")
    n = gpu.design.in_block
    blocks = [np.asarray(src.read_data(n), np.complex64) for _ in range(8)]
    step_ms = []
    for i, x in enumerate(blocks):
        xb = gpu.to_device_block(x)
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        # the step must not wait on the card: any blocking copy or
        # stream sync inside it raises here
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = gpu.step_device(xb)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        b.record()
        b.synchronize()
        step_ms.append(a.elapsed_time(b))
        if i < 3:
            ag, ac = gpu.audio_from_wire(out), cpu.step(x)
            for r in range(gpu.n_rx):
                err = np.mean(np.abs(ag[r] - ac[r]) ** 2)
                snr = -10 * np.log10(max(
                    err / max(np.mean(np.abs(ac[r]) ** 2), 1e-30), 1e-30))
                print(f"block {i} rx{r}: cuda vs cpu audio SNR "
                      f"{snr:.1f} dB", flush=True)
                # cuFFT/cuBLAS/scan summation order differs from the
                # CPU's, and AGC gain and the discriminator amplify it
                check(snr >= 60.0, f"block {i} rx{r}: {snr:.1f} dB < 60")
    med = statistics.median(step_ms[2:])
    print(f"bank4 step ms per block (CUDA events): "
          f"{[round(t, 3) for t in step_ms]}; median of blocks 3-8 "
          f"{med:.3f} ms = {n / med / 1e3:.1f} Msamp/s device-only",
          flush=True)

    # where the step's time goes: kernel time against host wall time
    xbs = [gpu.to_device_block(x) for x in blocks[2:]]
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for xb in xbs:
            gpu.step_device(xb)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / len(xbs)
    ka = prof.key_averages()
    print(ka.table(sort_by="device_time_total", row_limit=12), flush=True)
    # kernels only: an aten op's self device time repeats its kernels'
    kern = [e for e in ka
            if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kern) / len(xbs) / 1e3
    n_kern = sum(e.count for e in kern) / len(xbs)
    print(f"profiled step ({len(xbs)} steps): {n_kern:.0f} kernels, "
          f"device busy {busy_ms:.3f} ms, host wall {wall * 1e3:.3f} ms, "
          f"device idle share {max(0.0, 1 - busy_ms / 1e3 / wall):.3f}",
          flush=True)
    return med


def run():
    try:
        import torch
    except ImportError:
        raise SmokeFailure("torch is not installed")
    check(torch.cuda.is_available(), "torch.cuda.is_available() is False")
    check(os.path.isdir(os.path.join(ROOT, "pysdr_tpu_torch")),
          f"no pysdr_tpu_torch package beside {__file__}: run from a "
          "checkout of the repository")
    sys.path.insert(0, ROOT)
    from pysdr_tpu_torch import kernels
    from pysdr_tpu_torch.device import resolve_device
    from pysdr_tpu_torch.kernels import build

    t_all = time.perf_counter()
    phase("1 device")
    device = resolve_device("cuda")
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {kind} count {torch.cuda.device_count()}")
    print(smi.stdout.strip().splitlines()[0], flush=True)

    phase("2 build")
    t0 = time.perf_counter()
    build.library()
    print(f"kernel library ready in {time.perf_counter() - t0:.2f} s "
          f"(nvcc {build.build_seconds} s)", flush=True)

    phase("3 kernels vs plain")
    kres = kernel_phase(device)

    with tempfile.TemporaryDirectory() as tmp:
        phase("4 main path")
        launches, _ = main_path_phase(tmp)
        phase("5 replay")
        replay_phase(tmp)
    phase("6 cuda vs cpu")
    cuda_vs_cpu_phase()

    rows = []
    for fn, source, replaces in kernels.KERNELS:
        res = kres[fn.__name__]
        main = res[0]        # the largest main-path shape
        rows.append({"name": fn.__name__, "route": "cuda", "source": source,
                     "replaces": replaces, "launches": launches[fn.__name__],
                     "max_abs_err": max(r[1] for r in res),
                     "ms": main[2], "plain_ms": main[3]})
    print(f"total {time.perf_counter() - t_all:.1f} s", flush=True)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    try:
        run()
    except SmokeFailure as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr, flush=True)
        sys.exit(1)
