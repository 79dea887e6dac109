#!/usr/bin/env python3
"""Smoke test of the PyTorch port (pysdr_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py          # from the root of a checkout

Phases, each of which must pass (exit 1 on the first failure):
  1. device: a CUDA device is present; print its name and power limit.
  2. build: nvcc builds the hand-written kernels (csrc/*.cu, sm_90a).
  3. kernels: each kernel against its plain torch twin on the card at the
     main paths' shapes (linrec <= 1e-4 relative, with `a` as the main
     path gives it, and at edge shapes around its tile; sr_latch exact,
     also across runs of tiles with no command; pfb_branch <= 1e-5
     relative on the i8 and f32 wires; rtty_scores' soft bits bit-equal
     and its scores <= 1e-4 absolute at the 100-channel decoder's (F,
     nfft, C, T) with and without a soft tail and at one channel), with
     CUDA-event times of both (median of 20), each kernel's device time
     alone (torch.profiler) beside its bound, and a depthwise F.conv1d
     timed beside pfb_branch as its library yardstick.
  4. bank4 path: `python -m pysdr_tpu_torch`'s entry point at the full
     width of the 4-RX bank (8 MHz, AM/NFM/USB/CW, 24576-sample audio
     blocks) from the synth source into wavs; its kernels (the scans)
     launched, every RX's tone >= 40 dB over the spectral floor.
  5. replay: tests/fixtures/am_tones.dat reproduces its pinned outcome.
  6. bank4 CUDA vs CPU: the same bank on the card and on the CPU over
     identical blocks, per-RX audio SNR >= 60 dB; the card's step time
     per block, each step run under torch.cuda.set_sync_debug_mode
     ("error") (it must not wait on the card), then torch.profiler's
     kernel time per step against the host's wall time.
  7. chan64 path: the entry point with the 64-channel channelizer bank
     (12.288 MHz in 64 x 192 kHz channels, 12288-sample audio blocks, i8
     RF and mu-law i8 audio wires, squelch 10 dB, PSD + PNG export) from
     the synth source; its kernels (the scans, pfb_branch) launched; the
     channels that carry a station show its 300 + 50*i Hz tone >= 40 dB
     over the floor, an idle channel is squelched silent, RF.png and
     AF0.png parse; then the web viewer's /frame.json over a 3-block run
     shows 64 channels.
  8. chan64 CUDA vs CPU: as 6, for the channelizer bank (>= 60 dB on the
     channels that carry a station).
  9. rtty path: the entry point with examples/rtty_decode.sh's flags on
     tests/fixtures/rtty_cq.dat decodes "CQ" and "AA2IL"; then the
     100-station layout of tests/test_rtty.py (synthesized at 96 kHz,
     resampled to 2.048 MHz, 120 kHz off the file's center) replayed
     from 0.75 s with --fs-out 96 --block 24576 --rtty 0: >= 90 of the
     100 STii strings in their own channel's text, rtty_scores launched
     once on every block with channels, and the decoder's wall ms per
     block against the block's 256 ms; then bank4 for 2 blocks with
     --save-iq --save-baseband --save-demod, each .dat parsed back.

The last line is {"ok": true, "device": {...}}; the line before it lists
the kernels with their launches summed over the paths' runs (phases 4, 7
and 9, each with the counts set to 0 before it), their largest error
over phase 3's shapes, and at their first shape there their times, bound
and library time (or null). Imports no JAX, and of this repository only
pysdr_tpu_torch, which imports neither: the run fails if any jax or
pysdr_tpu module was loaded.
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
CHAN64 = ["--channelize", "64", "--fs", "12.288", "--fc", "100.0",
          "--block", "12288", "--wire", "i8", "--audio-wire", "i8",
          "--squelch", "10"]
RTTY = ["--no-loop", "--fc", "100.0", "--mode", "RTTY", "--rtty", "0"]
# the first shape of each kernel is the one its kernels-line times are
# taken at: chan64's for the scans and the PFB, then bank4's (and
# pfb_branch on the f32 wire); linrec's `a` as the main path gives it (a
# per-column constant at stride 0 along n for the 4- and 2-column passes,
# a python scalar for the AGC), then edge shapes around its 512-sample
# tile with a dense `a`; the latch's edge shapes, "quiet" with commands
# only near a row's ends; rtty_scores' (F, nfft, C, T) are the
# 100-channel decoder's at 96 kHz without and with its soft tail, and
# one channel
KERNEL_SHAPES = {"linrec": [(64, 12288, 4, "columns"), (64, 12288, 2, "columns"),
                            (64, 192, 1, "scalar"), (4, 24576, 4, "columns"),
                            (4, 24576, 2, "columns"), (4, 384, 1, "scalar"),
                            (3, 511, 4, "dense"), (3, 512, 2, "dense"),
                            (3, 513, 1, "dense"), (2, 1, 4, "columns"),
                            (2, 200000, 4, "dense")],
                 "sr_latch": [(64, 12288, ""), (4, 24576, ""), (3, 511, ""),
                              (3, 512, ""), (3, 513, ""), (2, 1, ""),
                              (2, 200000, "quiet")],
                 "pfb_branch": [(49152, 64, 12, "i8"),
                                (49152, 64, 12, "f32")],
                 "rtty_scores": [(43, 4096, 100, 64), (43, 4096, 100, 0),
                                 (43, 4096, 1, 64)]}
# the least time the card could take: H100 SXM HBM3 at its 700 W limit,
# float32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
BANK4_KERNELS = ("linrec", "sr_latch")
CHAN64_KERNELS = ("linrec", "sr_latch", "pfb_branch")
# the 100-station layout of tests/test_rtty.py: station i at
# (i - 50) * 460 + 137 Hz sending "RYRY STii STii"
RTTY_STATIONS = 100
RTTY_FS = 96e3
RTTY_BLOCK = 24576                     # 256 ms of baseband a block
RTTY_UP, RTTY_DOWN = 64, 3             # 96 kHz -> an RTL rate, 2.048 MHz
RTTY_SHIFT = 120e3                     # the RX's offset from the center


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


def device_us(fn, name, reps=20, tries=5):
    """Mean device time in us of the kernel `{name}_kernel` over reps
    calls of fn(), from torch.profiler (no host cost). The profiler now
    and then drops a short window's kernels, or records them with no
    time: such a window is taken again, up to `tries` times."""
    import torch
    for _ in range(tries):
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU,
                            torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        ev = [e for e in prof.key_averages() if f"{name}_kernel" in e.key
              and e.device_type == torch.autograd.DeviceType.CUDA]
        us = (sum(e.self_device_time_total for e in ev)
              / max(1, sum(e.count for e in ev)))
        if us > 0:
            return us
    raise SmokeFailure(f"torch.profiler recorded no device time of "
                       f"{name}_kernel in {tries} windows")


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


def bound(n_bytes, n_ops):
    """(least ms, "bytes" or "operations"): the larger of the bytes over
    the memory rate and the operations over the float32 rate."""
    tb, to = n_bytes / HBM_BYTES_PER_S, n_ops / F32_OPS_PER_S
    return max(tb, to) * 1e3, ("bytes" if tb >= to else "operations")


def record(out, name, shape, err, ms, plain, us, bnd, lib_ms=None):
    """One phase-3 result; prints the kernel's device time beside its
    bound."""
    print(f"{name} {shape}: max_abs_err {err:.3e}  kernel {ms:.4f} ms  "
          f"plain {plain:.4f} ms  device {us:.3f} us  bound "
          f"{bnd[0] * 1e3:.3f} us ({bnd[1]})"
          + ("" if lib_ms is None else f"  library {lib_ms:.4f} ms"),
          flush=True)
    out.setdefault(name, []).append({
        "shape": shape, "err": err, "ms": ms, "plain_ms": plain,
        "device_us": us, "bound_ms": bnd[0], "bound_by": bnd[1],
        "library_ms": lib_ms})


def kernel_phase(device):
    import numpy as np
    import torch
    import torch.nn.functional as F

    from pysdr_tpu_torch.kernels import scan
    from pysdr_tpu_torch.ops import scanops

    rng = np.random.default_rng(0)
    out = {}
    for bn, n, k, kind in KERNEL_SHAPES["linrec"]:
        shape = (bn, n, k)
        b = torch.from_numpy(rng.uniform(0.0, 1.0, shape)
                             .astype(np.float32)).to(device)
        yp = torch.from_numpy(rng.uniform(0.0, 1.0, (bn, k))
                              .astype(np.float32)).to(device)
        if kind == "scalar":
            a, a_ref, a_bytes = 0.9921875, torch.full_like(b, 0.9921875), 0
        elif kind == "columns":
            a = torch.from_numpy(rng.uniform(0.9, 1.0, k).astype(np.float32)) \
                .to(device).expand(shape)
            a_ref, a_bytes = a, 4 * k
        else:
            a = torch.from_numpy(rng.uniform(0.9, 1.0, shape)
                                 .astype(np.float32)).to(device)
            a_ref, a_bytes = a, a.numel() * 4
        y, last = scan.linrec(a, b, yp)
        y_ref, l_ref = scanops.linrec_ref(a_ref, b, yp)
        torch.cuda.synchronize()
        err = max((y - y_ref).abs().max().item(),
                  (last - l_ref).abs().max().item())
        rel = err / y_ref.abs().max().item()
        ms = cuda_ms(lambda: scan.linrec(a, b, yp))
        plain = cuda_ms(lambda: scanops.linrec_ref(a_ref, b, yp))
        us = device_us(lambda: scan.linrec(a, b, yp), "linrec")
        # b in, y out, y_prev in, y_last out; one multiply-add a sample
        bnd = bound(8 * b.numel() + 8 * yp.numel() + a_bytes,
                    2 * b.numel())
        record(out, "linrec", shape + (kind,), err, ms, plain, us, bnd)
        print(f"  rel {rel:.3e}", flush=True)
        # f32 reassociation over up to 2e5 steps: a different order
        check(rel <= 1e-4, f"linrec {shape} {kind} rel err {rel:.3e} > 1e-4")
    for bn, n, kind in KERNEL_SHAPES["sr_latch"]:
        shape = (bn, n)
        s = rng.random(shape) < 0.01
        r = rng.random(shape) < 0.01
        if kind == "quiet":
            s[:, 37:-5] = r[:, 37:-5] = False
            s[0] = r[0] = False
        s, r = (torch.from_numpy(x).to(device) for x in (s, r))
        gp = torch.from_numpy((rng.random(bn) < 0.5)
                              .astype(np.float32)).to(device)
        g, last = scan.sr_latch(s, r, gp)
        g_ref, l_ref = scanops.sr_latch_ref(s, r, gp)
        torch.cuda.synchronize()
        err = max((g - g_ref).abs().max().item(),
                  (last - l_ref).abs().max().item())
        ms = cuda_ms(lambda: scan.sr_latch(s, r, gp))
        plain = cuda_ms(lambda: scanops.sr_latch_ref(s, r, gp))
        us = device_us(lambda: scan.sr_latch(s, r, gp), "sr_latch")
        # two command bytes in, a float gate out, g_prev and gate_last
        bnd = bound(6 * s.numel() + 8 * bn, s.numel())
        record(out, "sr_latch", shape + ((kind,) if kind else ()), err, ms,
               plain, us, bnd)
        check(err == 0.0, f"sr_latch {shape} differs from its plain twin")
    from pysdr_tpu_torch.kernels import pfb
    from pysdr_tpu_torch.ops import channelizer, cplx
    for m, nch, k, wire in KERNEL_SHAPES["pfb_branch"]:
        design = channelizer.ChannelizerDesign(fs_in=12.288e6,
                                               n_channels=nch,
                                               taps_per_branch=k)
        taps = torch.from_numpy(channelizer.pack_branch_weights(
            design.prototype(), nch)).to(device)
        x = rng.uniform(-1.0, 1.0, (m * nch, 2)).astype(np.float32)
        xw = torch.from_numpy(cplx.quantize_host(x, wire)).to(device)
        hist = torch.from_numpy(
            (rng.standard_normal((k - 1) * nch) + 1j
             * rng.standard_normal((k - 1) * nch)).astype(np.complex64)
        ).to(device)
        xc = torch.view_as_complex(cplx.dequantize(xw).contiguous())
        v, nh = pfb.pfb_branch(xw, hist, taps)
        v_ref, nh_ref = channelizer.branch_filter_ref(xc, hist, taps)
        torch.cuda.synchronize()
        err = (v - v_ref).abs().max().item()
        rel = err / v_ref.abs().max().item()
        ms = cuda_ms(lambda: pfb.pfb_branch(xw, hist, taps))
        # the twin with the dequantize the kernel does in its load
        plain = cuda_ms(lambda: channelizer.branch_filter_ref(
            torch.view_as_complex(cplx.dequantize(xw).contiguous()), hist,
            taps))
        us = device_us(lambda: pfb.pfb_branch(xw, hist, taps), "pfb_branch")
        # the library's yardstick, which the port never calls: the same
        # filter as a depthwise convolution, one channel per branch and
        # re/im, over [hist | x] laid out channels-first beforehand
        xp = torch.view_as_real(torch.cat([hist, xc])).reshape(-1, nch, 2)
        x_cf = xp.permute(1, 2, 0).reshape(1, 2 * nch, -1).contiguous()
        w = taps.flip(1).repeat_interleave(2, 0)[:, None, :].contiguous()
        conv = F.conv1d(x_cf, w, groups=2 * nch)
        v_conv = torch.complex(conv[0, 0::2], conv[0, 1::2]).t()
        torch.cuda.synchronize()
        conv_err = (v_conv - v_ref).abs().max().item()
        lib_ms = cuda_ms(lambda: F.conv1d(x_cf, w, groups=2 * nch))
        # wire in, hist and taps in, v and the new hist out; a complex
        # by real multiply-add (4 operations) per tap and output
        bnd = bound(xw.numel() * xw.element_size() + 2 * hist.numel() * 8
                    + taps.numel() * 4 + v.numel() * 8,
                    4 * v.numel() * k)
        shape = (m, nch, k)
        record(out, "pfb_branch", shape + (wire,), err, ms, plain, us, bnd,
               lib_ms)
        print(f"  rel {rel:.3e}; F.conv1d (groups {2 * nch}) max_abs_err "
              f"{conv_err:.3e} against the twin", flush=True)
        # fused multiply-adds against separate ones, 12 terms
        check(rel <= 1e-5, f"pfb_branch {shape} {wire} rel err {rel:.3e}")
        check(torch.equal(nh, nh_ref), f"pfb_branch {shape} {wire}: new "
              "history differs from its plain twin")
        check(conv_err <= 1e-4 * v_ref.abs().max().item(),
              f"F.conv1d yardstick computes another function ({conv_err})")
    from pysdr_tpu_torch.kernels import rtty as krtty
    from pysdr_tpu_torch.models import rtty
    design = rtty.RTTYDesign(fs=RTTY_FS)
    tmpl = torch.from_numpy(rtty.char_templates(design)).to(device)
    for f, nfft, nch, t_rows in KERNEL_SHAPES["rtty_scores"]:
        mags = torch.from_numpy(rng.uniform(0.0, 3.0, (f, nfft))
                                .astype(np.float32)).to(device)
        mark = rng.integers(0, nfft, nch).astype(np.int32)
        mark[0] = 2                    # its space bin wraps below 0
        space = (mark - design.shift_bins) % nfft
        bins = len(np.unique(np.concatenate([mark, space])))
        mark, space = (torch.from_numpy(b.astype(np.int32)).to(device)
                       for b in (mark, space))
        tail = torch.from_numpy(rng.uniform(-1.0, 1.0, (t_rows, nch))
                                .astype(np.float32)).to(device)
        args = (mags, mark, space, tail, tmpl)
        soft, sc = krtty.rtty_scores(*args)
        soft_ref, sc_ref = rtty.rtty_scores_ref(*args)
        torch.cuda.synchronize()
        shape = (f, nfft, nch, t_rows)
        # the same IEEE operations in the same order: bit for bit
        check(torch.equal(soft, soft_ref), f"rtty_scores {shape}: soft "
              "bits differ from the plain twin's")
        err = (sc - sc_ref).abs().max().item()
        ms = cuda_ms(lambda: krtty.rtty_scores(*args))
        plain = cuda_ms(lambda: rtty.rtty_scores_ref(*args))
        us = device_us(lambda: krtty.rtty_scores(*args), "rtty_scores")
        # the magnitudes of the mark/space bins this data reads, the bins,
        # the tail, the templates in; soft rows and scores out; 3
        # operations a soft bit, a multiply-add per template tap and score
        bnd = bound(4 * f * bins + 8 * nch + 4 * tail.numel()
                    + 4 * tmpl.numel() + 4 * soft.numel() + 4 * sc.numel(),
                    3 * f * nch + 2 * sc.numel() * tmpl.shape[1])
        record(out, "rtty_scores", shape, err, ms, plain, us, bnd)
        # 32 fused multiply-adds of terms <= 1 against the twin's matmul
        check(err <= 1e-4, f"rtty_scores {shape} scores err {err:.3e}")
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
    for name in BANK4_KERNELS:
        check(launches[name] > 0, f"kernel {name} never launched on the "
              "bank4 path")
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
    xbs = [gpu.to_device_block(x) for x in blocks]
    outs, step_ms = timed_steps(gpu, xbs)
    for i, x in enumerate(blocks[:3]):
        ag, ac = gpu.audio_from_wire(outs[i]), cpu.step(x)
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
    profile_steps(gpu, xbs[2:])
    return med


def png_size(path):
    """(width, height) of a PNG file; fails if it does not parse."""
    with open(path, "rb") as f:
        data = f.read()
    check(data[:8] == b"\x89PNG\r\n\x1a\n" and data[12:16] == b"IHDR",
          f"{path} is not a PNG")
    return (int.from_bytes(data[16:20], "big"),
            int.from_bytes(data[20:24], "big"))


def chan64_phase(tmp):
    import numpy as np
    import torch

    from pysdr_tpu_torch import app, kernels

    prefix = os.path.join(tmp, "chan64")
    png = os.path.join(tmp, "png")
    argv = ["--device", "cuda", *CHAN64, "--blocks", "8", "--wav", prefix,
            "--psd", "--psd-every", "2", "--png-dir", png, "--profile"]
    print("argv: " + " ".join(argv), flush=True)
    kernels.reset_launch_counts()
    rc, a = app.run_cli(argv)
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    check(rc == 0 and a is not None, f"chan64 path exited {rc}")
    print(f"launches: {launches}", flush=True)
    print(f"stage_report ms/block: {a.ex.stage_report()}", flush=True)
    for name in CHAN64_KERNELS:
        check(launches[name] > 0, f"kernel {name} never launched on the "
              "chan64 path")
    bank = a.bank
    tensors = [*bank.buffers(), bank.state.chan_hist, bank.state.rs_hist,
               bank.state.demod.agc_env, bank.params.nco_k]
    check(all(t.device.type == "cuda" for t in tensors),
          "chan64 bank buffers/state not on cuda")
    # the synth puts an AM station with a 300 + 50*i Hz tone on every
    # 4th channel center
    for i in (0, 4, 8, 12, 60):
        pk, db = wav_peak(f"{prefix}_rx{i}.wav")
        want = 300.0 + 50.0 * i
        print(f"ch{i}: peak {pk:.2f} Hz (want {want}), {db:.1f} dB over "
              "floor", flush=True)
        check(abs(pk - want) <= 5.0 and db >= 40.0,
              f"ch{i}: peak {pk} Hz / {db:.1f} dB")
    for i in (1, 2):
        with wave.open(f"{prefix}_rx{i}.wav") as w:
            d = np.frombuffer(w.readframes(w.getnframes()), np.int16)
        tail = np.abs(d[len(d) // 2:].astype(np.int32)).max()
        print(f"ch{i} (idle, squelch 10 dB): max |sample| over the last "
              f"half {tail}", flush=True)
        check(tail == 0, f"idle ch{i} is not squelched: {tail}")
    for tag in ("RF", "AF0"):
        w, h = png_size(os.path.join(png, f"{tag}.png"))
        print(f"{tag}.png {w}x{h}", flush=True)
        check(w >= 256 and h >= 1, f"{tag}.png is {w}x{h}")

    import json as _json
    import urllib.request
    args = app.build_parser().parse_args(
        ["--device", "cuda", *CHAN64, "--web", "0", "--psd-every", "1"])
    web_app = app.App(args)
    web_app.start_services()
    try:
        web_app.ex.run(n_blocks=3)
        with urllib.request.urlopen(
                f"http://127.0.0.1:{web_app.web.port}/frame.json",
                timeout=30) as r:
            fr = _json.loads(r.read())
    finally:
        web_app.stop_services()
    print(f"/frame.json: ok {fr.get('ok')} n_rx {fr.get('n_rx')} rf rows "
          f"{fr.get('rf', {}).get('rows')}", flush=True)
    check(fr.get("ok") and fr.get("n_rx") == 64 and len(fr["rx"]) == 64,
          f"/frame.json: ok {fr.get('ok')} n_rx {fr.get('n_rx')}")
    return launches


def profile_steps(bank, xbs):
    """torch.profiler over bank.step_device on each block: kernels per
    step, device busy ms per step, host wall ms, device idle share."""
    import torch
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for xb in xbs:
            bank.step_device(xb)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / len(xbs)
    ka = prof.key_averages()
    print(ka.table(sort_by="device_time_total", row_limit=12), flush=True)
    # kernels only: an aten op's self device time repeats its kernels'
    kern = [e for e in ka
            if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kern) / len(xbs) / 1e3
    n_kern = sum(e.count for e in kern) / len(xbs)
    # the hand-written kernels' own device time, without the wrapper's
    # host cost that phase 3's events include
    for e in kern:
        name = next((k for k in ("pfb_branch", "linrec", "sr_latch")
                     if f"{k}_kernel" in e.key), None)
        if name:
            print(f"  {name} kernel: {e.count} launches, device "
                  f"{e.self_device_time_total / e.count:.3f} us each",
                  flush=True)
    print(f"profiled step ({len(xbs)} steps): {n_kern:.0f} kernels, "
          f"device busy {busy_ms:.3f} ms, host wall {wall * 1e3:.3f} ms, "
          f"device idle share {max(0.0, 1 - busy_ms / 1e3 / wall):.3f}",
          flush=True)


def timed_steps(bank, xbs):
    """CUDA-event time of bank.step_device per block, each step under
    sync debug mode "error" (any blocking copy or stream sync inside it
    raises). Returns (outputs, ms per step)."""
    import torch
    outs, step_ms = [], []
    for xb in xbs:
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        torch.cuda.set_sync_debug_mode("error")
        try:
            outs.append(bank.step_device(xb))
        finally:
            torch.cuda.set_sync_debug_mode(0)
        b.record()
        b.synchronize()
        step_ms.append(a.elapsed_time(b))
    return outs, step_ms


def chan64_cuda_vs_cpu_phase():
    import numpy as np
    import torch

    from pysdr_tpu_torch import app
    from pysdr_tpu_torch.models.channelizer_bank import ChannelizerBank
    from pysdr_tpu_torch.ops import cplx

    args = app.build_parser().parse_args(
        ["--device", "cuda", *CHAN64, "--audio-wire", "f32"])
    gpu, src, cfg = app.build_channelizer(args)
    cpu = ChannelizerBank(cfg, device="cpu")
    n = gpu.design.in_block
    wires = [cplx.quantize_host(
        np.asarray(src.read_data(n), np.complex64).view(np.float32)
        .reshape(-1, 2), "i8") for _ in range(4)]
    xbs = [torch.from_numpy(w).to("cuda") for w in wires]
    # 8 timed steps over the 4 blocks; the first 3 also against the CPU
    outs, step_ms = timed_steps(gpu, xbs + xbs)
    for i in range(3):
        ag = gpu.audio_from_wire(outs[i])
        ac = cpu.audio_from_wire(cpu.step_device(torch.from_numpy(wires[i])))
        snrs = []
        for c in range(0, 64, 4):
            err = np.mean(np.abs(ag[c] - ac[c]) ** 2)
            snrs.append(-10 * np.log10(max(
                err / max(np.mean(np.abs(ac[c]) ** 2), 1e-30), 1e-30)))
        print(f"block {i}: cuda vs cpu audio SNR on the 16 station "
              f"channels min {min(snrs):.1f} max {max(snrs):.1f} dB",
              flush=True)
        # cuFFT/cuBLAS/kernel summation orders differ from the CPU's,
        # and the AGC and squelch gain amplify them
        check(min(snrs) >= 60.0, f"block {i}: {min(snrs):.1f} dB < 60")
    med = statistics.median(step_ms[2:])
    print(f"chan64 step ms per block (CUDA events): "
          f"{[round(t, 3) for t in step_ms]}; median of blocks 3-8 "
          f"{med:.3f} ms = {n / med / 1e3:.1f} Msamp/s device-only",
          flush=True)
    profile_steps(gpu, xbs)
    return med


def rtty_composite(path):
    """Write the 100-station layout as an RF capture: synthesized at 96
    kHz, resampled to 2.048 MHz, shifted up by RTTY_SHIFT and saved with
    its center RTTY_SHIFT below 100 MHz, so an RX at 100.0 MHz sits
    RTTY_SHIFT off the file's center (as in tests/test_app.py). Returns
    the stations' baseband carriers in Hz."""
    import numpy as np
    from scipy import signal

    from pysdr_tpu_torch.io import datfile
    from pysdr_tpu_torch.models import rtty

    design = rtty.RTTYDesign(fs=RTTY_FS)
    carriers = (np.arange(RTTY_STATIONS) - 50) * 460.0 + 137.0
    x = None
    for i, c in enumerate(carriers):
        # 1/100 of full scale each, so the sum stays inside +-1
        xi = rtty.synthesize_rtty(f"RYRY ST{i:02d} ST{i:02d}", design,
                                  carrier_hz=c, amplitude=0.01)
        x = xi.astype(np.complex128) if x is None else x + xi[:len(x)]
    fs_rf = RTTY_FS * RTTY_UP / RTTY_DOWN
    y = signal.resample_poly(x, RTTY_UP, RTTY_DOWN)
    y *= np.exp(2j * np.pi * RTTY_SHIFT / fs_rf * np.arange(len(y)))
    w = datfile.DatWriter(path, fs=fs_rf, fc=100e6 - RTTY_SHIFT)
    w.save_data(y.astype(np.complex64))
    w.close()
    return carriers


def station_of(design, mark_bin, carriers):
    """The station whose mark tone (carrier + shift/2) is nearest the
    channel's mark bin."""
    import numpy as np
    f = mark_bin * design.bin_hz
    if mark_bin >= design.nfft // 2:
        f -= design.fs
    return int(np.argmin(np.abs(carriers + design.shift_hz / 2 - f)))


def run_timed_rtty(argv):
    """app.run_cli(argv) with each RTTYDecoder.decode_block call timed on
    the host's clock; the scores sync to the host inside the call, so its
    wall time covers the device work. Returns (rc, app, calls) with one
    (ms, channels after the call, rtty_scores launches) per call."""
    from pysdr_tpu_torch import app
    from pysdr_tpu_torch.kernels import rtty as krtty
    from pysdr_tpu_torch.models import rtty

    calls = []
    orig = rtty.RTTYDecoder.decode_block

    def timed(self, x):
        n0 = krtty.rtty_scores.launches
        t0 = time.perf_counter()
        out = orig(self, x)
        calls.append(((time.perf_counter() - t0) * 1e3, len(self.channels),
                      krtty.rtty_scores.launches - n0))
        return out
    rtty.RTTYDecoder.decode_block = timed
    try:
        rc, a = app.run_cli(argv)
    finally:
        rtty.RTTYDecoder.decode_block = orig
    return rc, a, calls


def rtty_phase(tmp):
    """The RTTY path: the rtty_cq.dat corpus, the 100-station layout at
    full width, and the recording taps on bank4. Returns the launches of
    its three runs, summed."""
    import torch

    from pysdr_tpu_torch import kernels
    from pysdr_tpu_torch.io import datfile

    total = {}

    def drive(argv):
        print("argv: " + " ".join(argv), flush=True)
        kernels.reset_launch_counts()
        rc, a, calls = run_timed_rtty(argv)
        torch.cuda.synchronize()
        launches = kernels.launch_counts()
        print(f"launches: {launches}", flush=True)
        check(rc == 0 and a is not None, f"{argv} exited {rc}")
        for k, n in launches.items():
            total[k] = total.get(k, 0) + n
        return a, calls, launches

    a, calls, launches = drive([
        "--device", "cuda", "--replay",
        os.path.join(ROOT, "tests", "fixtures", "rtty_cq.dat"), *RTTY,
        "--block", "4096"])
    text = "".join(a.rtty_text)
    print(f"rtty_cq.dat: {text!r}", flush=True)
    check("CQ" in text and "AA2IL" in text, f"rtty_cq.dat decoded {text!r}")
    check(launches["rtty_scores"] > 0, "rtty_scores never launched on the "
          "corpus")

    path = os.path.join(tmp, "rtty100.dat")
    t0 = time.perf_counter()
    carriers = rtty_composite(path)
    print(f"wrote the {RTTY_STATIONS}-station capture at "
          f"{RTTY_FS * RTTY_UP / RTTY_DOWN / 1e6:.3f} MHz in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    a, calls, launches = drive([
        "--device", "cuda", "--replay", path, "0.75", *RTTY, "--fs-out",
        str(RTTY_FS / 1e3), "--block", str(RTTY_BLOCK)])
    print(f"stage_report ms/block: {a.ex.stage_report()}", flush=True)
    dec = a.rtty
    got = set()
    for ch in dec.channels:
        i = station_of(dec.design, ch["mark_bin"], carriers)
        if f"ST{i:02d}" in ch["text"]:
            got.add(i)
    print(f"{len(dec.channels)} channels; {len(got)} of {RTTY_STATIONS} "
          f"stations decoded their STii in their own channel; missing "
          f"{sorted(set(range(RTTY_STATIONS)) - set(got))}", flush=True)
    check(len(got) >= 90, f"only {len(got)} of {RTTY_STATIONS} stations "
          "decoded")
    with_ch = [c for c in calls if c[1] > 0]
    check(with_ch and all(c[2] == 1 for c in with_ch),
          f"rtty_scores did not launch once on every block with channels: "
          f"{[(c[1], c[2]) for c in calls]}")
    ms = [c[0] for c in calls]
    budget = RTTY_BLOCK / RTTY_FS * 1e3
    med = statistics.median(ms[1:]) if len(ms) > 1 else ms[0]
    print(f"decoder wall ms per block: {[round(t, 3) for t in ms]}; median "
          f"after the first {med:.3f} ms against a {budget:.0f} ms budget "
          f"= {budget / med:.1f}x real time, so {len(dec.channels)} "
          f"channels x {budget / med:.1f} = "
          f"{len(dec.channels) * budget / med:.0f} channel-decoders at real "
          "time", flush=True)

    prefix = os.path.join(tmp, "taps")
    a, _, _ = drive(["--device", "cuda", *BANK4, "--blocks", "2",
                     "--save-iq", "--save-baseband", "--save-demod",
                     "--save-dir", tmp, "--wav", prefix])
    d = a.bank.design
    for tag, fs, n, nch in (("raw_iq", d.fs_in, d.in_block, 1),
                            ("baseband", d.fs_out, d.out_block, a.bank.n_rx),
                            ("demod", d.fs_out, d.out_block, a.bank.n_rx)):
        names = [f for f in os.listdir(tmp) if f.startswith(tag)]
        check(len(names) == 1, f"{tag}: files {names}")
        r = datfile.DatReader(os.path.join(tmp, names[0]))
        x = r.read_data()
        r.close()
        print(f"{tag}: {r.header.tag} fs {r.header.fs} nchan "
              f"{r.header.nchan} shape {x.shape}", flush=True)
        check(r.header.fs == fs and r.header.nchan == nch
              and len(x) == 2 * n, f"{tag}: fs {r.header.fs} nchan "
              f"{r.header.nchan} {x.shape}, want 2 x {n} at {fs}")
        check(bool(abs(x).max() > 0), f"{tag} is all zeros")
    return total


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
    print(build.build_log.strip(), flush=True)

    phase("3 kernels vs plain")
    kres = kernel_phase(device)

    launches = {}

    def add(counts):
        for k, n in counts.items():
            launches[k] = launches.get(k, 0) + n

    with tempfile.TemporaryDirectory() as tmp:
        phase("4 bank4 path")
        add(main_path_phase(tmp)[0])
        phase("5 replay")
        replay_phase(tmp)
    phase("6 bank4 cuda vs cpu")
    cuda_vs_cpu_phase()
    with tempfile.TemporaryDirectory() as tmp:
        phase("7 chan64 path")
        add(chan64_phase(tmp))
    phase("8 chan64 cuda vs cpu")
    chan64_cuda_vs_cpu_phase()
    with tempfile.TemporaryDirectory() as tmp:
        phase("9 rtty path")
        add(rtty_phase(tmp))

    # of this repository, only the port ran: no JAX, no pysdr_tpu module
    jaxish = sorted(m for m in sys.modules if m in ("jax", "pysdr_tpu")
                    or m.startswith(("jax.", "jaxlib", "pysdr_tpu.")))
    print(f"modules of jax or pysdr_tpu loaded: {jaxish}", flush=True)
    check(not jaxish, f"the run loaded {jaxish}")

    rows = []
    for fn, source, replaces in kernels.KERNELS:
        name = fn.__name__
        check(launches[name] > 0, f"kernel {name} launched on no path")
        res = kres[name]
        first = res[0]
        rows.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces, "launches": launches[name],
                     "max_abs_err": max(r["err"] for r in res),
                     "ms": first["ms"], "plain_ms": first["plain_ms"],
                     "bound_ms": first["bound_ms"],
                     "bound_by": first["bound_by"],
                     "library_ms": first["library_ms"],
                     "device_us": first["device_us"],
                     "bound_us": first["bound_ms"] * 1e3})
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
