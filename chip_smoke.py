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
     relative and its new history exact on the i8, i16 and f32 wires at
     chan64's (M, N, K), and at edge shapes: one row short of and past
     its 128-row tile, fewer rows than K - 1, 128 branches; rtty_scores'
     soft bits bit-equal and its scores <= 1e-4 absolute at the
     100-channel decoder's (F, nfft, C, T) with and without a soft tail,
     at one channel and at 77 offsets, not a multiple of its loop; and
     the scans and pfb_branch at the shapes phase 10's mesh shards give
     them), with
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
     shows 64 channels; both runs' displays graphed (one CUDA graph a
     pane).
  8. chan64 CUDA vs CPU: as 6, for the channelizer bank (>= 60 dB on the
     channels that carry a station).
  9. rtty path: the entry point with examples/rtty_decode.sh's flags on
     tests/fixtures/rtty_cq.dat decodes "CQ" and "AA2IL"; then the
     100-station layout of tests/test_rtty.py (synthesized at 96 kHz,
     resampled to 2.048 MHz, 120 kHz off the file's center) replayed
     from 0.75 s with --fs-out 96 --block 24576 --rtty 0, four times,
     the decoder graphed, eager (graph=False), eager, graphed: >= 90 of
     the 100 STii strings in their own channel's text, the same text
     channel by channel in every run, the decoder's filterbank graphs
     (one a frame count: 43, 46 and 47) all captured before the first
     block, rtty_scores launched once on every block with channels, and
     the decoder's wall ms per block against the block's 256 ms and its
     stage_ms, beside the card's name and power limit; both inputs again
     with --mesh 1,1, decoding the serial runs' text; then bank4 for 2
     blocks with --save-iq --save-baseband --save-demod, each .dat
     parsed back.
 10. mesh: the entry point with --mesh 1,1 (through the adapters, one
     CUDA graph for the one shard) at bank4's and chan64's full width:
     every RX's tone, the station channels' tones >= 40 dB, an idle
     channel squelched silent; then the adapters on a grid of cuda:0
     four times (bank4 at 2 x 2, chan64 at 1 x 4 and 2 x 2), graphed
     (one graph a shard) against their eager twins (graph=False) over 64
     calls, past sr_latch's 31-launch epoch wrap, with a retune and a
     set_mode posted partway: every audio piece, baseband piece and
     carried tensor bit-equal; the audio against the serial bank on the
     card over identical blocks made on the card, SNR > 55 dB with AGC
     off and > 30 dB with AGC and squelch on (on every call but the two
     a control lands on, whose SNR is printed); the launches, CUDA-event
     ms a call both ways, and torch.profiler's kernels a call, busy ms
     and idle share over events of both.
 11. host surface: `python -m pysdr_tpu_torch.probe --smoke` names the
     card and passes; a 2-block bank4 replay with --jax-trace leaves a
     trace file; a 4-block bank4 replay (a CS8 capture made on the card)
     at --pipeline-depth 2 prints stage_report() and its drain ms a block;
     then the soak: the same capture replayed looped through the graphed
     bank4 for 256 blocks, the second half not >= 1.5x slower per block
     than the first, RSS growth < 200 MB and memory_allocated() equal
     after the 64-block warm-up and at the end (tests/test_soak.py's
     thresholds); then that replay end to end serial and with --mesh
     1,1 in turns, Msamp/s and the stages a block of each.
 12. bench: `python -m pysdr_tpu_torch.bench --quick` as a child on the
     card (every config at full width, 2 repetitions): its last line
     parses, each of its configs (the device-only ones graphed and each
     with its eager twin) has no error and no failed output check, it
     names this card, and the bank4 replay read through the C++
     streamer; its JSON line is printed before the kernels line.
 13. graph: bank4 (phase 4's layout, i8 RF), modes1ch (the bench's, f32,
     AM -> NFM + squelch -> USB between blocks) and chan64 (phase 7's
     layout, i8, 12288-sample audio blocks), each bank's
     step as a CUDA graph replay against an eager twin (graph=False) over
     64 blocks, past sr_latch's 31-launch epoch wrap: every block's audio
     wire and every state tensor bit-equal, one graph a bank; then the
     CUDA-event ms a step both ways, and torch.profiler's kernels a step,
     busy ms and idle share of both (the profiled window's, and the busy
     ms against the untraced event ms).
 14. display: bank4's display engine (RF pane at 4,096,000 samples, AF
     and BB panes at 24576) and chan64's (RF at 786,432), graphed (one
     CUDA graph a pane and block length, replayed on the display's own
     stream) against eager twins (graph=False) over 64 updates of each
     pane kind with a retune, a dynamic-range change, a clear and a
     peak-height change between them: every frame bit-equal, and the DR
     change shown in the next frame; each pane's update ms (CUDA events
     on its stream, and wall), kernels and copies an update, busy ms,
     graphed and eager; then bank4 from a looped CS8 replay through the
     App at --pipeline-depth 2 with --psd --psd-every 1 graphed, eager
     and with no display, in turns over 3 rounds: Msamp/s, stages a
     block, the hook's wall ms a block; the graphed run's last RF frame
     equal to the eager run's, RX0's carrier among its peaks.

The banks of phases 4-12 run as the app runs them: on the card each
step is one CUDA graph replay a block (models/graphstep), and each
--mesh shard one replay a call.

The last line is {"ok": true, "device": {...}}; the line before it lists
the kernels with their launches summed over the paths' runs (phases 4,
7, 9 and 10, each with the counts set to 0 before it), their largest error
over phase 3's shapes, and at their first shape there their times, bound
and library time (or null); phase 12's bench line comes before it.
Imports no JAX, and of this repository only
pysdr_tpu_torch, which imports neither: the run fails if any jax or
pysdr_tpu module was loaded.
"""

from __future__ import annotations

import io
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
# pfb_branch on the f32 and i16 wires, then its edge shapes: 127 and 129
# rows around its 128-row tile, 5 rows < K - 1 so the new history
# reaches into the old, 128 branches in two tiles); linrec's `a` as the
# main path gives it (a
# per-column constant at stride 0 along n for the 4- and 2-column passes,
# a python scalar for the AGC), then edge shapes around its 512-sample
# tile with a dense `a`; the latch's edge shapes, "quiet" with commands
# only near a row's ends; rtty_scores' (F, nfft, C, T) are the
# 100-channel decoder's at 96 kHz without and with its soft tail, and
# one channel, and 77 offsets (T = 65), not a multiple of the kernel's
# 4-offset groups or its 32-offset pass. Then the shapes phase 10's mesh
# shards give the kernels: each shard runs [0.2 s halo | segment], so
# bank4's demod sees 34176 audio samples a row ((1.6 M + 4.096 M) RF x
# 3/500) at 4 rows (1 x 1) or 2 (2 x 2), and chan64's 21888 a channel
# (87552 PFB rows of 64, over 4) at 64, 32 (2 x 2) or 16 (1 x 4)
# channels, with the AGC pass at 1/64 of that; the channel shards' PFB
# runs on the f32 wire, dequantized before the halo copies
MESH_SCANS = [(2, 34176), (4, 34176), (16, 21888), (32, 21888), (64, 21888)]
KERNEL_SHAPES = {"linrec": [(64, 12288, 4, "columns"), (64, 12288, 2, "columns"),
                            (64, 192, 1, "scalar"), (4, 24576, 4, "columns"),
                            (4, 24576, 2, "columns"), (4, 384, 1, "scalar"),
                            (3, 511, 4, "dense"), (3, 512, 2, "dense"),
                            (3, 513, 1, "dense"), (2, 1, 4, "columns"),
                            (2, 200000, 4, "dense")]
                 + [(rows, n // q, k, kind) for rows, n in MESH_SCANS
                    for q, k, kind in ((1, 4, "columns"), (1, 2, "columns"),
                                       (64, 1, "scalar"))],
                 "sr_latch": [(64, 12288, ""), (4, 24576, ""), (3, 511, ""),
                              (3, 512, ""), (3, 513, ""), (2, 1, ""),
                              (2, 200000, "quiet")]
                 + [(rows, n, "") for rows, n in MESH_SCANS],
                 "pfb_branch": [(49152, 64, 12, "i8"),
                                (49152, 64, 12, "f32"),
                                (49152, 64, 12, "i16"),
                                (127, 64, 12, "i8"), (129, 64, 12, "i8"),
                                (5, 64, 12, "i8"), (4096, 128, 12, "i16"),
                                (87552, 64, 12, "f32")],
                 "rtty_scores": [(43, 4096, 100, 64), (43, 4096, 100, 0),
                                 (43, 4096, 1, 64), (43, 4096, 100, 65)]}
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
GRAPH_BLOCKS = 64                      # phase 13: past sr_latch's wrap at 31
DISPLAY_UPDATES = 64                   # phase 14: graphed vs eager a pane
E2E_DISPLAY_ROUNDS = 3                 # phase 14: turns of the three runs
MESH_CALLS = 64                        # phase 10.2, past the same wrap
MESH_CONTROL_CALLS = (21, 42)          # phase 10.2: a retune, a set_mode
SOAK_BLOCKS = (64, 256)                # phase 11: warm-up, then the soak
T0 = time.perf_counter()               # the phases print their start


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def phase(name):
    print(f"== {name} (at {time.perf_counter() - T0:.1f} s)", flush=True)


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
    from pysdr_tpu_torch.runtime.profiler import profile_steps, timed_steps

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
    disp = a.display
    print(f"display: {disp.graph_count} graphs over {len(disp.panes)} "
          "panes", flush=True)
    check(disp.graph_count == len(disp.panes), "the chan64 display did "
          f"not run graphed: {disp.graph_count} graphs")
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
          f"{fr.get('rf', {}).get('rows')}, display graphs "
          f"{web_app.display.graph_count}", flush=True)
    check(web_app.display.graph_count == len(web_app.display.panes),
          "the web viewer's display did not run graphed")
    check(fr.get("ok") and fr.get("n_rx") == 64 and len(fr["rx"]) == 64,
          f"/frame.json: ok {fr.get('ok')} n_rx {fr.get('n_rx')}")
    return launches


def chan64_cuda_vs_cpu_phase():
    import numpy as np
    import torch

    from pysdr_tpu_torch import app
    from pysdr_tpu_torch.models.channelizer_bank import ChannelizerBank
    from pysdr_tpu_torch.ops import cplx
    from pysdr_tpu_torch.runtime.profiler import profile_steps, timed_steps

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


def run_timed_rtty(argv, graph=True):
    """argv through the App as run_cli runs it, with the RTTY decoder (if
    any) at `graph` (False: a graph=False twin in its place before the
    captures) and each of its decode_block calls timed on the host's
    clock; the scores come to the host inside the call, so its wall time
    covers the device work. Returns (rc, app, calls) with one (ms,
    channels after the call, rtty_scores launches, the decoder's graphs
    before the call) per call."""
    from pysdr_tpu_torch import app
    from pysdr_tpu_torch.kernels import rtty as krtty
    from pysdr_tpu_torch.models import rtty

    a = app.App(app.build_parser().parse_args(argv))
    calls = []
    dec = a.rtty
    if dec is not None:
        if not graph:
            dec = a.rtty = rtty.RTTYDecoder(dec.design, device=dec.device,
                                            graph=False)
        orig = dec.decode_block

        def timed(x, ready=None):
            n0, g0 = krtty.rtty_scores.launches, dec.graph_count
            t0 = time.perf_counter()
            out = orig(x, ready=ready)
            calls.append(((time.perf_counter() - t0) * 1e3,
                          len(dec.channels),
                          krtty.rtty_scores.launches - n0, g0))
            return out
        dec.decode_block = timed
    return a.run(), a, calls


def card_line():
    """The card's name and power limit, as nvidia-smi gives them."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    return smi.stdout.strip().splitlines()[0]


def channel_text(dec):
    return [(c["mark_bin"], c["text"]) for c in dec.channels]


def rtty_phase(tmp):
    """The RTTY path: the rtty_cq.dat corpus, the 100-station layout at
    full width with the decoder graphed and eager in turns, both again
    through --mesh 1,1, and the recording taps on bank4. Returns the
    launches of its runs, summed."""
    import torch

    from pysdr_tpu_torch import kernels
    from pysdr_tpu_torch.io import datfile

    total = {}

    def drive(argv, graph=True):
        print("argv: " + " ".join(argv)
              + ("" if graph else "  (decoder graph=False)"), flush=True)
        kernels.reset_launch_counts()
        rc, a, calls = run_timed_rtty(argv, graph)
        torch.cuda.synchronize()
        launches = kernels.launch_counts()
        print(f"launches: {launches}", flush=True)
        check(rc == 0 and a is not None, f"{argv} exited {rc}")
        for k, n in launches.items():
            total[k] = total.get(k, 0) + n
        dec = a.rtty
        if dec is not None:
            with_ch = [c for c in calls if c[1] > 0]
            check(with_ch and all(c[2] == 1 for c in with_ch),
                  f"rtty_scores did not launch once on every block with "
                  f"channels: {[(c[1], c[2]) for c in calls]}")
            want = len(dec.frame_counts) if graph else 0
            print(f"decoder: frame counts {dec.frame_counts}, graphs "
                  f"{dec.graph_count} ({calls[0][3]} before the first "
                  "block)", flush=True)
            check(dec.graph_count == calls[0][3] == want,
                  f"decoder graphs {dec.graph_count}, {calls[0][3]} before "
                  f"the first block, want {want} (graph={graph})")
        return a, calls, launches

    corpus = ["--device", "cuda", "--replay",
              os.path.join(ROOT, "tests", "fixtures", "rtty_cq.dat"), *RTTY,
              "--block", "4096"]
    a, calls, launches = drive(corpus)
    text = "".join(a.rtty_text)
    print(f"rtty_cq.dat: {text!r}", flush=True)
    check("CQ" in text and "AA2IL" in text, f"rtty_cq.dat decoded {text!r}")
    check(launches["rtty_scores"] > 0, "rtty_scores never launched on the "
          "corpus")
    corpus_text = channel_text(a.rtty)

    path = os.path.join(tmp, "rtty100.dat")
    t0 = time.perf_counter()
    carriers = rtty_composite(path)
    print(f"wrote the {RTTY_STATIONS}-station capture at "
          f"{RTTY_FS * RTTY_UP / RTTY_DOWN / 1e6:.3f} MHz in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    hundred = ["--device", "cuda", "--replay", path, "0.75", *RTTY,
               "--fs-out", str(RTTY_FS / 1e3), "--block", str(RTTY_BLOCK)]
    budget = RTTY_BLOCK / RTTY_FS * 1e3
    card = card_line()
    runs = {}
    for graph in (True, False, False, True):       # in turns
        a, calls, _ = drive(hundred, graph)
        tag = "graphed" if graph else "eager"
        print(f"stage_report ms/block: {a.ex.stage_report()}", flush=True)
        dec = a.rtty
        got = set()
        for ch in dec.channels:
            i = station_of(dec.design, ch["mark_bin"], carriers)
            if f"ST{i:02d}" in ch["text"]:
                got.add(i)
        print(f"{tag}: {len(dec.channels)} channels; {len(got)} of "
              f"{RTTY_STATIONS} stations decoded their STii in their own "
              f"channel; missing "
              f"{sorted(set(range(RTTY_STATIONS)) - set(got))}", flush=True)
        check(len(got) >= 90, f"{tag}: only {len(got)} of {RTTY_STATIONS} "
              "stations decoded")
        if graph:
            check(dec.frame_counts == [43, 46, 47],
                  f"frame counts {dec.frame_counts}, not [43, 46, 47]")
        ms = [c[0] for c in calls]
        med = statistics.median(ms[1:]) if len(ms) > 1 else ms[0]
        print(f"{tag} decoder wall ms per block ({card}): "
              f"{[round(t, 3) for t in ms]}; median after the first "
              f"{med:.3f} ms against a {budget:.0f} ms budget = "
              f"{budget / med:.1f}x real time, so {len(dec.channels)} "
              f"channels x {budget / med:.1f} = "
              f"{len(dec.channels) * budget / med:.0f} channel-decoders at "
              "real time", flush=True)
        print(f"{tag} decoder stage_ms over {dec.stage_blocks} blocks "
              f"({card}): " + json.dumps(dec.stage_ms), flush=True)
        runs.setdefault(tag, []).append((med, dec.stage_ms,
                                         channel_text(dec)))
    serial_text = runs["graphed"][0][2]
    for tag, rs in runs.items():
        for _, _, chans in rs:
            check(chans == serial_text, f"{tag}: the text differs channel "
                  "by channel from the first graphed run's")
    print("rtty100 wall ms a block (median after the first): " + json.dumps(
        {t: [r[0] for r in rs] for t, rs in runs.items()}), flush=True)

    for argv, want, name in ((corpus, corpus_text, "rtty_cq.dat"),
                             (hundred, serial_text, "rtty100")):
        a, _, _ = drive([*argv, "--mesh", "1,1"])
        check(type(a.bank).__name__ == "ShardedStreamBank",
              f"--mesh 1,1 ran {type(a.bank).__name__}")
        same = channel_text(a.rtty) == want
        print(f"{name} --mesh 1,1: {len(a.rtty.channels)} channels, text "
              f"{'equal to' if same else 'NOT equal to'} the serial run's "
              "channel by channel", flush=True)
        check(same, f"{name} --mesh 1,1: the text differs from the serial "
              f"run's: {channel_text(a.rtty)} against {want}")

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


def mesh_cli_phase(tmp):
    """Phase 10.1: `--mesh 1,1` through the entry point at bank4's and
    chan64's full width, so the runs go through the adapters. Returns the
    launches of the two runs, summed."""
    import numpy as np
    import torch

    from pysdr_tpu_torch import app, kernels

    total = {}

    def drive(argv, adapter, kinds):
        print("argv: " + " ".join(argv), flush=True)
        kernels.reset_launch_counts()
        rc, a = app.run_cli(argv)
        torch.cuda.synchronize()
        launches = kernels.launch_counts()
        print(f"launches: {launches}", flush=True)
        check(rc == 0 and a is not None, f"{argv} exited {rc}")
        check(type(a.bank).__name__ == adapter,
              f"--mesh 1,1 ran {type(a.bank).__name__}, not {adapter}")
        print(f"{adapter}: graph_count {a.bank.graph_count}", flush=True)
        check(a.bank.graph_count == 1, f"--mesh 1,1: "
              f"{a.bank.graph_count} graphs, not one for its one shard")
        for name in kinds:
            check(launches[name] > 0, f"kernel {name} never launched on "
                  f"the {adapter} path")
        for k, n in launches.items():
            total[k] = total.get(k, 0) + n
        return a

    prefix = os.path.join(tmp, "mesh4")
    a = drive(["--device", "cuda", *BANK4, "--wire", "i8", "--audio-wire",
               "i16", "--blocks", "4", "--mesh", "1,1", "--wav", prefix],
              "ShardedStreamBank", BANK4_KERNELS)
    expect = {"AM": 400.0, "NFM": 800.0, "USB": 1200.0}
    for i, rc_i in enumerate(a.cfg.receivers):
        pk, db = wav_peak(f"{prefix}_rx{i}.wav")
        want = (rc_i.bfo_hz if rc_i.mode.name == "CW"
                else expect[rc_i.mode.name])
        print(f"mesh 1,1 rx{i} {rc_i.mode.name}: peak {pk:.2f} Hz (want "
              f"{want}), {db:.1f} dB over floor", flush=True)
        check(abs(pk - want) <= 5.0 and db >= 40.0,
              f"mesh 1,1 rx{i}: peak {pk} Hz / {db:.1f} dB")
    prefix = os.path.join(tmp, "mesh64")
    drive(["--device", "cuda", *CHAN64, "--blocks", "3", "--mesh", "1,1",
           "--wav", prefix], "ShardedChannelizerBank", CHAN64_KERNELS)
    for i in (0, 4, 8, 12, 60):
        pk, db = wav_peak(f"{prefix}_rx{i}.wav")
        want = 300.0 + 50.0 * i
        print(f"mesh 1,1 ch{i}: peak {pk:.2f} Hz (want {want}), {db:.1f} "
              "dB over floor", flush=True)
        check(abs(pk - want) <= 5.0 and db >= 40.0,
              f"mesh 1,1 ch{i}: peak {pk} Hz / {db:.1f} dB")
    for i in (1, 2):
        with wave.open(f"{prefix}_rx{i}.wav") as w:
            d = np.frombuffer(w.readframes(w.getnframes()), np.int16)
        tail = np.abs(d[len(d) // 2:].astype(np.int32)).max()
        print(f"mesh 1,1 ch{i} (idle, squelch 10 dB): max |sample| over "
              f"the last half {tail}", flush=True)
        check(tail == 0, f"mesh 1,1: idle ch{i} is not squelched: {tail}")
    return total


def station_blocks(offsets, kinds, audio_hz, fs, n, n_blocks, device,
                   amp=0.05, seed=0):
    """n_blocks consecutive float32 (n, 2) RF blocks on `device`, yielded
    one by one, one station an offset: "am" (a 50 % AM tone), "fm" (5 kHz
    deviation by a tone), "usb" (the tone above the carrier) or "cw" (a
    carrier); plus noise 60 dB under a station. Phases from the exact
    sample index."""
    import math

    import torch
    gen = torch.Generator(device=device).manual_seed(seed)
    for b in range(n_blocks):
        i = torch.arange(b * n, (b + 1) * n, dtype=torch.float64,
                         device=device)

        def cyc(f):
            return 2 * math.pi * torch.remainder(i * (f / fs), 1.0)
        x = amp * 1e-3 * torch.complex(
            torch.randn(n, generator=gen, device=device, dtype=torch.float64),
            torch.randn(n, generator=gen, device=device, dtype=torch.float64))
        for off, kind, fa in zip(offsets, kinds, audio_hz):
            ph = cyc(off)
            if kind == "am":
                x = x + amp * (1 + 0.5 * torch.sin(cyc(fa))) \
                    * torch.exp(1j * ph)
            elif kind == "fm":
                x = x + amp * torch.exp(1j * (ph + 5e3 / fa
                                              * torch.sin(cyc(fa))))
            elif kind == "usb":
                x = x + amp * torch.exp(1j * (ph + cyc(fa)))
            else:
                x = x + amp * torch.exp(1j * ph)
        yield torch.view_as_real(x.to(torch.complex64)).contiguous()


def snr_db(ref, got):
    """Audio SNR of got against ref, per channel: (n_ch,) in dB."""
    import numpy as np
    err = np.sum(np.abs(got - ref) ** 2, axis=-1)
    sig = np.sum(np.abs(ref) ** 2, axis=-1)
    return 10 * np.log10(np.maximum(sig, 1e-30) / np.maximum(err, 1e-30))


def mesh_controls(bank, k, retune, mode):
    """Phase 10.2's control changes, posted before call k: `retune` (an
    RX and its new frequency) at MESH_CONTROL_CALLS[0], `mode` (an RX and
    its new mode) at MESH_CONTROL_CALLS[1]."""
    if k == MESH_CONTROL_CALLS[0]:
        bank.retune(*retune)
    elif k == MESH_CONTROL_CALLS[1]:
        bank.set_mode(*mode)


def carried(ad):
    """An adapter's carried tensors: tail, bases, demod state."""
    from pysdr_tpu_torch.device import leaves
    return [ad._tail, ad._nb, ad._bb, *leaves(ad._dstate)]


def adapters_vs_serial(bank_of, adapter_of, blocks, grid, device, skip,
                       channels, floor, retune, mode, n_calls):
    """Phase 10.2 on one grid: the adapter `adapter_of(bank, mesh, graph)`
    on an S x C grid of `device` repeated, graphed (one CUDA graph a
    shard) and its eager twin (graph=False), over n_calls calls of S
    blocks from `blocks`, with mesh_controls posted to both and to the
    serial bank at the same block: every audio piece, baseband piece and
    carried tensor bit-equal between the two; the graphed audio against
    the serial bank's (per-channel SNR after `skip` samples > floor);
    then the CUDA-event ms a call both ways and torch.profiler's kernels
    a call, busy ms and idle share of both. Returns (launches of the
    calls of both adapters, results)."""
    import numpy as np
    import torch

    from pysdr_tpu_torch import kernels
    from pysdr_tpu_torch.parallel import mesh as mesh_mod
    from pysdr_tpu_torch.runtime.profiler import profile_steps

    s, c = grid
    on_card = torch.device(device).type == "cuda"
    serial = bank_of()
    mesh = mesh_mod.make_mesh(s, c, devices=[device] * (s * c))
    g, e = adapter_of(bank_of(), mesh, True), adapter_of(bank_of(), mesh,
                                                         False)
    for ad in (g, e):
        ad.prepare(torch.float32, ad.design.in_block)
    check(g.graph_count == (s * c if on_card else 0)
          and e.graph_count == 0,
          f"{s}x{c}: {g.graph_count} graphs, eager {e.graph_count}")
    ref, got, xs = [], [], []
    t0 = time.perf_counter()
    launches = {}
    for k in range(n_calls):
        xbs = [next(blocks) for _ in range(s)]
        for b in (serial, g, e):
            mesh_controls(b, k, retune, mode)
        # the step's audio is its static output: a host copy of each
        ref.extend(serial.audio_from_wire(
            serial.step_device(xb).to("cpu", copy=True)) for xb in xbs)
        x = torch.cat(xbs)
        if len(xs) < 8:
            xs.append(x)
        kernels.reset_launch_counts()
        pg = g.step_device(x)
        bg = g._last_bb
        pe = e.step_device(x)
        for name, n in kernels.launch_counts().items():
            launches[name] = launches.get(name, 0) + n
        for i, (a, b) in enumerate(zip(pg, pe)):
            check(torch.equal(a, b), f"{s}x{c} call {k}: audio piece {i} "
                  "of the graphs differs from the eager call's")
        for i, (a, b) in enumerate(zip(bg or (), e._last_bb or ())):
            check(torch.equal(a, b), f"{s}x{c} call {k}: baseband piece "
                  f"{i} differs")
        for i, (a, b) in enumerate(zip(carried(g), carried(e))):
            check(torch.equal(a, b), f"{s}x{c} call {k}: carried tensor "
                  f"{i} differs")
        got.append(g.audio_from_wire(pg))
    ref = np.concatenate(ref, axis=1)[channels]
    got = np.concatenate(got, axis=1)[channels]
    # the floor holds after `skip`, on every call but the two a control
    # lands on: there the serial bank runs the new params from the old
    # state while each shard re-settles its halo under them (the
    # stream-parallel approximation, the JAX processors' as well)
    per_call = got.shape[1] // n_calls
    keep = np.ones(got.shape[1], bool)
    keep[:skip] = False
    landed = {}
    for k in MESH_CONTROL_CALLS:
        sl = slice(k * per_call, (k + 1) * per_call)
        keep[sl] = False
        if k < n_calls:
            landed[k] = float(snr_db(ref[:, sl], got[:, sl]).min())
    snr = snr_db(ref[:, keep], got[:, keep])
    res = {"calls": n_calls, "graphs": g.graph_count, "halo": g.halo,
           "snr_min_db": float(snr.min()), "snr_max_db": float(snr.max()),
           "snr_min_db_control_calls": landed, "launches": launches}
    print(f"  {s}x{c} grid, halo {g.halo}: {n_calls} calls graphed and "
          f"eager bit-equal (audio, baseband, carried state), "
          f"{g.graph_count} graphs, launches {launches}, in "
          f"{time.perf_counter() - t0:.1f} s; SNR against the serial bank "
          f"min {snr.min():.1f} max {snr.max():.1f} dB (floor {floor}), "
          f"on the calls a control lands on {landed}", flush=True)
    check(snr.min() > floor, f"{s}x{c}: {snr.min():.1f} dB <= {floor}")
    if on_card:
        for tag, ad in (("graph", g), ("eager", e)):
            res[f"call_ms_{tag}"] = cuda_ms(
                lambda ad=ad: ad.step_device(xs[0]), reps=10)
            table = io.StringIO()
            prof = profile_steps(ad, xs[:4], out=table)
            # each hand kernel's device time in the call, and the summary
            for ln in table.getvalue().splitlines():
                if " kernel: " in ln or ln.startswith("profiled step"):
                    print(f"  {tag}: {ln.strip()}", flush=True)
            for key in ("kernels_per_step", "device_busy_ms",
                        "device_idle_share"):
                res[f"{key}_{tag}"] = prof[key]
            res[f"device_idle_share_events_{tag}"] = max(
                0.0, 1 - prof["device_busy_ms"] / res[f"call_ms_{tag}"])
        print(f"  a call (events): graphs {res['call_ms_graph']:.3f} ms, "
              f"eager {res['call_ms_eager']:.3f} ms; kernels "
              f"{res['kernels_per_step_graph']:.0f} / "
              f"{res['kernels_per_step_eager']:.0f}, busy "
              f"{res['device_busy_ms_graph']:.3f} / "
              f"{res['device_busy_ms_eager']:.3f} ms, idle over events "
              f"{res['device_idle_share_events_graph']:.3f} / "
              f"{res['device_idle_share_events_eager']:.3f}", flush=True)
    return launches, res


def mesh_stream_phase(device="cuda", bank4=BANK4, chan64=CHAN64,
                      n_calls=MESH_CALLS):
    """Phase 10.2: the adapters (parallel/adapter) on a grid of one
    device repeated 4 times, graphed against graph=False and against the
    serial bank over identical blocks, AGC off (> 55 dB,
    tests/test_sharded_streaming.py:195) and AGC and squelch on (> 30
    dB, :232 and :300): bank4 at 2 x 2, chan64 at 1 x 4 and 2 x 2.
    Returns the launches of the adapters' calls, summed, and the
    results."""
    from pysdr_tpu_torch import app
    from pysdr_tpu_torch.models.channelizer_bank import ChannelizerBank
    from pysdr_tpu_torch.models.receiver import ReceiverBank
    from pysdr_tpu_torch.parallel.adapter import (ShardedChannelizerBank,
                                                  ShardedStreamBank)
    from pysdr_tpu_torch.tables import Mode

    total, out = {}, {}

    def add(counts):
        for k, n in counts.items():
            total[k] = total.get(k, 0) + n

    # the RTTY-free bank4 layout; its synth's stations, made on the card
    kinds = {"AM": "am", "NFM": "fm", "USB": "usb", "CW": "cw"}
    for extra, skip, floor in ((["--no-agc"], 16384, 55.0),
                               (["--squelch", "-60"], 48000, 30.0)):
        args = app.build_parser().parse_args([*bank4, *extra])
        cfg = app.build_config(args)
        tag = f"bank4 {' '.join(extra)}"
        print(f"{tag}:", flush=True)
        d = ReceiverBank(cfg, device=device).design
        blocks = station_blocks(
            cfg.channel_offsets_hz(), [kinds[r.mode.name]
                                       for r in cfg.receivers],
            [400.0 * (i + 1) for i in range(len(cfg.receivers))],
            cfg.fs_in, d.in_block, 2 * n_calls, device)
        launches, out[f"{tag} 2x2"] = adapters_vs_serial(
            lambda: ReceiverBank(cfg, emit_baseband=True, device=device),
            lambda b, m, graph: ShardedStreamBank(b, m, graph=graph),
            blocks, (2, 2), device, skip, list(range(len(cfg.receivers))),
            floor, (1, cfg.receivers[1].fc_hz + 200.0), (0, Mode.USB),
            n_calls)
        add(launches)
    for extra, skip, floor in ((["--no-agc", "--squelch", "-150"], 16384,
                                55.0), ([], 48000, 30.0)):
        _, _, cfg = app.build_channelizer(app.build_parser().parse_args(
            ["--device", device, *chan64, "--audio-wire", "f32", *extra]))
        offs = cfg.center_freqs_hz() - cfg.fc_hz
        stations = list(range(0, cfg.n_channels, 4))
        tag = f"chan64 {' '.join(extra) or '(AGC on, squelch 10 dB)'}"
        print(f"{tag}:", flush=True)
        seg = ChannelizerBank(cfg, device=device).design.in_block
        for grid in ((1, 4), (2, 2)):
            blocks = station_blocks(
                [offs[i] for i in stations], ["am"] * len(stations),
                [300.0 + 50.0 * i for i in stations], cfg.fs_in, seg,
                grid[0] * n_calls, device)
            launches, out[f"{tag} {grid[0]}x{grid[1]}"] = \
                adapters_vs_serial(
                    lambda: ChannelizerBank(cfg, audio_wire="f32",
                                            device=device),
                    lambda b, m, graph: ShardedChannelizerBank(
                        b, m, graph=graph), blocks, grid, device, skip,
                    stations, floor, (4, 200.0), (4, Mode.USB), n_calls)
            add(launches)
    return total, out


def bank4_cs8(path, n_blocks=5):
    """Write n_blocks of bank4's four stations (station_blocks, made on
    the card) to `path` as a CS8 capture: a replay of it feeds the
    executive faster than the synth renders."""
    from pysdr_tpu_torch import app
    from pysdr_tpu_torch.io import datfile

    cfg = app.build_config(app.build_parser().parse_args(BANK4))
    kinds = {"AM": "am", "NFM": "fm", "USB": "usb", "CW": "cw"}
    w = datfile.DatWriter(path, fs=cfg.fs_in, fc=cfg.sdr_center_hz,
                          dtype="int8")
    for xb in station_blocks(cfg.channel_offsets_hz(),
                             [kinds[r.mode.name] for r in cfg.receivers],
                             [400.0 * (i + 1) for i in range(4)], cfg.fs_in,
                             24576 * 500 // 3, n_blocks, "cuda", amp=0.2):
        w.save_data(xb.cpu().numpy())
    w.close()


def host_surface_phase(tmp):
    """Phase 11: the probe on the card (and its --smoke), a 2-block bank4
    run with --jax-trace leaving a trace file, and a 4-block bank4 replay
    at --pipeline-depth 2 whose stage_report gives the drain ms a block."""
    import torch

    from pysdr_tpu_torch import app

    out = subprocess.run([sys.executable, "-m", "pysdr_tpu_torch.probe",
                          "--smoke"], capture_output=True, text=True,
                         timeout=300, cwd=ROOT)
    print(out.stdout.strip(), flush=True)
    kind = torch.cuda.get_device_name(0)
    check(out.returncode == 0 and kind in out.stdout
          and "audio rms" in out.stdout and "OK" in out.stdout,
          f"probe --smoke: rc {out.returncode}\n{out.stdout}\n{out.stderr}")

    path = os.path.join(tmp, "bank4_cs8.dat")
    bank4_cs8(path)
    replay = ["--device", "cuda", "--replay", path, "--no-loop", *BANK4,
              "--wire", "i8", "--audio-wire", "i16"]

    trace = os.path.join(tmp, "trace")
    rc, _ = app.run_cli([*replay, "--blocks", "2", "--jax-trace", trace])
    files = [os.path.join(trace, f) for f in os.listdir(trace)] \
        if os.path.isdir(trace) else []
    sizes = [os.path.getsize(f) for f in files]
    print(f"--jax-trace: rc {rc}, files {[os.path.basename(f) for f in files]}"
          f" {sizes} bytes", flush=True)
    check(rc == 0 and sizes and min(sizes) > 0, "--jax-trace left no trace")

    rc, a = app.run_cli([*replay, "--blocks", "4", "--pipeline-depth", "2"])
    check(rc == 0 and a.ex.n_blocks == 4, f"depth-2 replay exited {rc}")
    rep = a.ex.stage_report()
    print(f"bank4 replay, 4 blocks, --pipeline-depth 2: drain "
          f"{rep['drain']:.3f} ms a block", flush=True)
    print(f"stage_report ms/block: {rep}", flush=True)
    soak_phase(replay)
    mesh_e2e_phase(replay)


def mesh_e2e_phase(replay, warm=4, blocks=24):
    """Phase 11: bank4 end to end from the looped CS8 replay, serial and
    through --mesh 1,1 (one shard, one graph, the 0.2 s halo on every
    block) in turns (serial, mesh, mesh, serial): Msamp/s over `blocks`
    blocks after `warm`, and the stages a block."""
    import torch

    from pysdr_tpu_torch import app

    argv = [a for a in replay if a != "--no-loop"]
    rates = {"serial": [], "mesh 1,1": []}
    for tag in ("serial", "mesh 1,1", "mesh 1,1", "serial"):
        extra = ["--mesh", "1,1"] if tag != "serial" else []
        a = app.App(app.build_parser().parse_args([*argv, *extra]))
        ex = a.ex
        ex.run(n_blocks=warm)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ex.run(n_blocks=warm + blocks)
        dt = time.perf_counter() - t0
        ex.stop()
        msps = blocks * a.bank.design.in_block / dt / 1e6
        rates[tag].append(msps)
        rep = ex.stage_report()
        print(f"bank4 replay end to end, {tag}: {msps:.1f} Msamp/s "
              f"({dt * 1e3 / blocks:.2f} ms a block), stages ms/block "
              + " ".join(f"{k} {v:.2f}" for k, v in rep.items()),
              flush=True)
        check(ex.n_blocks == warm + blocks, f"{tag}: {ex.n_blocks} blocks")
    print(f"bank4 end to end Msamp/s, in turns: {json.dumps(rates)}",
          flush=True)


def soak_phase(replay):
    """Phase 11's soak (the card's twin of tests/test_soak.py): the
    graphed bank4 App replaying a short CS8 capture looped, SOAK_BLOCKS
    [0] blocks of warm-up, then to SOAK_BLOCKS[1] in two halves: the
    second half not >= 1.5x slower than the first (+ 0.25 s), RSS growth
    < 200 MB after the warm-up, and torch.cuda.memory_allocated() equal
    after the warm-up and at the end (the executive's per-block pinned
    upload, the graph's static buffers)."""
    import resource

    import torch

    from pysdr_tpu_torch import app

    def settled():
        # the prefetch thread may still be uploading the blocks it reads
        # ahead (a queue of 2 and one in hand): let it finish
        time.sleep(1.0)
        torch.cuda.synchronize()
        return (torch.cuda.memory_allocated(),
                resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024)

    argv = [a for a in replay if a != "--no-loop"]
    a = app.App(app.build_parser().parse_args(argv))
    ex = a.ex
    n_warm, n_end = SOAK_BLOCKS
    ex.run(n_blocks=n_warm)
    mem0, rss0 = settled()
    t0 = time.perf_counter()
    ex.run(n_blocks=(n_warm + n_end) // 2)
    t_first = time.perf_counter() - t0
    t0 = time.perf_counter()
    ex.run(n_blocks=n_end)
    t_second = time.perf_counter() - t0
    mem1, rss1 = settled()
    ex.stop()
    half = (n_end - n_warm) // 2
    print(f"soak: bank4 replay looped, {ex.n_blocks} blocks, "
          f"{a.bank.graph_count} graph; blocks {n_warm}-{n_warm + half} "
          f"{t_first * 1e3 / half:.2f} ms a block, the next {half} "
          f"{t_second * 1e3 / half:.2f}; RSS {rss0:.1f} -> {rss1:.1f} MB; "
          f"memory_allocated {mem0} -> {mem1} bytes", flush=True)
    check(ex.n_blocks == n_end, f"soak ran {ex.n_blocks} blocks")
    check(a.bank.graph_count == 1, f"soak: {a.bank.graph_count} graphs")
    check(t_second < 1.5 * t_first + 0.25,
          f"soak: second half {t_second:.2f} s, first {t_first:.2f} s")
    check(rss1 - rss0 < 200.0, f"soak: RSS grew {rss1 - rss0:.1f} MB")
    check(mem1 == mem0, f"soak: memory_allocated {mem0} -> {mem1}")


def bench_phase():
    """Phase 12: the port's bench at --quick in a child process; returns
    its last line."""
    import torch
    p = subprocess.run([sys.executable, "-m", "pysdr_tpu_torch.bench",
                        "--quick"], capture_output=True, text=True,
                       timeout=900, cwd=ROOT)
    for ln in p.stderr.splitlines():
        if ln.startswith(("# ", "bench:", "profiled step")):
            print(ln[:400], flush=True)
    lines = p.stdout.strip().splitlines()
    check(p.returncode == 0 and lines, f"bench --quick exited "
          f"{p.returncode}\n{p.stderr[-2000:]}")
    res = json.loads(lines[-1])
    extra = res["extra"]
    check(res["metric"] == "rf_samples_per_s_4ch_bank"
          and isinstance(res["value"], float), f"bench line: {lines[-1]}")
    from pysdr_tpu_torch.bench import CONFIGS, failed_checks
    for name in CONFIGS:
        entry = extra.get(name, {"error": "missing"})
        check("error" not in entry and not failed_checks(entry),
              f"bench config {name}: {entry}")
    kind = torch.cuda.get_device_name(0)
    check(extra["device"]["name"] == kind, f"bench ran on "
          f"{extra['device']}, not {kind}")
    src = extra["e2e_suite"]["end_to_end_bank4"]["source"]
    check(src == "NativeStreamer", f"bench's bank4 replay read through "
          f"{src}, not the C++ streamer")
    return lines[-1]


def graph_banks(kind, graph):
    """Phase 13's banks: bank4 (phase 4's layout, i16 audio), modes1ch
    (the bench's: 1 RX at 2.048 MHz, out_block 16384, f32 audio) and
    chan64 (phase 7's layout: out_block 12288, mu-law i8 audio, squelch
    10 dB). Returns (bank, its RF wire)."""
    from pysdr_tpu_torch import app
    from pysdr_tpu_torch.config import PipelineConfig, ReceiverConfig
    from pysdr_tpu_torch.models.channelizer_bank import ChannelizerBank
    from pysdr_tpu_torch.models.receiver import ReceiverBank
    from pysdr_tpu_torch.tables import Mode
    if kind == "bank4":
        cfg = app.build_config(app.build_parser().parse_args(BANK4))
        return ReceiverBank(cfg, audio_wire="i16", device="cuda",
                            graph=graph), "i8"
    if kind == "modes1ch":
        cfg = PipelineConfig(fs_in=2.048e6, fs_out=48e3, out_block=16384,
                             foffset_hz=120e3, receivers=(
                                 ReceiverConfig(fc_hz=100e6,
                                                mode=Mode.AM),))
        return ReceiverBank(cfg, audio_wire="f32", device="cuda",
                            graph=graph), "f32"
    _, _, cfg = app.build_channelizer(app.build_parser().parse_args(
        ["--device", "cuda", *CHAN64]))
    return ChannelizerBank(cfg, audio_wire="i8", device="cuda",
                           graph=graph), "i8"


def modes1ch_controls(bank, k):
    """modes1ch's three modes, as params writes between blocks: AM, then
    NFM with squelch 10 dB, then USB with AGC."""
    from pysdr_tpu_torch.tables import Mode
    if k == 21:
        bank.set_mode(0, Mode.NFM)
        bank.set_squelch(0, 10.0)
    elif k == 42:
        bank.set_mode(0, Mode.USB)
        bank.set_squelch(0, -150.0)


def wire_blocks(n, wire, count, seed=0):
    """count (n, 2) RF wire blocks made on the card from a seeded
    generator: normals of rms 0.3, quantized as the host would."""
    import torch

    from pysdr_tpu_torch.ops import cplx
    gen = torch.Generator(device="cuda").manual_seed(seed)
    out = []
    for _ in range(count):
        x = 0.3 * torch.randn((n, 2), generator=gen, device="cuda")
        if wire != "f32":
            sc = cplx.WIRE_SCALES[wire]
            x = torch.clamp(torch.round(x * sc), -sc, sc).to(
                torch.int8 if wire == "i8" else torch.int16)
        out.append(x)
    return out


def step_ms(bank, xbs, iters=20):
    """CUDA-event ms a step over `iters` back-to-back steps, after 3."""
    import torch
    for i in range(3):
        bank.step_device(xbs[i % len(xbs)])
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for i in range(iters):
        bank.step_device(xbs[i % len(xbs)])
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / iters


def graph_phase():
    """Phase 13: bank4's, modes1ch's and chan64's step (graph_banks) as a
    CUDA graph replay against an eager twin (graph=False) over
    GRAPH_BLOCKS blocks, past sr_latch's 31-launch epoch wrap: every
    block's audio wire and every state tensor bit-equal, one graph
    (modes1ch across its three modes); then the CUDA-event ms a step both
    ways and each step's torch.profiler kernels, busy ms and idle share."""
    import torch

    from pysdr_tpu_torch.device import leaves
    from pysdr_tpu_torch.runtime.profiler import profile_steps

    out = {}
    for kind in ("bank4", "modes1ch", "chan64"):
        g, wire = graph_banks(kind, True)
        e, _ = graph_banks(kind, False)
        n = g.design.in_block
        xbs = wire_blocks(n, wire, 8)
        t0 = time.perf_counter()
        for k in range(GRAPH_BLOCKS):
            if kind == "modes1ch":
                modes1ch_controls(g, k)
                modes1ch_controls(e, k)
            a_g = g.step_device(xbs[k % 8])
            a_e = e.step_device(xbs[k % 8])
            torch.cuda.synchronize()
            check(torch.equal(a_g, a_e), f"{kind} block {k}: the graph's "
                  "audio differs from the eager step's")
            for i, (sg, se) in enumerate(zip(leaves(g.state),
                                             leaves(e.state))):
                check(torch.equal(sg, se), f"{kind} block {k}: state "
                      f"tensor {i} differs from the eager step's")
        check(g.graph_count == 1 and e.graph_count == 0,
              f"{kind}: {g.graph_count} graphs")
        print(f"{kind} ({wire} RF wire): {GRAPH_BLOCKS} blocks graphed and "
              f"eager bit-equal (audio and state), {g.graph_count} graph, "
              f"in {time.perf_counter() - t0:.1f} s", flush=True)
        ms_g, ms_e = step_ms(g, xbs), step_ms(e, xbs)
        res = {"step_ms_graph": ms_g, "step_ms_eager": ms_e,
               "msps_graph": n / ms_g / 1e3, "msps_eager": n / ms_e / 1e3}
        for tag, bank in (("graph", g), ("eager", e)):
            table = io.StringIO()
            prof = profile_steps(bank, xbs, out=table)
            line = table.getvalue().strip().splitlines()[-1]
            print(f"  {tag}: {line}", flush=True)
            for key in ("kernels_per_step", "device_busy_ms",
                        "device_idle_share"):
                res[f"{key}_{tag}"] = prof[key]
            res[f"device_idle_share_events_{tag}"] = max(
                0.0, 1 - prof["device_busy_ms"] / res[f"step_ms_{tag}"])
        print(f"  step (events): graph {ms_g:.3f} ms = "
              f"{res['msps_graph']:.1f} Msamp/s, eager {ms_e:.3f} ms = "
              f"{res['msps_eager']:.1f} Msamp/s; a replay "
              f"{res['kernels_per_step_graph']:.0f} kernels, busy "
              f"{res['device_busy_ms_graph']:.3f} ms, idle share "
              f"{res['device_idle_share_graph']:.3f} (profiled window), "
              f"{res['device_idle_share_events_graph']:.3f} (busy over "
              "event ms)", flush=True)
        check(res["kernels_per_step_graph"] > 0
              and res["device_busy_ms_graph"] > 0,
              f"{kind}: torch.profiler saw no kernel of the graph")
        out[kind] = res
    print("graph phase: " + json.dumps(out), flush=True)
    return out


def display_controls(box, k):
    """Phase 14's controls between updates: a retune by 40 bins, the
    dynamic range to 30 dB, a clear, the peak height to 15 dB."""
    if k == 11:
        box.retune(box.fc_hz + 40 * box.design.fs / box.cfg.nfft)
    elif k == 23:
        box.cfg.pan_dr_db = 30.0
    elif k == 37:
        box.clear()
    elif k == 45:
        box.cfg.peak_height_db = 15.0


def frames_equal(a, b):
    import numpy as np
    return all(np.array_equal(x, y) for x, y in zip(a, b))


def host_blocks(n, count, seed):
    """count host complex64 blocks of n samples: normals of rms 0.3 a
    part, from a seeded generator."""
    import numpy as np
    rng = np.random.default_rng(seed)
    return [(0.3 * rng.standard_normal(2 * n, dtype=np.float32))
            .view(np.complex64) for _ in range(count)]


def pane_of(engine, tag):
    return next(b for b in engine.panes if b.tag == tag)


def update_ms(box, xs, reps=20):
    """(median CUDA-event ms, median wall ms) of box.update over reps
    updates after 3: the events bracket the update on the pane's
    stream (its host staging, upload, replay or body, and pull: the
    stream is idle before it, so the first event fires at the call)."""
    import torch
    for i in range(3):
        box.update(xs[i % len(xs)])
    ev, wall = [], []
    for i in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record(box.stream)
        t0 = time.perf_counter()
        box.update(xs[i % len(xs)])
        wall.append((time.perf_counter() - t0) * 1e3)
        b.record(box.stream)
        b.synchronize()
        ev.append(a.elapsed_time(b))
    return statistics.median(ev), statistics.median(wall)


def update_kernels(box, xs, reps=5):
    """torch.profiler over reps updates: (kernels an update, copies an
    update, the kernels' device busy ms an update, the copies' device
    ms an update). Inside a graph a device-to-device copy is listed as
    a kernel."""
    import torch
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU,
                        torch.profiler.ProfilerActivity.CUDA]) as prof:
        for i in range(reps):
            box.update(xs[i % len(xs)])
        torch.cuda.synchronize()
    dev = [e for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    copies = [e for e in dev if e.key.startswith(("Memcpy", "Memset"))]
    kern = [e for e in dev if e not in copies]
    return (sum(e.count for e in kern) / reps,
            sum(e.count for e in copies) / reps,
            sum(e.self_device_time_total for e in kern) / reps / 1e3,
            sum(e.self_device_time_total for e in copies) / reps / 1e3)


def display_pane_phase():
    """Phase 14, the panes: bank4's display engine (RF at 4,096,000
    samples, AF0 and BB0 at 24576, 9 panes) and chan64's (RF at 786,432,
    9 panes), graphed and eager (graph=False), each prepared: one graph
    a (pane, block length); DISPLAY_UPDATES updates of each pane kind
    with display_controls between them, every frame bit-equal to the
    eager twin's, and on AF0 a graphed twin kept at 60 dB whose frames
    equal until the dynamic range changes and differ after; then each
    pane's update ms (events, wall) and kernels, graphed and eager."""
    import dataclasses

    from pysdr_tpu_torch.models.display import DisplayEngine, ThreeBox

    out = {}
    for kind, tags in (("bank4", ("RF", "AF0", "BB0")), ("chan64", ("RF",))):
        bank, _ = graph_banks(kind, True)
        eng = {g: DisplayEngine(bank, show_baseband=kind == "bank4",
                                graph=g) for g in (True, False)}
        t0 = time.perf_counter()
        eng[True].prepare()
        t_prep = time.perf_counter() - t0
        eng[False].prepare()
        n_panes = len(eng[True].panes)
        check(eng[True].graph_count == n_panes
              and all(b.graph_count == 1 for b in eng[True].panes)
              and eng[False].graph_count == 0,
              f"{kind} display: {eng[True].graph_count} graphs over "
              f"{n_panes} panes, eager {eng[False].graph_count}")
        print(f"{kind} display: {n_panes} panes, {eng[True].graph_count} "
              f"graphs (one a pane and block length), captured in "
              f"{t_prep:.2f} s", flush=True)
        for seed, tag in enumerate(tags):
            g, e = pane_of(eng[True], tag), pane_of(eng[False], tag)
            n = g.lengths[0]
            xs = host_blocks(n, 8, 140 + seed)
            keep = None
            if tag == "AF0":
                keep = ThreeBox(dataclasses.replace(g.cfg), device="cuda",
                                stream=eng[True].stream)
                keep.prepare(n)
            t0 = time.perf_counter()
            for k in range(DISPLAY_UPDATES):
                for box in (g, e):
                    display_controls(box, k)
                fg, fe = g.update(xs[k % 8]), e.update(xs[k % 8])
                check(frames_equal(fg, fe), f"{kind} {tag} update {k}: "
                      "the graphed frame differs from the eager one")
                if keep is not None:
                    if k != 23:
                        display_controls(keep, k)
                    fk = keep.update(xs[k % 8])
                    same = frames_equal(fg, fk)
                    check(same == (k < 23), f"{kind} {tag} update {k}: "
                          f"the frame {'equals' if same else 'differs from'}"
                          " the twin kept at 60 dB")
            print(f"{kind} {tag} ({n} samples): {DISPLAY_UPDATES} updates "
                  "graphed and eager bit-equal across a retune, a DR "
                  "change, a clear and a peak-height change"
                  + (", the DR change shown in the next frame"
                     if keep is not None else "")
                  + f" ({time.perf_counter() - t0:.1f} s)", flush=True)
            res = {"samples": n}
            for mode, box in (("graph", g), ("eager", e)):
                ev, wall = update_ms(box, xs)
                kern, copies, busy, copy_ms = update_kernels(box, xs)
                res.update({f"update_ms_events_{mode}": ev,
                            f"update_ms_wall_{mode}": wall,
                            f"kernels_{mode}": kern,
                            f"copies_{mode}": copies,
                            f"busy_ms_{mode}": busy,
                            f"copy_ms_{mode}": copy_ms})
            print(f"  {tag}: update graphed {res['update_ms_events_graph']:.3f}"
                  f" ms (events) / {res['update_ms_wall_graph']:.3f} ms "
                  f"(wall), {res['kernels_graph']:.0f} kernels, "
                  f"{res['copies_graph']:.0f} copies, busy "
                  f"{res['busy_ms_graph']:.3f} ms, copies "
                  f"{res['copy_ms_graph']:.3f} ms; eager "
                  f"{res['update_ms_events_eager']:.3f} / "
                  f"{res['update_ms_wall_eager']:.3f} ms, "
                  f"{res['kernels_eager']:.0f} kernels, "
                  f"{res['copies_eager']:.0f} copies, busy "
                  f"{res['busy_ms_eager']:.3f} ms, copies "
                  f"{res['copy_ms_eager']:.3f} ms", flush=True)
            check(res["kernels_graph"] > 0, f"{kind} {tag}: torch.profiler "
                  "saw no kernel of the graph")
            out[f"{tag} {kind}"] = res
    return out


def display_e2e_phase(tmp, warm=4, blocks=24):
    """Phase 14, end to end: bank4 from a looped CS8 replay through the
    App at --pipeline-depth 2, with --psd --psd-every 1 graphed, the same
    with the eager display (graph=False) and with no display, in turns
    (E2E_DISPLAY_ROUNDS rounds, the order reversed every other round):
    Msamp/s over `blocks` blocks after `warm`, the stages a block, and
    the wall ms the executive's per-block hook (psd_callback) takes a
    block. The last RF frame of the graphed run equals the eager run's
    (the same blocks from the file's start), and shows RX0's AM carrier
    among its peaks."""
    import numpy as np
    import torch

    from pysdr_tpu_torch import app
    from pysdr_tpu_torch.models.display import DisplayEngine

    path = os.path.join(tmp, "bank4_cs8_e2e.dat")
    bank4_cs8(path)
    argv = ["--device", "cuda", "--replay", path, *BANK4, "--wire", "i8",
            "--audio-wire", "i16", "--pipeline-depth", "2"]
    psd = ["--psd", "--psd-every", "1"]
    out = {t: {"msps": [], "hook_ms": [], "stages": []}
           for t in ("graph", "eager", "none")}
    order = ("graph", "eager", "none")
    for r in range(E2E_DISPLAY_ROUNDS):
        frames = {}
        for tag in (order if r % 2 == 0 else order[::-1]):
            a = app.App(app.build_parser().parse_args(
                [*argv, *(psd if tag != "none" else [])]))
            if tag == "eager":
                a.display = DisplayEngine(a.bank, decimate=1, graph=False)
                a.display.rf.cfg.pan_dr_db = a.args.pan_dr
            ex = a.ex
            hook_ms = []
            if ex.psd_callback is not None:
                tap = ex.psd_callback

                def timed(e, audio, tap=tap, hook_ms=hook_ms):
                    t0 = time.perf_counter()
                    tap(e, audio)
                    hook_ms.append((time.perf_counter() - t0) * 1e3)
                ex.psd_callback = timed
            ex.prepare()
            ex.run(n_blocks=warm)
            torch.cuda.synchronize()
            del hook_ms[:]
            t0 = time.perf_counter()
            ex.run(n_blocks=warm + blocks)
            dt = time.perf_counter() - t0
            ex.stop()
            check(ex.n_blocks == warm + blocks,
                  f"{tag}: {ex.n_blocks} blocks")
            msps = blocks * a.bank.design.in_block / dt / 1e6
            rep = ex.stage_report()
            hook = statistics.median(hook_ms) if hook_ms else 0.0
            out[tag]["msps"].append(msps)
            out[tag]["hook_ms"].append(hook)
            out[tag]["stages"].append(rep)
            if a.display is not None:
                check(a.display.graph_count == (len(a.display.panes)
                                                if tag == "graph" else 0),
                      f"{tag}: {a.display.graph_count} display graphs")
                frames[tag] = (a.display.frames["RF"], a.display.rf,
                               a.cfg.receivers[0].fc_hz)
            print(f"bank4 replay end to end, display {tag}: {msps:.1f} "
                  f"Msamp/s ({dt * 1e3 / blocks:.2f} ms a block), hook "
                  f"{hook:.2f} ms a block (median), stages ms/block "
                  + " ".join(f"{k} {v:.2f}" for k, v in rep.items()),
                  flush=True)
        fg, box, fc0 = frames["graph"]
        check(frames_equal(fg, frames["eager"][0]), "end to end: the "
              "graphed display's last RF frame differs from the eager one")
        df = box.design.fs / box.cfg.nfft
        near = np.abs(fg.peak_freqs_hz - fc0) <= 2 * df
        check(np.isfinite(fg.psd_db).all() and near.any(),
              f"end to end: RX0's carrier at {fc0} Hz not among the RF "
              f"peaks {fg.peak_freqs_hz}")
    print("display end to end: " + json.dumps(
        {t: {"msps": v["msps"], "hook_ms": v["hook_ms"]}
         for t, v in out.items()}), flush=True)
    return out


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
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {kind} count {torch.cuda.device_count()}")
    print(card_line(), flush=True)

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
    with tempfile.TemporaryDirectory() as tmp:
        phase("10 mesh")
        add(mesh_cli_phase(tmp))
        mesh_launches, mesh_res = mesh_stream_phase()
        add(mesh_launches)
        print("mesh phase: " + json.dumps(mesh_res), flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        phase("11 host surface")
        host_surface_phase(tmp)
    phase("12 bench")
    bench_line = bench_phase()
    phase("13 graph")
    graph_phase()
    with tempfile.TemporaryDirectory() as tmp:
        phase("14 display")
        print("display phase: " + json.dumps(display_pane_phase()),
              flush=True)
        display_e2e_phase(tmp)

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
    print(bench_line)
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
