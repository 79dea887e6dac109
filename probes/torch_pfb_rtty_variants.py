"""What holds the port's PFB branch filter and RTTY matched filter back:
time them on the card beside variants that each drop or change one part
of the design.

    python3 probes/torch_pfb_rtty_variants.py  # from the root of a checkout

Builds pysdr_tpu_torch/csrc/{scan,pfb,rtty}.cu as they are ("committed")
and text edits of pfb.cu or rtty.cu, each into its own library (all
builds at once):

  pfb_nocompute  pfb_branch stages and stores but does no multiply-add
                 (wrong on purpose: the floor of staging plus the stores)
  pfb_run16      16 output rows a thread instead of 32 (twice the blocks)
  pfb_stcs       v written with streaming-store hints (__stcs)
  rtty_nofma     rtty_scores without its multiply-add loop (wrong on
                 purpose: the floor of the launch, the staging and the
                 stores)
  rtty_group1    one offset a thread at a time instead of eight
  rtty_group4    four offsets a thread
  rtty_warps8    8 warps a block instead of 16
  rtty_noprefetch  the templates staged in one loop before the soft rows,
                 not loaded ahead of them

and times pfb_branch at chan64's (49152, 64, 12) on the i8 and f32 wires
and rtty_scores at the 100-channel decoder's (43, 4096, 100, 64)
(torch.profiler device time, mean of 30 calls), beside a converting
copy of the wire block into a tensor of v's size (the same bytes in and
out as pfb_branch). Needs one CUDA card and nvcc; prints the card's name
and power limit first.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PFB_FMA = ("            acc.x = fmaf(h[kk], s.x, acc.x);\n"
           "            acc.y = fmaf(h[kk], s.y, acc.y);\n")
VARIANTS = {
    "committed": [],
    "pfb_nocompute": [("pfb.cu", PFB_FMA, "")],
    "pfb_run16": [("pfb.cu", "constexpr int kRun = 32;",
                   "constexpr int kRun = 16;")],
    "pfb_stcs": [("pfb.cu", "vo[(size_t)(base + i) * nch] = acc;",
                  "__stcs(&vo[(size_t)(base + i) * nch], acc);")],
    "rtty_nofma": [("rtty.cu",
                    "acc[q] = fmaf(win[(u + q) % kGroup], ht, acc[q]);",
                    "acc[q] = ht;")],
    "rtty_group1": [("rtty.cu", "constexpr int kGroup = 8;",
                     "constexpr int kGroup = 1;")],
    "rtty_group4": [("rtty.cu", "constexpr int kGroup = 8;",
                     "constexpr int kGroup = 4;")],
    "rtty_warps8": [("rtty.cu", "constexpr int kWarps = 16;",
                     "constexpr int kWarps = 8;")],
    "rtty_noprefetch": [("rtty.cu", "constexpr int kPrefetch = 2;",
                         "constexpr int kPrefetch = 0;")],
}
WRONG = ("pfb_nocompute", "rtty_nofma")
PFB = [(49152, 64, 12, "i8"), (49152, 64, 12, "f32")]
RTTY = (43, 4096, 100, 64)


def device_us(fn, name, reps=30):
    import torch
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    ev = [e for e in prof.key_averages() if name in e.key
          and e.device_type == torch.autograd.DeviceType.CUDA]
    return (sum(e.self_device_time_total for e in ev)
            / max(1, sum(e.count for e in ev)))


def start_build(tmp, name, edits):
    """Write the variant's sources and start nvcc on them; returns (path
    of the library, the process)."""
    from pysdr_tpu_torch.kernels import build
    srcs = []
    for src in build.SOURCES:
        with open(os.path.join(build.CSRC, src)) as f:
            text = f.read()
        for fname, old, new in edits:
            if fname != src:
                continue
            if old not in text:
                raise SystemExit(f"{name}: {src} no longer holds {old!r}")
            text = text.replace(old, new)
        path = os.path.join(tmp, f"{name}_{src}")
        with open(path, "w") as f:
            f.write(text)
        srcs.append(path)
    lib = os.path.join(tmp, f"lib_{name}.so")
    return lib, subprocess.Popen(
        [build._nvcc(), *build.NVCC_FLAGS, "-shared", "-o", lib, *srcs],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def main():
    import numpy as np
    import torch
    sys.path.insert(0, ROOT)
    from pysdr_tpu_torch.kernels import build, pfb
    from pysdr_tpu_torch.kernels import rtty as krtty
    from pysdr_tpu_torch.models import rtty
    from pysdr_tpu_torch.ops import channelizer, cplx

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    pfb_cases = []
    for m, nch, k, wire in PFB:
        design = channelizer.ChannelizerDesign(fs_in=12.288e6,
                                               n_channels=nch,
                                               taps_per_branch=k)
        taps = torch.from_numpy(channelizer.pack_branch_weights(
            design.prototype(), nch)).to(dev)
        x = rng.uniform(-1.0, 1.0, (m * nch, 2)).astype(np.float32)
        xw = torch.from_numpy(cplx.quantize_host(x, wire)).to(dev)
        hist = torch.from_numpy(
            (rng.standard_normal((k - 1) * nch) + 1j
             * rng.standard_normal((k - 1) * nch)).astype(np.complex64)
        ).to(dev)
        xc = torch.view_as_complex(cplx.dequantize(xw).contiguous())
        ref = channelizer.branch_filter_ref(xc, hist, taps)
        out = torch.empty((m * nch, 2), dtype=torch.float32, device=dev)
        us = device_us(lambda: out.copy_(xw), "")
        print(f"copy of the {wire} wire block into v's bytes "
              f"{(m, nch, k)}: {us:.3f} us", flush=True)
        pfb_cases.append(((m, nch, k, wire), xw, hist, taps, ref))
    f, nfft, nch, t_rows = RTTY
    design = rtty.RTTYDesign(fs=96e3)
    tmpl = torch.from_numpy(rtty.char_templates(design)).to(dev)
    mark = rng.integers(0, nfft, nch).astype(np.int32)
    space = (mark - design.shift_bins) % nfft
    rargs = (torch.from_numpy(rng.uniform(0.0, 3.0, (f, nfft))
                              .astype(np.float32)).to(dev),
             torch.from_numpy(mark).to(dev),
             torch.from_numpy(space.astype(np.int32)).to(dev),
             torch.from_numpy(rng.uniform(-1.0, 1.0, (t_rows, nch))
                              .astype(np.float32)).to(dev), tmpl)
    rref = rtty.rtty_scores_ref(*rargs)
    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        builds = {name: start_build(tmp, name, edits)
                  for name, edits in VARIANTS.items()}
        for name, (lib, proc) in builds.items():
            out, _ = proc.communicate()
            if proc.returncode != 0:
                raise SystemExit(f"{name}: nvcc failed\n{out}")
        for name, (lib, _) in builds.items():
            build._lib = build._declare(ctypes.CDLL(lib))
            print(f"== {name}", flush=True)
            for shape, xw, hist, taps, (v_ref, h_ref) in pfb_cases:
                v, nh = pfb.pfb_branch(xw, hist, taps)
                torch.cuda.synchronize()
                rel = ((v - v_ref).abs().max() / v_ref.abs().max()).item()
                if name not in WRONG and (rel > 1e-5
                                          or not torch.equal(nh, h_ref)):
                    raise SystemExit(f"{name} pfb_branch {shape}: rel {rel}")
                us = device_us(lambda: pfb.pfb_branch(xw, hist, taps),
                               "pfb_branch_kernel")
                print(f"  pfb_branch {shape}: {us:.3f} us", flush=True)
            soft, sc = krtty.rtty_scores(*rargs)
            torch.cuda.synchronize()
            err = (sc - rref[1]).abs().max().item()
            if name not in WRONG and (err > 1e-4
                                      or not torch.equal(soft, rref[0])):
                raise SystemExit(f"{name} rtty_scores: err {err}")
            us = device_us(lambda: krtty.rtty_scores(*rargs),
                           "rtty_scores_kernel")
            print(f"  rtty_scores {RTTY}: {us:.3f} us", flush=True)


if __name__ == "__main__":
    main()
