"""What holds the port's scan kernels back: time them on the card beside
variants that each drop one part of the design.

    python3 probes/torch_scan_variants.py      # from the root of a checkout

Builds pysdr_tpu_torch/csrc/scan.cu as it is ("committed") and two text
edits of it, each into its own library with pfb.cu and rtty.cu:

  blockidx   the tile index from blockIdx instead of the per-row atomic
             ticket (right only because the card starts blocks in order)
  nolook     no look-back: every tile starts from y = 0 / the gate set
             (wrong on purpose; its results are not checked)

and times linrec and sr_latch (torch.profiler device time, mean of 30
calls) at the main paths' shapes, with `a` as the main path gives it,
beside a `clone()` of b (the card's copy rate for the same bytes). Needs
one CUDA card and nvcc; prints the card's name and power limit first.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

VARIANTS = {
    "committed": [],
    "blockidx": [("    take_ticket(tickets, batch, tiles_per_row, &s_row, "
                  "&s_tile);",
                  "    { s_row = blockIdx.x % batch; "
                  "s_tile = blockIdx.x / batch; }")],
    "nolook": [("    const Pair e = linrec_lookback(row0, tile, epoch, lane);",
                "    const Pair e = {1.f, 0.f};"),
               ("      before = latch_lookback(row0, tile, epoch, lane);",
                "      before = 1;")],
}
WRONG = ("nolook",)
# (B, n, k, a): chan64's and bank4's passes A and B and the AGC
LINREC = [(64, 12288, 4, "columns"), (64, 12288, 2, "columns"),
          (64, 192, 1, "scalar"), (4, 24576, 4, "columns"),
          (4, 24576, 2, "columns"), (4, 384, 1, "scalar")]
LATCH = [(64, 12288), (4, 24576)]


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


def build_variant(tmp, name, edits):
    from pysdr_tpu_torch.kernels import build
    with open(os.path.join(build.CSRC, "scan.cu")) as f:
        src = f.read()
    for old, new in edits:
        if old not in src:
            raise SystemExit(f"{name}: scan.cu no longer holds {old!r}")
        src = src.replace(old, new)
    cu = os.path.join(tmp, f"scan_{name}.cu")
    with open(cu, "w") as f:
        f.write(src)
    lib = os.path.join(tmp, f"lib_{name}.so")
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-shared", "-o", lib,
                    cu, os.path.join(build.CSRC, "pfb.cu"),
                    os.path.join(build.CSRC, "rtty.cu")],
                   check=True, capture_output=True, text=True)
    return build._declare(ctypes.CDLL(lib))


def main():
    import numpy as np
    import torch
    sys.path.insert(0, ROOT)
    from pysdr_tpu_torch.kernels import build
    from pysdr_tpu_torch.kernels import scan
    from pysdr_tpu_torch.ops import scanops

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    cases = []
    for bn, n, k, kind in LINREC:
        b = torch.from_numpy(rng.uniform(0, 1, (bn, n, k))
                             .astype(np.float32)).to(dev)
        yp = torch.from_numpy(rng.uniform(0, 1, (bn, k))
                              .astype(np.float32)).to(dev)
        if kind == "columns":
            a = torch.from_numpy(rng.uniform(0.9, 1, k).astype(np.float32)) \
                .to(dev).expand(bn, n, k)
            a_ref = a
        else:
            a, a_ref = 0.9921875, torch.full_like(b, 0.9921875)
        cases.append(((bn, n, k, kind), a, b, yp,
                      scanops.linrec_ref(a_ref, b, yp)))
        us = device_us(lambda: b.clone(), "")
        print(f"clone of b {(bn, n, k)}: {us:.3f} us", flush=True)
    latches = []
    for bn, n in LATCH:
        s = torch.from_numpy(rng.random((bn, n)) < 0.01).to(dev)
        r = torch.from_numpy(rng.random((bn, n)) < 0.01).to(dev)
        gp = torch.from_numpy((rng.random(bn) < 0.5)
                              .astype(np.float32)).to(dev)
        latches.append(((bn, n), s, r, gp, scanops.sr_latch_ref(s, r, gp)))
    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        for name, edits in VARIANTS.items():
            build._lib = build_variant(tmp, name, edits)
            scan._lookbacks.clear()
            print(f"== {name}", flush=True)
            for shape, a, b, yp, (y_ref, _) in cases:
                y, _ = scan.linrec(a, b, yp)
                torch.cuda.synchronize()
                rel = ((y - y_ref).abs().max() / y_ref.abs().max()).item()
                if name not in WRONG and rel > 1e-4:
                    raise SystemExit(f"{name} linrec {shape}: rel {rel}")
                us = device_us(lambda: scan.linrec(a, b, yp),
                               "linrec_kernel")
                print(f"  linrec {shape}: {us:.3f} us", flush=True)
            for shape, s, r, gp, (g_ref, _) in latches:
                g, _ = scan.sr_latch(s, r, gp)
                torch.cuda.synchronize()
                if name not in WRONG and not torch.equal(g, g_ref):
                    raise SystemExit(f"{name} sr_latch {shape} differs")
                us = device_us(lambda: scan.sr_latch(s, r, gp),
                               "sr_latch_kernel")
                print(f"  sr_latch {shape}: {us:.3f} us", flush=True)


if __name__ == "__main__":
    main()
