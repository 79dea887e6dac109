#!/usr/bin/env python3
"""The 100-station RTTY run of chip_smoke.py phase 9 in this checkout and
in another one (say the parent commit, unpacked with `git archive`), in
turns: other, this, this, other. Each run is a child process in its own
tree: the layout of tests/test_rtty.py (100 stations at 96 kHz, written
once as a 2.048 MHz capture) replayed from 0.75 s through the entry
point with --fs-out 96 --block 24576 --rtty 0, each RTTYDecoder
decode_block call timed on the host's clock (the call pulls its scores,
so its time covers the device work).

    python3 probes/torch_rtty_pair.py [OTHER_CHECKOUT]

Prints the card's name and power limit, then one line a run: the
decoder's wall ms a block (median after the first block, min, max), the
stations decoded in their own channel, and the decoder's stage_ms where
its tree has one. Needs one CUDA card.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CHILD = r"""
import json, statistics, sys, time
import numpy as np
sys.path.insert(0, ".")
import chip_smoke as cs
from pysdr_tpu_torch import app
from pysdr_tpu_torch.models import rtty

calls = []
orig = rtty.RTTYDecoder.decode_block

def timed(self, *args, **kw):
    t0 = time.perf_counter()
    out = orig(self, *args, **kw)
    calls.append((time.perf_counter() - t0) * 1e3)
    return out

rtty.RTTYDecoder.decode_block = timed
rc, a = app.run_cli(["--device", "cuda", "--replay", sys.argv[1], "0.75",
                     *cs.RTTY, "--fs-out", str(cs.RTTY_FS / 1e3),
                     "--block", str(cs.RTTY_BLOCK)])
dec = a.rtty
carriers = np.asarray(json.loads(sys.argv[2]))
got = sum(f"ST{cs.station_of(dec.design, c['mark_bin'], carriers):02d}"
          in c["text"] for c in dec.channels)
print(json.dumps({"rc": rc, "ms": calls, "stations": got,
                  "median_ms": statistics.median(calls[1:]),
                  "stage_ms": getattr(dec, "stage_ms", None)}))
"""


def run(tree: str, path: str, carriers: str) -> dict:
    out = subprocess.run([sys.executable, "-c", CHILD, path, carriers],
                         cwd=tree, capture_output=True, text=True,
                         timeout=600)
    lines = out.stdout.strip().splitlines()
    if out.returncode or not lines:
        raise SystemExit(f"{tree}: rc {out.returncode}\n{out.stdout[-3000:]}"
                         f"\n{out.stderr[-3000:]}")
    return json.loads(lines[-1])


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    other = os.path.abspath(argv[0]) if argv else None
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    order = [other, ROOT, ROOT, other] if other else [ROOT, ROOT]
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "rtty100.dat")
        carriers = json.dumps(cs.rtty_composite(path).tolist())
        for tree in order:
            res = run(tree, path, carriers)
            ms = res["ms"]
            print(f"{'this' if tree == ROOT else 'other'}: decoder "
                  f"{res['median_ms']:.3f} ms a block (median after the "
                  f"first; {min(ms):.3f}-{max(ms):.3f}, {len(ms)} blocks), "
                  f"{res['stations']} stations, rc {res['rc']}, stage_ms "
                  f"{json.dumps(res['stage_ms'])}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
