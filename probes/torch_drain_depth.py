#!/usr/bin/env python3
"""The executive's drain time on the card: a 4-block bank4 replay at
--pipeline-depth 2, through `python -m pysdr_tpu_torch ... --profile`, in
this checkout and in another one (say the parent commit, unpacked with
`git archive`), in turns: other, this, this, other.

    python3 probes/torch_drain_depth.py [OTHER_CHECKOUT]

The replay is a CS8 capture of bank4's four stations made on the card
(chip_smoke.bank4_cs8), so the host reads blocks faster than the
synth renders them and the drain shows what it waits for. Prints each
run's per-stage ms a block (read, upload, dispatch, drain) and the card's
name and power limit.
"""

from __future__ import annotations

import os
import re
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402


def stages(tree: str, path: str) -> dict:
    argv = [sys.executable, "-m", "pysdr_tpu_torch", "--device", "cuda",
            "--replay", path, "--no-loop", *chip_smoke.BANK4, "--wire", "i8",
            "--audio-wire", "i16", "--blocks", "4", "--pipeline-depth", "2",
            "--profile"]
    out = subprocess.run(argv, cwd=tree, capture_output=True, text=True,
                         timeout=600)
    line = [ln for ln in out.stdout.splitlines()
            if ln.startswith("per-stage ms/block:")]
    if out.returncode or not line:
        raise SystemExit(f"{tree}: rc {out.returncode}\n{out.stdout}\n"
                         f"{out.stderr[-3000:]}")
    return {k: float(v) for k, v in re.findall(r"(\w+)=([0-9.]+)", line[0])}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    other = os.path.abspath(argv[0]) if argv else None
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "bank4_cs8.dat")
        chip_smoke.bank4_cs8(path)
        order = [other, ROOT, ROOT, other] if other else [ROOT, ROOT]
        for tree in order:
            s = stages(tree, path)
            tag = "this" if tree == ROOT else "other"
            print(f"{tag} {tree}: drain {s['drain']:.1f} ms a block; "
                  f"{s}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
