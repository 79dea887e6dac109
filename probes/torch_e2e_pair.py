#!/usr/bin/env python3
"""The bench's end-to-end suite in this checkout and in another one (say
the parent commit, unpacked with `git archive`), in turns: other, this,
this, other, each as `python -m pysdr_tpu_torch.bench e2e_suite` (the
.dat replays through the App's executive at full size: the f32, i16 and
i8 wires at 2.048 MHz, i8 at a 4x block, bank4 with and without the
prefetch thread, chan64).

    python3 probes/torch_e2e_pair.py [OTHER_CHECKOUT]

Prints the card's name and power limit, then one line a replay a run:
RF Msamp/s and the per-stage ms a block (read, quantize, pin+issue,
dispatch, drain), and the share of blocks drained while the executive
waited for its next one (idle_drain; none where the checkout keeps no
such counter). Needs one CUDA card.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def suite(tree: str) -> dict:
    out = subprocess.run([sys.executable, "-m", "pysdr_tpu_torch.bench",
                          "e2e_suite"], cwd=tree, capture_output=True,
                         text=True, timeout=1500)
    lines = out.stdout.strip().splitlines()
    if out.returncode or not lines:
        raise SystemExit(f"{tree}: rc {out.returncode}\n{out.stdout}\n"
                         f"{out.stderr[-3000:]}")
    return json.loads(lines[-1])


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    other = os.path.abspath(argv[0]) if argv else None
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    order = [other, ROOT, ROOT, other] if other else [ROOT, ROOT]
    for tree in order:
        tag = "this" if tree == ROOT else "other"
        res = suite(tree)
        for name, e in res.items():
            if not name.startswith("end_to_end"):
                continue
            st = e["stage_ms"]
            print(f"{tag} {name}: {e['samples_per_s'] / 1e6:.1f} Msamp/s "
                  f"({e['sps_min'] / 1e6:.1f}-{e['sps_max'] / 1e6:.1f}), "
                  f"{e['block_ms']:.2f} ms a block; read {st['read']} "
                  f"quantize {st['quantize']} pin+issue {st['pin+issue']} "
                  f"dispatch {st['dispatch']} drain {st['drain']} "
                  f"idle_drain {st.get('idle_drain', 'none')}; "
                  f"correct {e['correct']}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
