"""The control of a cell's comparison: the plain reference put in the
program's place with the operands of its matrix products rounded to TF32
(the precision below the float32 the configurations state), judged by
the same numbers and limits as a run. It has to come out not correct.
For a chain with a tap (harness.py), the chain's reference output under
TF32, from the stream's start, stands in for the tap's output too, and
its own numbers are read beside the audio's.

    python3 sdrbench/control.py --workload <cell> --seeds 1 2 3 \\
        --blocks <blocks a window delivers>

prints one JSON line a seed with the control's numbers beside the cell's
limits, from the same scene and the same seeded sample of blocks as a
run whose window delivered `--blocks` blocks. The benchmark's own runs do
not run it.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

_HERE = os.path.dirname(os.path.abspath(__file__))
if sys.path and os.path.abspath(sys.path[0] or ".") == _HERE:
    sys.path[0] = os.path.dirname(_HERE)

from sdrbench import harness, reference, scene  # noqa: E402


def readings(c: harness.Cell, seed: int, n_blocks: int, device) -> dict:
    """{check: (control's value, limit)} for a seed."""
    import torch
    dev = torch.device(device)
    cfg, tr = c.config, c.traffic
    fmt = scene.capture_format(tr["capture"])
    raw = scene.to_capture(scene.make_scene(cfg["scene"], seed, dev), fmt)
    chain = reference.chain_of(cfg["reference"], cfg["scene"]["fc"],
                               tr["block"])
    keeper = harness.Keeper(tr["compare_blocks"], seed)
    warm = int(tr["warm_blocks"])
    window = range(warm, warm + n_blocks)
    for i in window:
        keeper.offer(i, None)
    tf32 = reference.Arith(tf32=True)
    blocks = {}
    for i in keeper.blocks():
        audio, _ = harness.reference_audio(chain, raw, fmt, tr["wire"], i,
                                           dev, tf32)
        blocks[i] = reference.audio_wire(audio, tr["audio_wire"])
    outputs = None
    if harness.has_tap(chain):
        ctl = harness.reference_outputs(chain, raw, fmt, tr["wire"],
                                        window[-1], dev, tf32)
        outputs = {i: ctl[i] for i in harness.settled(chain, window)}
    return harness.compare(c, chain, raw, blocks, dev, log=lambda *a: None,
                           outputs=outputs)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="sdrbench/control.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--blocks", type=int, required=True)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    c = harness.cell(a.workload)
    for seed in a.seeds:
        got = readings(c, seed, a.blocks, a.device)
        print(json.dumps({"workload": a.workload, "seed": seed,
                          "correct": harness.passed(got),
                          "checks": {k: {"value": v, "limit": lim}
                                     for k, (v, lim) in got.items()}}),
              flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
