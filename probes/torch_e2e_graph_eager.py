#!/usr/bin/env python3
"""Where the end-to-end time goes with the graphed step: the bench's
bank4 and chan64 replays (and the 2.048 MHz f32 one) through the App's
executive, in one process, with the bank's step graphed (as the app runs
it), with an eager twin of the same bank (graph=False) swapped in, and
graphed beside a shell loop that keeps one more CPU core busy, in turns
over `--rounds` rounds.

    python3 probes/torch_e2e_graph_eager.py [--rounds 3]

Each run is pysdr_tpu_torch.bench._run_e2e (2 warm blocks, then 5
timed repetitions) on the same replay files; prints the card's name and
power limit, then a line a run: RF Msamp/s and the per-stage ms a block.
The read, quantize and pin+issue stages run on the prefetch thread; if
they change with the mode, the step's issue is not what sets them.
Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args(argv)

    from pysdr_tpu_torch import app as app_mod
    from pysdr_tpu_torch import bench
    from pysdr_tpu_torch.models.channelizer_bank import ChannelizerBank
    from pysdr_tpu_torch.models.receiver import ReceiverBank

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    base_app = app_mod.App

    class EagerApp(base_app):
        """The App with its bank's eager twin (graph=False) swapped in
        before the executive first runs."""

        def __init__(self, a):
            super().__init__(a)
            b = self.bank
            if isinstance(b, ChannelizerBank):
                twin = ChannelizerBank(b.cfg, audio_wire=b.audio_wire,
                                       device=b.device, graph=False)
            else:
                twin = ReceiverBank(b.cfg, emit_baseband=b.emit_baseband,
                                    audio_wire=b.audio_wire,
                                    device=b.device, graph=False)
            self.bank = self.ex.bank = twin

    with tempfile.TemporaryDirectory() as td:
        p2 = os.path.join(td, "e2e.dat")
        bench._write_am_dat(p2, fs=2.048e6, n=1 << 22)
        p8 = os.path.join(td, "e2e8m.dat")
        bench._write_am_dat(p8, fs=8e6, n=1 << 23, offset_hz=750e3)
        p64 = os.path.join(td, "e2e64.dat")
        bench._write_am_dat(p64, fs=12.288e6, n=1 << 23, offset_hz=0.0)
        runs = {
            "f32": (["--replay", p2, "--fs", "2.048", "--block", "16384",
                     "--fc", "100.0", "--wire", "f32"], 50),
            "bank4": (["--replay", p8, "--fs", "8.0", "--block", "24576",
                       "--fc", "100.0", "100.5", "101.0", "101.5",
                       "--modes", "AM", "NFM", "USB", "CW", "--wire", "i8",
                       "--audio-wire", "i16"], 30),
            "chan64": (["--replay", p64, "--channelize", "64", "--fs",
                        "12.288", "--block", "12288", "--fc", "100.0",
                        "--wire", "i8", "--audio-wire", "i8"], 40),
        }
        modes = ("graph", "eager", "graph+spin")
        for r in range(args.rounds):
            order = modes if r % 2 == 0 else modes[::-1]
            for mode in order:
                for name, (argv_e2e, n) in runs.items():
                    spin = None
                    app_mod.App = EagerApp if mode == "eager" else base_app
                    if mode == "graph+spin":
                        spin = subprocess.Popen(
                            ["sh", "-c", "while :; do :; done"])
                    try:
                        e = bench._run_e2e(["--device", "cuda", *argv_e2e],
                                           n_blocks=n)
                    finally:
                        app_mod.App = base_app
                        if spin is not None:
                            spin.kill()
                            spin.wait()
                    st = e["stage_ms"]
                    print(f"round {r} {mode} {name}: "
                          f"{e['samples_per_s'] / 1e6:.1f} Msamp/s "
                          f"({e['sps_min'] / 1e6:.1f}-"
                          f"{e['sps_max'] / 1e6:.1f}), {e['block_ms']:.2f}"
                          f" ms a block; read {st['read']} quantize "
                          f"{st['quantize']} pin+issue {st['pin+issue']} "
                          f"dispatch {st['dispatch']} drain {st['drain']};"
                          f" correct {e['correct']}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
