"""`python -m pysdr_tpu_torch`: CLI -> config -> source -> executive ->
wav sinks, on the card (counterpart of pysdr_tpu/app.py's main path).

The parser, build_config and source picker are pysdr_tpu.app's own
(jax-free at import), plus `--device {cuda,cpu}`. Flags for features not
yet ported exit 2 with a message instead of being ignored.
"""

from __future__ import annotations

import os
import sys
import time

from pysdr_tpu import tables
from pysdr_tpu.app import build_config, build_parser as _jax_parser
from pysdr_tpu.app import build_source

# flags of pysdr_tpu's CLI whose feature is not in this package yet
UNPORTED = ("channelize", "mesh", "rtty", "psd", "bb", "png_dir", "web",
            "hamlib", "hamlib_port", "udp_port", "rig", "hop",
            "hop_schedule", "rtl_tcp", "save_iq", "save_baseband",
            "save_demod", "fifo", "aux_wav", "preset", "list_presets",
            "fldigi_ports", "memmon", "internals", "jax_trace")


def build_parser():
    ap = _jax_parser()
    ap.prog = "pysdr_tpu_torch"
    ap.description = "Multi-channel SDR receiver (headless), PyTorch/CUDA"
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="where the DSP runs (default cuda; never falls "
                         "back to the CPU)")
    return ap


def unported_flags(ap, args) -> list[str]:
    """The unported flags given on this command line."""
    return ["--" + dest.replace("_", "-") for dest in UNPORTED
            if getattr(args, dest) != ap.get_default(dest)]


class App:
    """Owns the bank, source, executive and sinks for one run."""

    def __init__(self, args):
        import dataclasses

        from pysdr_tpu.runtime.audio import create_players
        from pysdr_tpu.runtime.watchdog import PairWatchDog, WatchDog
        from pysdr_tpu_torch.models.receiver import ReceiverBank
        from pysdr_tpu_torch.runtime.executive import Executive

        self.args = args
        cfg = build_config(args)
        self.source, fs_src, fc_src = build_source(args, cfg)
        if args.replay:
            repl = {}
            if fs_src != cfg.fs_in:
                repl["fs_in"] = fs_src          # rate plan from the header
            if args.foffset is None and fc_src:
                # NCO offsets derive from the file's center
                repl["foffset_hz"] = cfg.receivers[0].fc_hz - fc_src
            if repl:
                cfg = dataclasses.replace(cfg, **repl)
        self.cfg = cfg
        self.bank = ReceiverBank(cfg, audio_wire=args.audio_wire,
                                 device=args.device)
        d = self.bank.design
        self.ex = Executive(
            self.bank, self.source, realtime=args.realtime,
            loop_source=not args.no_loop, wire=args.wire,
            pipeline_depth=args.pipeline_depth,
            prefetch=not args.no_prefetch, want_bb=False)
        if args.ant and hasattr(self.source, "set_antenna"):
            self.source.set_antenna(args.ant)
        if hasattr(self.source, "set_freq"):
            tv = cfg.transverter_hz

            def _follow_device(center):
                self.source.set_freq(center + tv)
            self.bank.on_device_retune = _follow_device
        self.players = create_players(
            self.bank, self.ex.audio_rings, d.fs_out,
            wav_prefix=args.wav, stereo_pairs=args.stereo,
            realtime=args.realtime)
        self.watchdogs = []
        if args.realtime:
            rings = self.ex.audio_rings
            wd_kw = {"log_path": args.watchdog_log} \
                if args.watchdog_log else {}
            if args.stereo:
                for i in range(0, len(rings), 2):
                    self.watchdogs.append(
                        PairWatchDog(rings[i:i + 2], d.fs_out, **wd_kw)
                        if i + 1 < len(rings)
                        else WatchDog(rings[i], d.fs_out, **wd_kw))
            else:
                self.watchdogs = [WatchDog(r, d.fs_out, **wd_kw)
                                  for r in rings]

    def run(self) -> int:
        for w in self.watchdogs:
            w.start()
        for p in self.players:
            if self.args.realtime:
                p.start_playback(min_buffered=self.args.delay)
            else:
                p.realtime = False
                p.start_playback(min_buffered=0, timeout=0.0)
        try:
            prof = self.ex.run(n_blocks=self.args.blocks,
                               duration_s=self.args.duration)
        finally:
            self.ex.stop()
            for w in self.watchdogs:
                w.stop()
            for p in self.players:
                p.stop(drain=True)
            if hasattr(self.source, "close"):
                self.source.close()
        if self.args.profile:
            print(prof.report())
            print("per-stage ms/block: " + "  ".join(
                f"{k}={v:.1f}" for k, v in self.ex.stage_report().items()))
        return 0


def run_cli(argv=None):
    """The whole CLI run: returns (exit code, the App or None when the
    command line was refused before one was built)."""
    ap = build_parser()
    args = ap.parse_args(argv)
    bad = unported_flags(ap, args)
    if bad:
        print(f"error: {bad[0]} is not yet ported to pysdr_tpu_torch",
              file=sys.stderr)
        return 2, None
    try:
        for m in (args.modes or [args.mode]):
            tables.mode_from_name(m)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2, None
    if args.replay and not os.path.exists(args.replay[0]):
        print(f"error: replay file not found: {args.replay[0]}",
              file=sys.stderr)
        return 2, None
    try:
        app = App(args)
    except (ValueError, RuntimeError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2, None
    t0 = time.monotonic()
    rc = app.run()
    dt = time.monotonic() - t0
    d = app.bank.design
    n = app.ex.n_blocks
    print(f"{n} blocks, {n * d.in_block / 1e6:.1f} Msamples RF in "
          f"{dt:.2f}s ({n * d.in_block / max(dt, 1e-9) / 1e6:.1f} Msamp/s), "
          f"{app.bank.n_rx} RX", flush=True)
    return rc, app


def main(argv=None) -> int:
    return run_cli(argv)[0]
