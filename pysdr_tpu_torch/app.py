"""`python -m pysdr_tpu_torch`: CLI -> config -> source -> executive ->
wav sinks, display and web viewer, on the card (counterpart of
pysdr_tpu/app.py).

The parser, build_config and source picker are pysdr_tpu.app's own
(jax-free at import), plus `--device {cuda,cpu}`. `--channelize N` builds
the polyphase channelizer bank instead of the receiver bank. Flags for
features not yet ported exit 2 with a message instead of being ignored.
"""

from __future__ import annotations

import os
import sys
import time

from pysdr_tpu import tables
from pysdr_tpu.app import _fs_out_hz, build_config, build_source
from pysdr_tpu.app import build_parser as _jax_parser

# flags of pysdr_tpu's CLI whose feature is not in this package yet
UNPORTED = ("mesh", "rtty", "hamlib", "hamlib_port", "udp_port", "rig",
            "hop", "hop_schedule", "rtl_tcp", "save_iq", "save_baseband",
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


def build_channelizer(args):
    """--channelize N: the polyphase channelizer bank and a synth (or
    replay) source. fs_in must be N * (k * fs_out) for a uniform k:1
    per-channel decimation; --fc gives the passband center; --mode
    applies to every channel. Returns (bank, source, config)."""
    from pysdr_tpu.io import datfile, synth
    from pysdr_tpu_torch.models.channelizer_bank import (
        ChannelizerBank, ChannelizerBankConfig, ChannelSettings)
    n = int(args.channelize)
    mode = tables.mode_from_name(args.mode)
    fs_in = args.fs * 1e6
    fc = (args.fc if args.fc is not None else [0.6])[0] * 1e6
    cs = ChannelSettings(mode=mode, video_bw_hz=args.video_bw * 1e3,
                         af_bw_hz=args.af_bw * 1e3, af_gain=args.af_gain,
                         agc_enabled=not args.no_agc,
                         squelch_db=args.squelch, auto_mute=args.auto_mute,
                         auto_mute_db=args.auto_mute_db)
    cfg = ChannelizerBankConfig(
        fs_in=fs_in, n_channels=n, fs_out=_fs_out_hz(args, [mode]),
        out_block=args.block, fc_hz=fc, channels=tuple(cs for _ in range(n)))
    bank = ChannelizerBank(cfg, audio_wire=args.audio_wire,
                           device=args.device)
    if args.replay:
        # the receiver path's source preference: the C++ streamer when
        # built, else the Python reader
        start = float(args.replay[1]) if len(args.replay) > 1 else 0.0
        if start == 0.0 and not args.no_native:
            from pysdr_tpu.runtime import native
            if native.available():
                try:
                    return bank, native.NativeStreamer(
                        args.replay[0], loop=not args.no_loop), cfg
                except OSError:
                    pass
        return bank, datfile.DatReader(args.replay[0], start_sec=start), cfg
    # synthetic passband: one station on every 4th channel center
    offs = cfg.center_freqs_hz() - fc
    kind = {tables.Mode.NFM: "fm", tables.Mode.USB: "usb",
            tables.Mode.LSB: "lsb", tables.Mode.CW: "cw"}.get(mode, "am")
    specs = [synth.SignalSpec(offset_hz=offs[i], mode=kind, amplitude=0.5,
                              audio_hz=300.0 + 50.0 * i)
             for i in range(0, n, 4)]
    src = synth.SynthSource(specs, fs_in, noise_rms=args.synth_noise, fc=fc)
    return bank, src, cfg


class App:
    """Owns the bank, source, executive, sinks, display and viewer for
    one run."""

    def __init__(self, args):
        import dataclasses

        from pysdr_tpu.runtime.audio import create_players
        from pysdr_tpu.runtime.watchdog import PairWatchDog, WatchDog
        from pysdr_tpu_torch.models.receiver import ReceiverBank
        from pysdr_tpu_torch.runtime.executive import Executive

        self.args = args
        if args.channelize:
            self.bank, self.source, self.cfg = build_channelizer(args)
            if args.bb:
                print("--bb is not available with --channelize; ignoring",
                      file=sys.stderr)
                args.bb = False
        else:
            cfg = build_config(args)
            self.source, fs_src, fc_src = build_source(args, cfg)
            if args.replay:
                repl = {}
                if fs_src != cfg.fs_in:
                    repl["fs_in"] = fs_src      # rate plan from the header
                if args.foffset is None and fc_src:
                    # NCO offsets derive from the file's center
                    repl["foffset_hz"] = cfg.receivers[0].fc_hz - fc_src
                if repl:
                    cfg = dataclasses.replace(cfg, **repl)
            self.cfg = cfg
            self.bank = ReceiverBank(cfg, emit_baseband=args.bb,
                                     audio_wire=args.audio_wire,
                                     device=args.device)
        d = self.bank.design

        self.display = None
        if args.psd or args.bb or args.png_dir or args.web is not None:
            from pysdr_tpu_torch.models.display import DisplayEngine
            self.display = DisplayEngine(self.bank, decimate=args.psd_every,
                                         show_baseband=args.bb)
            self.display.rf.cfg.pan_dr_db = args.pan_dr

        self.ex = Executive(
            self.bank, self.source, realtime=args.realtime,
            psd_callback=self._on_block if self.display else None,
            loop_source=not args.no_loop, wire=args.wire,
            pipeline_depth=args.pipeline_depth,
            prefetch=not args.no_prefetch, want_bb=args.bb)
        if args.ant and hasattr(self.source, "set_antenna"):
            self.source.set_antenna(args.ant)
        if hasattr(self.bank, "on_device_retune") \
                and hasattr(self.source, "set_freq"):
            tv = self.cfg.transverter_hz

            def _follow_device(center):
                self.source.set_freq(center + tv)
                if self.display is not None:
                    # the RF pane tracks the device passband
                    self.display.retune(center)
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
        self.web = None
        if args.web is not None:
            from pysdr_tpu.runtime.webview import WebViewer
            self.web = WebViewer(
                self.display, self.ex, port=args.web,
                presets_file=args.presets_file,
                save_iq_dtype=args.save_iq_dtype, save_dir=args.save_dir,
                source=self.source)
            print(f"live viewer: http://127.0.0.1:{self.web.port}/",
                  flush=True)

    def _on_block(self, ex, audio):
        """Per-block display tap: AF panes every block the decimation
        keeps, the RF pane every --psd-every blocks, the BB panes from
        the baseband the executive carried with this block."""
        disp = self.display
        bb_host = None
        if ex.drained_bb is not None and disp.wants_next_bb():
            bb_host = ex.drained_bb.cpu().numpy()
        disp(ex, audio)
        if ex.last_rf_block is not None \
                and ex.n_blocks % self.args.psd_every == 0:
            disp.update_rf(ex.last_rf_block)
        if bb_host is not None:
            disp.update_bb(bb_host)

    def start_services(self):
        if self.web:
            self.web.start()
        for w in self.watchdogs:
            w.start()
        for p in self.players:
            if self.args.realtime:
                p.start_playback(min_buffered=self.args.delay)
            else:
                p.realtime = False
                p.start_playback(min_buffered=0, timeout=0.0)

    def stop_services(self):
        """Stop every thread and server the app started, close the source,
        and export the display's waterfalls under --png-dir."""
        self.ex.stop()
        if self.web:
            self.web.stop()
        for w in self.watchdogs:
            w.stop()
        for p in self.players:
            p.stop(drain=True)
        if hasattr(self.source, "close"):
            self.source.close()
        if self.args.png_dir and self.display is not None:
            os.makedirs(self.args.png_dir, exist_ok=True)
            for tag in self.display.frames:
                self.display.export_png(
                    os.path.join(self.args.png_dir, f"{tag}.png"), tag)

    def run(self) -> int:
        self.start_services()
        try:
            prof = self.ex.run(n_blocks=self.args.blocks,
                               duration_s=self.args.duration)
        finally:
            self.stop_services()
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
