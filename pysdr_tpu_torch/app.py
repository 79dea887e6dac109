"""`python -m pysdr_tpu_torch`: CLI -> config -> source -> executive ->
sinks, recorders, control servers, hopper, RTTY decoder, display and web
viewer, on the card (counterpart of pysdr_tpu/app.py).

The parser, build_config and source picker are pysdr_tpu.app's own
(jax-free at import), plus `--device {cuda,cpu}`. `--channelize N` builds
the polyphase channelizer bank instead of the receiver bank. The host
services (hamlib, UDP, rig follow, hopper, fldigi, memmon, presets, the
wav/fifo/aux sinks, rtl_tcp and the web viewer) are the JAX package's
runtime and io modules, reused as they are; the .dat recorders and the
channelizer's replay reader are the port's io.datfile. The flags
of features not ported yet (`--mesh`, `--jax-trace`) exit 2 with a
message instead of being ignored.
"""

from __future__ import annotations

import collections
import os
import sys
import time

import numpy as np

from pysdr_tpu import tables
from pysdr_tpu.app import (_fs_out_hz, _rtl_tcp_source, build_config,
                           build_source)
from pysdr_tpu.app import build_parser as _jax_parser

# flags of pysdr_tpu's CLI whose feature is not in this package yet
UNPORTED = ("mesh", "jax_trace")
# features the channelizer bank does not carry (pysdr_tpu.app's list)
NOT_WITH_CHANNELIZE = ("rtty", "hamlib", "rig", "hop", "hop_schedule")


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
    """--channelize N: the polyphase channelizer bank and a synth, replay
    or rtl_tcp source. fs_in must be N * (k * fs_out) for a uniform k:1
    per-channel decimation; --fc gives the passband center; --mode
    applies to every channel. Returns (bank, source, config)."""
    from pysdr_tpu.io import synth
    from pysdr_tpu_torch.io import datfile
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
    if args.rtl_tcp:
        return bank, _rtl_tcp_source(args, fs_in, fc), cfg
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
    """Owns the bank, source, executive, sinks, recorders, control
    servers, decoder, display and viewer for one run."""

    def __init__(self, args):
        import dataclasses

        from pysdr_tpu.runtime.audio import (FifoSink, TeeSink, WavSink,
                                             aux_bandpass_taps,
                                             create_players)
        from pysdr_tpu.runtime.watchdog import PairWatchDog, WatchDog
        from pysdr_tpu_torch.io import datfile
        from pysdr_tpu_torch.models.receiver import ReceiverBank
        from pysdr_tpu_torch.runtime.executive import Executive

        self.args = args
        if args.channelize:
            self.bank, self.source, self.cfg = build_channelizer(args)
            fc_src = self.cfg.fc_hz
            for feat in NOT_WITH_CHANNELIZE:
                # by identity: pysdr_tpu.app tests truth, and so keeps
                # --rtty 0 (ROADMAP Queue 3)
                value = getattr(args, feat)
                if value is not None and value is not False:
                    print(f"--{feat.replace('_', '-')} is not available "
                          "with --channelize; ignoring", file=sys.stderr)
                    setattr(args, feat, None if feat != "hamlib" else False)
            for feat in ("bb", "save_baseband"):
                if getattr(args, feat):
                    print(f"--{feat.replace('_', '-')} is not available "
                          "with --channelize; ignoring", file=sys.stderr)
                    setattr(args, feat, False)
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
            self.bank = ReceiverBank(
                cfg, emit_baseband=(args.rtty is not None or args.bb
                                    or args.save_baseband),
                audio_wire=args.audio_wire, device=args.device)
        d = self.bank.design

        # recording taps (pysdr_tpu.app; reference pySDR.py:117-123)
        def writer(prefix, **kw):
            return datfile.DatWriter(
                os.path.join(args.save_dir,
                             datfile.timestamped_name(prefix)), **kw)
        self.raw_writer = writer(
            "raw_iq", fs=d.fs_in, fc=fc_src,
            dtype=args.save_iq_dtype) if args.save_iq else None
        self.bb_writer = writer(
            "baseband", fs=d.fs_out, fc=fc_src, nchan=self.bank.n_rx,
            tag="baseband") if args.save_baseband else None
        self.demod_writer = writer(
            "demod", fs=d.fs_out, fc=fc_src,
            nchan=self.bank.n_rx) if args.save_demod else None

        self.display = None
        if args.psd or args.bb or args.png_dir or args.web is not None:
            from pysdr_tpu_torch.models.display import DisplayEngine
            self.display = DisplayEngine(self.bank, decimate=args.psd_every,
                                         show_baseband=args.bb)
            self.display.rf.cfg.pan_dr_db = args.pan_dr

        self.rtty = None
        if args.rtty is not None:
            from pysdr_tpu_torch.models.rtty import RTTYDecoder, RTTYDesign
            self.rtty = RTTYDecoder(RTTYDesign(fs=d.fs_out),
                                    device=args.device)
            self.rtty_rx = int(args.rtty)
            # bounded: the viewer reads the tail
            self.rtty_text: collections.deque = collections.deque(
                maxlen=1000)
            # rolling decoder-band waterfall rows for the web RTTY panel
            self.rtty_wf: collections.deque = collections.deque(maxlen=50)

        # aux speaker path: RX0 audio -> 800-1300 Hz BPF -> own sink
        # (reference receiver.py:214-221); streaming FIR with tail carry
        self.aux_sink = None
        if args.aux_wav:
            self.aux_sink = WavSink(args.aux_wav, d.fs_out, stereo=False)
            self._aux_taps = aux_bandpass_taps(d.fs_out)
            self._aux_tail = np.zeros(len(self._aux_taps) - 1, np.float32)
        self.memmon = None
        if args.memmon:
            from pysdr_tpu.runtime.memmon import MemoryMonitor
            self.memmon = MemoryMonitor(args.memmon)

        per_block = (self.display, self.rtty, self.bb_writer, self.aux_sink,
                     self.memmon)
        self.ex = Executive(
            self.bank, self.source, realtime=args.realtime,
            raw_writer=self.raw_writer, demod_writer=self.demod_writer,
            psd_callback=(self._on_block
                          if any(x is not None for x in per_block) else None),
            loop_source=not args.no_loop, wire=args.wire,
            pipeline_depth=args.pipeline_depth,
            prefetch=not args.no_prefetch,
            # carry the baseband only when something reads it
            want_bb=(self.rtty is not None or self.bb_writer is not None
                     or bool(args.bb)))
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
        if args.fifo and self.players:
            # loopback routing: tee RX0's audio into a named pipe
            p0 = self.players[0]
            p0.sink = TeeSink(p0.sink, FifoSink(args.fifo, d.fs_out,
                                                stereo=args.stereo))
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

        # control plane: every surface posts block-boundary commands
        self.hamlib_servers = []
        if args.hamlib:
            from pysdr_tpu.runtime.hamlib import (DEFAULT_BASE_PORT,
                                                  HamlibServer)
            base = args.hamlib_port or DEFAULT_BASE_PORT
            self.hamlib_servers = [HamlibServer(self.ex, i, port=base + i)
                                   for i in range(self.bank.n_rx)]
        self.udp_server = None
        if args.udp_port is not None:
            from pysdr_tpu.runtime.udp import UdpMsgHandler, UdpServer
            mode0 = (self.cfg.channels[0] if args.channelize
                     else self.cfg.receivers[0]).mode
            handler = UdpMsgHandler(executive=self.ex,
                                    mode_name=tables.MODE_NAMES[mode0])
            if self.display is not None:
                # bandmap spots flow into the pan-adaptor overlay
                handler.on_spots = self._sync_spots
            self.udp_server = UdpServer(handler, port=args.udp_port)
        self.rig = self.follower = None
        if args.rig:
            from pysdr_tpu.runtime.rig import RigConnection, RigFollower
            host, _, port = args.rig.partition(":")
            self.rig = RigConnection(host or "127.0.0.1", int(port or 4532))
            self.follower = RigFollower(self.ex, self.rig)
        self.web = None
        if args.web is not None:
            from pysdr_tpu.runtime.webview import WebViewer
            self.web = WebViewer(
                self.display, self.ex, port=args.web,
                rtty_state=self._rtty_state if self.rtty else None,
                presets_file=args.presets_file,
                save_iq_dtype=args.save_iq_dtype, save_dir=args.save_dir,
                rig=self.rig, source=self.source, follower=self.follower)
            print(f"live viewer: http://127.0.0.1:{self.web.port}/",
                  flush=True)
        self.fldigi_sync = None
        self._fldigi_stop = None
        if args.fldigi_ports:
            from pysdr_tpu.runtime.fldigi import CounterSync
            self.fldigi_sync = CounterSync(args.fldigi_ports)
        self.hopper = None
        if args.hop or args.hop_schedule:
            from pysdr_tpu.runtime.hopper import FreqHopper, load_hop_schedule
            sched = (load_hop_schedule(args.hop_schedule)
                     if args.hop_schedule else None)
            self.hopper = FreqHopper(
                self.ex, [(f * 1e6, self.cfg.receivers[0].mode)
                          for f in (args.hop or [])],
                dwell_s=args.dwell, schedule=sched)

    def _sync_spots(self, table):
        """UDP SpotTable -> display overlay (kHz wire -> Hz display)."""
        from pysdr_tpu_torch.models.display import Spot
        self.display.rf.spots.replace_all(
            Spot(freq_hz=s.freq_khz * 1e3, label=s.call, color=s.color,
                 mode=s.mode) for s in table.all())

    def _rtty_state(self) -> dict:
        """Per-channel live state + decoder-band waterfall for the web
        RTTY panel (the reference RTTY window's waterfall + decoded-text
        list, rtty.py:92-371)."""
        import base64
        d = self.rtty.design
        chans = [{"idx": i, "freq_hz": ch["mark_bin"] * d.bin_hz,
                  "locked": ch.get("snr_db", 0.0) > 0.0,
                  "text": ch.get("text", "")[-80:]}
                 for i, ch in enumerate(self.rtty.channels)]
        out = {"channels": chans, "lines": list(self.rtty_text)[-100:]}
        if self.rtty_wf:
            wf = np.stack(list(self.rtty_wf))
            step = max(1, wf.shape[1] // 1024)
            wf = wf[:, ::step]
            out["wf_b64"] = base64.b64encode(wf.tobytes()).decode()
            out["rows"], out["cols"] = int(wf.shape[0]), int(wf.shape[1])
            out["bin_hz"] = d.bin_hz * step
        return out

    def _on_block(self, ex, audio):
        """Per-block taps: memmon, the aux path, the baseband recorder, the
        display (AF panes every block the decimation keeps, the RF pane
        every --psd-every blocks, the BB panes), and the RTTY decoder fed
        the RX's baseband as the device tensor the executive carried with
        this block. The baseband comes to the host only for the recorder
        and the BB panes."""
        if self.memmon is not None and ex.n_blocks % 32 == 0:
            self.memmon.take_snapshot()
        if self.aux_sink is not None:
            x = np.concatenate([self._aux_tail,
                                audio[0].real.astype(np.float32)])
            self._aux_tail = x[-(len(self._aux_taps) - 1):]
            self.aux_sink.write(np.convolve(
                x, self._aux_taps, "valid").astype(np.float32))
        bb = ex.drained_bb
        disp = self.display
        need_bb_display = (disp is not None and bb is not None
                           and disp.wants_next_bb())
        bb_host = None
        if bb is not None and (need_bb_display or self.bb_writer is not None):
            bb_host = bb.cpu().numpy()              # complex64 (n_rx, n)
        if self.bb_writer is not None and bb_host is not None:
            # interleave channel-last like the demod writer
            self.bb_writer.save_data(bb_host.T)
        if disp is not None:
            disp(ex, audio)
            if ex.last_rf_block is not None \
                    and ex.n_blocks % self.args.psd_every == 0:
                disp.update_rf(ex.last_rf_block)
            if need_bb_display:
                disp.update_bb(bb_host)
        if self.rtty is not None and bb is not None:
            for i, txt in enumerate(self.rtty.decode_block(bb[self.rtty_rx])):
                if txt:
                    self.rtty_text.append(txt)
                    print(f"RTTY ch{i}: {txt}", flush=True)
            sp = self.rtty.last_spectrum
            if sp is not None:
                db = 20.0 * np.log10(np.maximum(sp, 1e-9))
                top = db.max()
                self.rtty_wf.append(np.clip(
                    (db - (top - 50.0)) / 50.0 * 255.0, 0, 255)
                    .astype(np.uint8))

    def start_services(self):
        if self.fldigi_sync is not None:
            import threading
            self._fldigi_stop = threading.Event()

            def _sync_loop():
                while not self._fldigi_stop.is_set():
                    self.fldigi_sync.sync_once()
                    self._fldigi_stop.wait(2.0)   # watchdog 2 s cadence
            threading.Thread(target=_sync_loop, daemon=True).start()
        for s in self.hamlib_servers:
            s.start()
        if self.web:
            self.web.start()
        if self.udp_server:
            self.udp_server.start()
        if self.follower:
            self.follower.start()
        if self.hopper:
            self.hopper.start()
        for w in self.watchdogs:
            w.start()
        for p in self.players:
            if self.args.realtime:
                p.start_playback(min_buffered=self.args.delay)
            else:
                p.realtime = False
                p.start_playback(min_buffered=0, timeout=0.0)

    def stop_services(self):
        """Stop every thread and server the app started, close the
        writers and the source, and export the display's waterfalls under
        --png-dir."""
        self.ex.stop()
        if self._fldigi_stop is not None:
            self._fldigi_stop.set()
        if self.memmon is not None:
            self.memmon.take_snapshot()
            self.memmon.close()
        if self.hopper:
            self.hopper.stop()
        if self.follower:
            self.follower.stop()
        if self.udp_server:
            self.udp_server.stop()
        if self.web:
            self.web.stop()
        for s in self.hamlib_servers:
            s.stop()
        for w in self.watchdogs:
            w.stop()
        for p in self.players:
            p.stop(drain=True)
        for wr in (self.raw_writer, self.demod_writer, self.bb_writer):
            if wr is not None:
                wr.close()
        if self.aux_sink is not None:
            self.aux_sink.close()
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


def _apply_preset(args) -> bool:
    """--preset NAME tunes RX0 to the named station (pysdr_tpu.app);
    False when no preset has that name."""
    from pysdr_tpu.runtime import presets as pre
    plist, _ = pre.load(args.presets_file)
    match = [p for p in plist if p.name.lower() == args.preset.lower()]
    if not match:
        return False
    args.fc = [match[0].freq_hz / 1e6] + list(args.fc or [])[1:]
    args.mode = tables.MODE_NAMES[match[0].mode]
    args.modes = None
    return True


def run_cli(argv=None):
    """The whole CLI run: returns (exit code, the App or None when the
    run ended before one was built)."""
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
    if args.list_presets:
        from pysdr_tpu.runtime import presets as pre
        plist, _ = pre.load(args.presets_file)
        for p in plist:
            print(f"{p.name:24s} {p.freq_hz / 1e6:12.6f} MHz "
                  f"{tables.MODE_NAMES[p.mode]:8s} {p.group}")
        return 0, None
    if args.preset and not _apply_preset(args):
        print(f"unknown preset {args.preset!r}", file=sys.stderr)
        return 2, None
    try:
        app = App(args)
    except (ValueError, RuntimeError, ConnectionError, TimeoutError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2, None
    if args.internals:
        if not hasattr(app.bank, "dump_internals"):
            print("error: --internals dumps the receiver bank's filters; "
                  "the channelizer bank has none to dump", file=sys.stderr)
            return 2, None
        np.savez(args.internals, **app.bank.dump_internals())
        print(f"wrote {args.internals}")
        if hasattr(app.source, "close"):
            app.source.close()
        return 0, app
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
