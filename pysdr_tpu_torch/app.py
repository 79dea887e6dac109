"""`python -m pysdr_tpu_torch`: CLI -> config -> source -> executive ->
sinks, recorders, control servers, hopper, RTTY decoder, display and web
viewer, on the card (counterpart of pysdr_tpu/app.py).

build_parser, _fs_out_hz, _expand_digi_layout, build_config,
_rtl_tcp_source and build_source are the port's own copies of
pysdr_tpu/app.py's (every flag and default of its parser, plus
`--device {cuda,cpu}`). `--channelize N` builds the polyphase
channelizer bank instead of the receiver bank. The host services
(hamlib, UDP, rig follow, hopper, fldigi, memmon, presets, the
wav/fifo/aux sinks, rtl_tcp, the C++ replay streamer and the web viewer)
are the port's copies of the JAX package's runtime and io modules: the
port imports nothing of the JAX package. `--mesh S,C` wraps the bank in a
parallel/adapter bank over an S x C device grid; `--jax-trace DIR` keeps
its name and writes a torch.profiler trace (runtime/profiler.torch_trace).
"""

from __future__ import annotations

import argparse
import collections
import os
import sys
import time

import numpy as np

from pysdr_tpu_torch import config as cfg_mod
from pysdr_tpu_torch import tables
from pysdr_tpu_torch.tables import Mode

# features the channelizer bank does not carry (pysdr_tpu.app's list)
NOT_WITH_CHANNELIZE = ("rtty", "hamlib", "rig", "hop", "hop_schedule")

MAX_RX = 64     # reference clamps at 6 (params.py:33); the vmapped bank
                # has no such structural limit — 64 is a sanity rail.


# --------------------------------------------------------------------------
# CLI (reference params.py:45-190)
# --------------------------------------------------------------------------

def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="pysdr_tpu_torch",
        description="Multi-channel SDR receiver (headless), PyTorch/CUDA")
    # -- channels (reference -fc nargs='*', -mode; params.py:76-77) --
    ap.add_argument("--fc", type=float, nargs="*", default=None,
                    help="per-RX center freqs in MHz (up to %d; "
                         "default 0.6)" % MAX_RX)
    ap.add_argument("--mode", type=str, default="AM",
                    help="demod mode for all RXs (AM/AM-Synch/USB/LSB/CW/"
                         "IQ/WFM/WFM2/NFM/RTTY)")
    ap.add_argument("--modes", type=str, nargs="*", default=None,
                    help="per-RX mode list (overrides --mode)")
    ap.add_argument("--ft8", type=str, nargs="*", default=None,
                    metavar="BAND",
                    help="one-step FT8 RX layout expansion (reference "
                         "-ft8, params.py:254-267): with no BAND, "
                         "append a USB sub-RX on the first RX's band "
                         "FT8 slot; with BANDs (e.g. 40m 20m), one USB "
                         "RX per band's FT8 slot — all slots must fit "
                         "the device passband. Without --fc the slots "
                         "ARE the layout")
    ap.add_argument("--ft4", type=str, nargs="*", default=None,
                    metavar="BAND",
                    help="FT4 layout expansion (reference -ft4 "
                         "expand_ft4, utils.py:442-453): with no BAND, "
                         "append each RX's band FT4 slot (doubling the "
                         "layout); with BANDs, one USB RX per band's "
                         "FT4 slot")
    ap.add_argument("--ft44", action="store_true",
                    help="append one FT4 sub-RX for the first RX's "
                         "band (reference -ft44)")
    ap.add_argument("--video-bw", type=float, default=0.0,
                    help="pre-demod filter BW in kHz (0 = Max)")
    ap.add_argument("--af-bw", type=float, default=0.0,
                    help="audio filter BW in kHz (0 = mode default)")
    ap.add_argument("--af-gain", type=float, default=1.0)
    ap.add_argument("--bfo", type=float, default=None, metavar="HZ",
                    help="CW beat pitch (reference -bfo; default %g Hz)"
                    % tables.CW_BFO_HZ)
    ap.add_argument("--nfilt", type=int, default=None, metavar="TAPS",
                    help="AF filter length (reference -nfilt; default "
                         "256)")
    ap.add_argument("--squelch", type=float, default=-150.0,
                    help="squelch threshold dB (default off)")
    ap.add_argument("--no-agc", action="store_true")
    ap.add_argument("--auto-mute", action="store_true",
                    help="mute on strong signals (reference -auto_mute, "
                         "receiver.py:237-245)")
    ap.add_argument("--auto-mute-db", type=float, default=-10.0,
                    help="auto-mute baseband power threshold (dBFS)")
    ap.add_argument("--mute", type=int, nargs="*", default=[],
                    metavar="RX", help="start with these RXs muted")
    ap.add_argument("--src", type=int, nargs="*", default=None,
                    help="per-RX sample-source chain (reference -src, "
                         "receiver.py:825-835): RX i with src j >= 0 "
                         "derives its NCO offset from RX j's dial; -1 = "
                         "normal (device-center) derivation")
    # -- rates (reference -fs MHz / -fsout kHz; params.py:128-131) --
    ap.add_argument("--fs", type=float, default=2.048,
                    help="RF sample rate in MHz")
    ap.add_argument("--fs-out", type=float, default=None,
                    help="audio rate in kHz (48/96/192; default 48, or "
                         "192 when any RX runs WFM/WFM2 — the broadcast "
                         "FM signal needs the full ~200 kHz before the "
                         "discriminator, reference params.py:400-404)")
    ap.add_argument("--foffset", type=float, default=None,
                    help="tuner offset in kHz (default: auto-center, "
                         "params.py:311-315)")
    ap.add_argument("--transverter", type=float, default=0.0, metavar="MHZ",
                    help="up/down-converter offset ahead of the SDR in "
                         "MHz: the device tunes dial + offset (the "
                         "reference's +125 MHz Ham-It-Up shift, "
                         "gui.py:1940-1944)")
    ap.add_argument("--block", type=int, default=16384,
                    help="audio samples per device block")
    ap.add_argument("--channelize", type=int, default=None, metavar="N",
                    help="split the passband into N uniform channels with "
                         "the polyphase channelizer and demod every one "
                         "(the 64+-channel generalization of the "
                         "reference's MAX_RX=6 bank, params.py:33)")
    # -- source (reference -replay / -fake; params.py:51-56) --
    ap.add_argument("--replay", type=str, nargs="+", default=None,
                    metavar=("FILE", "START_SEC"),
                    help="replay a recorded .dat file (optional start sec)")
    ap.add_argument("--no-native", action="store_true",
                    help="force the Python replay reader even when the "
                         "C++ streamer (native/sdrio.cpp) is built")
    ap.add_argument("--no-loop", action="store_true",
                    help="stop at end of replay file instead of looping")
    ap.add_argument("--rtl-tcp", type=str, default=None,
                    metavar="HOST:PORT",
                    help="stream live IQ from an rtl_tcp server (every "
                         "RTL-SDR ships one; the network path to real "
                         "hardware from a USB-less host). The device "
                         "tunes to the derived SDR center at startup "
                         "and RXs tune within that passband; "
                         "--rf-gain/--ppm program the dongle")
    ap.add_argument("--rtl-tcp-retries", type=int, default=5,
                    metavar="N",
                    help="auto-reconnect a dropped/stalled rtl_tcp "
                         "session with up to N attempts per outage, "
                         "re-programming the device from its model "
                         "state (reference watchdog.py:96-123 network "
                         "retry discipline); 0 fails loudly instead")
    ap.add_argument("--synth-noise", type=float, default=0.001,
                    help="noise RMS for the synthetic source (-fake "
                         "equivalent, utils.py:71-273)")
    ap.add_argument("--rf-gain", type=float, default=None, metavar="DB",
                    help="front-end RF gain applied by the source "
                         "(reference setupSDR gain staging, "
                         "utils.py:292-353). For --rtl-tcp, omitting it "
                         "selects the tuner's hardware AGC; an explicit "
                         "value — including 0 — pins manual gain")
    ap.add_argument("--ppm", type=float, default=0.0,
                    help="front-end frequency-correction error in ppm "
                         "(reference PPM correction, utils.py:292-353)")
    ap.add_argument("--ant", type=str, default=None,
                    help="front-end antenna port select (reference -ant "
                         "A/B/Hi-Z, utils.py:292-353)")
    # -- run control --
    ap.add_argument("--blocks", type=int, default=None,
                    help="stop after N device blocks")
    ap.add_argument("--duration", type=float, default=None,
                    help="stop after N seconds of stream time")
    ap.add_argument("--realtime", action="store_true",
                    help="pace to the sample clock (default: free-run)")
    ap.add_argument("--mesh", type=str, default=None, metavar="S,C",
                    help="process across a device mesh: S stream (time) "
                         "shards x C channel shards (jax.sharding.Mesh "
                         "over the first S*C devices; state-continuous "
                         "halo exchange, parallel/adapter.py). '1,8' = "
                         "pure channel sharding, '4,1' = pure stream "
                         "parallelism, '2,4' = both")
    ap.add_argument("--no-prefetch", action="store_true",
                    help="disable the source read-ahead thread (host "
                         "read + wire quantize + device-put issue run "
                         "inline in the hot loop instead of overlapping "
                         "the in-flight transfers)")
    ap.add_argument("--pipeline-depth", type=int, default=2,
                    help="device blocks in flight before draining the "
                         "oldest (deeper hides per-block transport "
                         "latency at the cost of depth-1 blocks of "
                         "audio latency)")
    ap.add_argument("--wire", choices=["f32", "i16", "i8"], default="f32",
                    help="host->device RF block format: raw CS16/CS8 "
                         "sample pairs ship 2x/4x fewer bytes and are "
                         "dequantized on device (i16 is lossless for any "
                         "real SDR front-end; f32 = exact replay)")
    ap.add_argument("--audio-wire", choices=["f32", "i16", "i8"],
                    default="f32",
                    help="device->host audio format: i16 halves the "
                         "return transport (~78 dB SNR), i8 quarters it "
                         "(mu-law, ~37 dB — monitoring quality; the "
                         "audio return is the dominant byte stream for "
                         "many-channel banks)")
    # -- recording taps (reference -save_iq/-save_demod; params.py:136-141)
    ap.add_argument("--save-iq", action="store_true",
                    help="record raw RF IQ to a timestamped .dat")
    ap.add_argument("--save-iq-dtype", default="complex64",
                    choices=["complex64", "int16", "int8"],
                    help="recording sample format: int16/int8 store "
                         "CS16/CS8 pairs at 1/2 / 1/4 the bytes "
                         "(lossless for real 8/14-bit front-ends); both "
                         "the Python reader and the C++ streamer replay "
                         "them")
    ap.add_argument("--save-baseband", action="store_true",
                    help="record per-RX post-mix/decimate baseband to a "
                         "timestamped .dat (reference -save_baseband, "
                         "params.py:136-141; taps receiver.py:292-297)")
    ap.add_argument("--save-demod", action="store_true",
                    help="record demod audio to a timestamped .dat")
    ap.add_argument("--save-dir", type=str, default=".")
    ap.add_argument("--wav", type=str, default=None, metavar="PREFIX",
                    help="write per-RX audio to PREFIX_rxN.wav")
    ap.add_argument("--stereo", action="store_true",
                    help="pack RX pairs into one stereo player each "
                         "(RX i in L, RX i+1 in R — the reference's "
                         "scheme-2 routing, receiver.py:158-189)")
    ap.add_argument("--fifo", type=str, default=None, metavar="PATH",
                    help="also route RX0 audio as raw s16le PCM into a "
                         "named pipe for other apps (the reference's "
                         "PulseAudio loopback, start_loopback:1-100)")
    ap.add_argument("--delay", type=int, default=16 * 1024,
                    metavar="SAMPLES",
                    help="audio samples buffered before playback starts "
                         "(reference -delay / P.DELAY, params.py:70-71)")
    ap.add_argument("--aux-wav", type=str, default=None, metavar="PATH",
                    help="aux speaker path: RX0 audio through the "
                         "800-1300 Hz speech bandpass to its own wav "
                         "(reference receiver.py:214-221)")
    # -- control plane (reference pySDR.py:139-156; udp.py; hopper.py) --
    ap.add_argument("--hamlib", action="store_true",
                    help="start one hamlib TCP server per RX (ports "
                         "4575+i, pySDR.py:139-156)")
    ap.add_argument("--hamlib-port", type=int, default=None)
    ap.add_argument("--udp-port", type=int, default=None,
                    help="start the bandmap/keyer UDP server")
    ap.add_argument("--rig", type=str, default=None, metavar="HOST:PORT",
                    help="follow an external rigctld (follow-freq loop, "
                         "gui.py:1402-1483)")
    ap.add_argument("--hop", type=float, nargs="*", default=None,
                    help="frequency-hop list in MHz (hopper.py:51-199)")
    ap.add_argument("--hop-schedule", type=str, default=None,
                    metavar="FILE",
                    help="hour-keyed hop schedule file ('H[-H]: entries' "
                         "per line; the reference presets 'Hops' sheet "
                         "keyed by hour, hopper.py:74-111); entries are "
                         "MHz numbers or slots like 40m:FT8")
    ap.add_argument("--dwell", type=float, default=15.0,
                    help="hop dwell seconds (WSJT 15 s slots)")
    # -- decoders --
    ap.add_argument("--rtty", type=int, default=None, metavar="RX",
                    help="run the wideband RTTY decoder on this RX's "
                         "baseband (rtty.py)")
    # -- display (headless UpdatePSD; pySDR.py:252-256) --
    ap.add_argument("--psd", action="store_true",
                    help="compute RF/AF PSD + waterfall frames")
    ap.add_argument("--bb", action="store_true",
                    help="also compute per-RX BASEBAND PSD/waterfall "
                         "frames (the reference's BB domain + show-BB "
                         "toggle, gui.py:121-221; implies --psd)")
    ap.add_argument("--psd-every", type=int, default=8,
                    help="update displays every N blocks")
    ap.add_argument("--pan-dr", type=float, default=60.0, metavar="DB",
                    help="pan-adaptor dynamic-range clamp (reference "
                         "-pan_dr; also live in the viewer)")
    ap.add_argument("--png-dir", type=str, default=None,
                    help="export waterfall PNGs here on exit")
    ap.add_argument("--web", type=int, default=None, metavar="PORT",
                    help="serve the live waterfall + click-to-tune viewer "
                         "on this port (implies --psd; 0 = ephemeral)")
    # -- presets (reference presets.xls tabs; gui.py:408-435) --
    ap.add_argument("--preset", type=str, default=None,
                    help="tune RX0 to a named preset station")
    ap.add_argument("--presets-file", type=str, default=None)
    ap.add_argument("--list-presets", action="store_true")
    ap.add_argument("--fldigi-ports", type=int, nargs="*", default=None,
                    help="XML-RPC ports of fldigi/keyer instances to keep "
                         "serial counters in sync (watchdog.py:382-414)")
    # -- diagnostics --
    ap.add_argument("--memmon", type=str, nargs="?", default=None,
                    const="/tmp/SDR_MEMORY.TXT", metavar="PATH",
                    help="log RSS snapshots (reference Memory_Monitor, "
                         "pySDR.py:224-225)")
    ap.add_argument("--watchdog-log", type=str, nargs="?", default=None,
                    const="/tmp/LOG2.TXT", metavar="PATH",
                    help="write the watchdog latency CSV (reference "
                         "/tmp/LOG2.TXT, watchdog.py:176-227); analyze "
                         "with `python -m pysdr_tpu_torch.latency PATH`")
    ap.add_argument("--internals", type=str, default=None, metavar="NPZ",
                    help="dump filter banks for cross-validation "
                         "(internals.mat harness, receiver.py:864-874)")
    ap.add_argument("--profile", action="store_true",
                    help="print per-block timing vs the frame budget "
                         "(profiler.py:27-46)")
    ap.add_argument("--jax-trace", type=str, default=None, metavar="DIR",
                    help="write a torch.profiler Chrome trace of the run, "
                         "DIR/trace_<pid>.json, with the executive's "
                         "pysdr.<stage>#<block> spans beside the card's "
                         "kernels (open with Perfetto; the trace hook "
                         "points the reference comments out, "
                         "pySDR.py:170-171)")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="where the DSP runs (default cuda; never falls "
                         "back to the CPU)")
    return ap


def _fs_out_hz(args, modes) -> float:
    """Audio rate: explicit --fs-out wins; otherwise 192 kHz when any
    RX runs broadcast FM (the reference's per-mode srate selection,
    params.py:400-404), else 48 kHz."""
    if args.fs_out is not None:
        return args.fs_out * 1e3
    if any(m in (Mode.WFM, Mode.WFM2) for m in modes):
        return 192e3
    return 48e3


def _expand_digi_layout(args, fcs_mhz: list, mode_names: list):
    """One-flag FT8/FT4 RX layout expansion (reference params.py:254-267:
    -ft8 grows a single RX into main + FT8 sub-RX, -ft4 doubles the
    list with each band's FT4 slot via expand_ft4 utils.py:442-453,
    -ft44 appends one FT4 sub-RX). Band arguments generalize this:
    --ft8 40m 20m appends one USB RX per band slot; with no --fc given
    the named slots ARE the layout."""
    from pysdr_tpu_torch.runtime.hopper import BANDS_KHZ, freq2band

    def slot_mhz(band: str, name: str) -> float:
        try:
            return BANDS_KHZ[band][name] / 1e3
        except KeyError:
            raise ValueError(
                f"unknown band {band!r} for --{name.lower()} "
                f"(choose from {', '.join(BANDS_KHZ)})") from None

    def band_of(fc_mhz: float) -> str:
        b = freq2band(fc_mhz * 1e6)
        if b == "?":
            raise ValueError(
                f"{fc_mhz} MHz is not inside a ham band; give explicit "
                "bands to --ft8/--ft4 (e.g. --ft8 40m)")
        return b

    fcs, modes = list(fcs_mhz), list(mode_names)
    if args.ft8 is not None:
        if args.ft8:                       # bands listed
            if args.fc is None:
                fcs, modes = [], []        # the slots are the layout
            for b in args.ft8:
                fcs.append(slot_mhz(b, "FT8"))
                modes.append("USB")
        else:                              # main RX + FT8 sub-RX
            fcs.append(slot_mhz(band_of(fcs[0]), "FT8"))
            modes.append("USB")
    if args.ft4 is not None:
        if args.ft4:
            if args.fc is None and args.ft8 is None:
                fcs, modes = [], []
            for b in args.ft4:
                fcs.append(slot_mhz(b, "FT4"))
                modes.append("USB")
        else:                              # reference expand_ft4
            for fc in list(fcs):
                fcs.append(slot_mhz(band_of(fc), "FT4"))
                modes.append("USB")
    if args.ft44:
        fcs.append(slot_mhz(band_of(fcs[0]), "FT4"))
        modes.append("USB")
    return fcs, modes


def build_config(args) -> cfg_mod.PipelineConfig:
    fcs_mhz = list(args.fc if args.fc is not None else [0.6])
    mode_names = list(args.modes) if args.modes \
        else [args.mode] * len(fcs_mhz)
    if len(mode_names) < len(fcs_mhz):
        mode_names += [mode_names[-1]] * (len(fcs_mhz) - len(mode_names))
    if args.ft8 is not None or args.ft4 is not None or args.ft44:
        fcs_mhz, mode_names = _expand_digi_layout(args, fcs_mhz,
                                                  mode_names)
    if len(fcs_mhz) > MAX_RX:
        print(f"warning: only {MAX_RX} receivers are supported; "
              f"dropping {len(fcs_mhz) - MAX_RX} "
              "(reference params.py:271-277)", file=sys.stderr)
    fcs = [f * 1e6 for f in fcs_mhz][:MAX_RX]
    mode_names = mode_names[:MAX_RX]
    modes = [tables.mode_from_name(m) for m in mode_names]
    fs_in = args.fs * 1e6
    if args.foffset is not None:
        foff = args.foffset * 1e3
    elif len(fcs) > 1:
        foff = cfg_mod.auto_foffset(fcs, fs_in)
    else:
        foff = min(0.25 * fs_in, 120e3)   # park DC spike out of channel
    rx_kw = {}
    if args.bfo is not None:
        rx_kw["bfo_hz"] = args.bfo
    srcs = list(args.src or [])
    srcs += [-1] * (len(fcs) - len(srcs))
    rxs = tuple(
        cfg_mod.ReceiverConfig(
            fc_hz=fc, mode=m, video_bw_hz=args.video_bw * 1e3,
            af_bw_hz=args.af_bw * 1e3, af_gain=args.af_gain,
            agc_enabled=not args.no_agc, squelch_db=args.squelch,
            muted=(i in set(args.mute)), auto_mute=args.auto_mute,
            auto_mute_db=args.auto_mute_db, src=srcs[i], **rx_kw)
        for i, (fc, m) in enumerate(zip(fcs, modes)))
    pipe_kw = {}
    if args.nfilt is not None:
        pipe_kw["af_taps"] = args.nfilt
    return cfg_mod.PipelineConfig(
        fs_in=fs_in, fs_out=_fs_out_hz(args, modes),
        out_block=args.block,
        foffset_hz=foff, transverter_hz=args.transverter * 1e6,
        receivers=rxs, **pipe_kw)


def _rtl_tcp_source(args, fs: float, fc: float):
    """The one place --rtl-tcp turns into a source (both the receiver
    and channelizer paths construct through here)."""
    from pysdr_tpu_torch.io import rtltcp
    host, _, port = args.rtl_tcp.partition(":")
    return rtltcp.RtlTcpSource(
        host or "127.0.0.1", int(port or 1234), fs=fs, fc=fc,
        gain_db=args.rf_gain, ppm=args.ppm,
        reconnect=args.rtl_tcp_retries)


def build_source(args, cfg: cfg_mod.PipelineConfig):
    """Pick the source, reference-style: -replay beats -fake beats live
    (utils.py:459-621 find_sdr_device). There is no live USB device on a
    TPU host, so the synthetic source is the default backend."""
    from pysdr_tpu_torch.io import datfile, synth
    if args.replay:
        start = float(args.replay[1]) if len(args.replay) > 1 else 0.0
        # C++ prefetch streamer when built (the >100 Msamp/s host-feeding
        # path, SURVEY §7 hard part 4); Python reader for seek or fallback
        if start == 0.0 and not args.no_native:
            from pysdr_tpu_torch.runtime import native
            if native.available():
                try:
                    ns = native.NativeStreamer(args.replay[0],
                                               loop=not args.no_loop)
                    return ns, ns.srate, ns.fc
                except OSError:
                    pass   # container the C++ refuses (multi-channel /
                           # exotic dtype): the Python reader handles it
        rd = datfile.DatReader(args.replay[0], start_sec=start)
        # replay restores fs/fc from the header (receiver.py:810-820)
        return rd, rd.srate, rd.fc
    if args.rtl_tcp:
        src = _rtl_tcp_source(args, cfg.fs_in, cfg.sdr_center_hz)
        return src, cfg.fs_in, cfg.sdr_center_hz
    # synthetic passband: one station per requested channel
    specs = []
    for i, (rc, off) in enumerate(zip(cfg.receivers,
                                      cfg.channel_offsets_hz())):
        kind = {Mode.AM: "am", Mode.AM_SYNC: "am", Mode.USB: "usb",
                Mode.LSB: "lsb", Mode.CW: "cw", Mode.NFM: "fm",
                Mode.WFM: "fm", Mode.WFM2: "fm",
                }.get(rc.mode, "tone")
        specs.append(synth.SignalSpec(
            offset_hz=off, mode=kind, amplitude=0.5,
            audio_hz=400.0 * (i + 1)))
    src = synth.SynthSource(specs, cfg.fs_in, noise_rms=args.synth_noise,
                            fc=cfg.sdr_center_hz,
                            rf_gain_db=args.rf_gain or 0.0, ppm=args.ppm)
    return src, cfg.fs_in, cfg.sdr_center_hz


def build_channelizer(args):
    """--channelize N: the polyphase channelizer bank and a synth, replay
    or rtl_tcp source. fs_in must be N * (k * fs_out) for a uniform k:1
    per-channel decimation; --fc gives the passband center; --mode
    applies to every channel. Returns (bank, source, config)."""
    from pysdr_tpu_torch.io import datfile, synth
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
            from pysdr_tpu_torch.runtime import native
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

        from pysdr_tpu_torch.runtime.audio import (FifoSink, TeeSink, WavSink,
                                             aux_bandpass_taps,
                                             create_players)
        from pysdr_tpu_torch.runtime.watchdog import PairWatchDog, WatchDog
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
        if args.mesh:
            from pysdr_tpu_torch.parallel.adapter import (
                ShardedChannelizerBank, ShardedStreamBank, build_mesh)
            s, _, c = args.mesh.partition(",")
            mesh = build_mesh(int(s), int(c or 1), device=args.device)
            # the sharded processors quantize the audio wire inside each
            # shard and emit the RTTY baseband tap, so --audio-wire and
            # --rtty compose with --mesh
            self.bank = (ShardedChannelizerBank(self.bank, mesh)
                         if args.channelize else
                         ShardedStreamBank(self.bank, mesh))
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
            from pysdr_tpu_torch.runtime.memmon import MemoryMonitor
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
            # carry the baseband only when something reads it, and copy
            # it to the host beside the audio for the recorder and panes
            want_bb=(self.rtty is not None or self.bb_writer is not None
                     or bool(args.bb)),
            host_bb=self.bb_writer is not None or bool(args.bb))
        # the display's panes and the RTTY filterbank are captured with
        # the bank's step, before the prefetch thread and the services
        # start
        self.ex.prepare_hooks.append(self._prepare_taps)
        if args.ant and hasattr(self.source, "set_antenna"):
            self.source.set_antenna(args.ant)
        inner_bank = getattr(self.bank, "bank", self.bank)  # mesh adapter
        if hasattr(inner_bank, "on_device_retune") \
                and hasattr(self.source, "set_freq"):
            tv = self.cfg.transverter_hz

            def _follow_device(center):
                self.source.set_freq(center + tv)
                if self.display is not None:
                    # the RF pane tracks the device passband
                    self.display.retune(center)
            inner_bank.on_device_retune = _follow_device
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
            from pysdr_tpu_torch.runtime.hamlib import (DEFAULT_BASE_PORT,
                                                  HamlibServer)
            base = args.hamlib_port or DEFAULT_BASE_PORT
            self.hamlib_servers = [HamlibServer(self.ex, i, port=base + i)
                                   for i in range(self.bank.n_rx)]
        self.udp_server = None
        if args.udp_port is not None:
            from pysdr_tpu_torch.runtime.udp import UdpMsgHandler, UdpServer
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
            from pysdr_tpu_torch.runtime.rig import RigConnection, RigFollower
            host, _, port = args.rig.partition(":")
            self.rig = RigConnection(host or "127.0.0.1", int(port or 4532))
            self.follower = RigFollower(self.ex, self.rig)
        self.web = None
        if args.web is not None:
            from pysdr_tpu_torch.runtime.webview import WebViewer
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
            from pysdr_tpu_torch.runtime.fldigi import CounterSync
            self.fldigi_sync = CounterSync(args.fldigi_ports)
        self.hopper = None
        if args.hop or args.hop_schedule:
            from pysdr_tpu_torch.runtime.hopper import FreqHopper, load_hop_schedule
            sched = (load_hop_schedule(args.hop_schedule)
                     if args.hop_schedule else None)
            self.hopper = FreqHopper(
                self.ex, [(f * 1e6, self.cfg.receivers[0].mode)
                          for f in (args.hop or [])],
                dwell_s=args.dwell, schedule=sched)

    def _prepare_taps(self):
        if self.display is not None:
            self.display.prepare()
        if self.rtty is not None:
            self.rtty.prepare(self.bank.design.out_block)

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
        this block, with the events after which it is valid and the
        block's id (the record the executive drained last). The
        baseband's host copy, which the executive started right after the
        step, feeds the recorder and the BB panes."""
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
        bb_host = None if ex.drained_bb_host is None \
            else ex.drained_bb_host.numpy()         # complex64 (n_rx, n)
        need_bb_display = (disp is not None and bb_host is not None
                           and disp.wants_next_bb())
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
            # the drained block's id keys the decoder's profiler ranges
            block_id = ex.block_spans[-1].id if ex.block_spans else None
            lines = []
            for i, txt in enumerate(self.rtty.decode_block(
                    bb[self.rtty_rx], ready=ex.drained_bb_ready,
                    block_id=block_id)):
                if txt:
                    self.rtty_text.append(txt)
                    lines.append(f"RTTY ch{i}: {txt}")
            if lines:           # one write and flush a block
                print("\n".join(lines), flush=True)
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
        import contextlib

        from pysdr_tpu_torch.runtime.profiler import torch_trace
        trace = (torch_trace(self.args.jax_trace) if self.args.jax_trace
                 else contextlib.nullcontext())
        # the step's and the display's captures first, before any service
        # thread or trace
        self.ex.prepare()
        self.start_services()
        try:
            with trace:
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
    from pysdr_tpu_torch.runtime import presets as pre
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
    args = build_parser().parse_args(argv)
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
        from pysdr_tpu_torch.runtime import presets as pre
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
