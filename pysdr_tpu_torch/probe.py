"""Environment / device exploration tool (counterpart of pysdr_tpu/probe.py).

The equivalent of the reference's device smoke tools — `playpen.py`
(Soapy API exploration, playpen.py:41-195), `soapy.py` / `simple.py`
enumeration scripts, and the `check_sdr_settings` dump (utils.py:358-422):
enumerate the compute devices (the CUDA cards, or the CPU when asked for),
probe the source layer (replay-file headers, synth self-test, the C++
replay streamer, an rtl_tcp server), and run one end-to-end smoke block
on the port's ReceiverBank.

    python -m pysdr_tpu_torch.probe [--device cuda|cpu] [--replay FILE]
        [--rtl-tcp HOST:PORT] [--smoke] [--devices N]

`--devices N` lists the stream x ch grids of N devices that `--mesh` can
run: on the CPU, N repeats of the one CPU device (the counterpart of the
JAX package's N virtual CPU devices); on cuda it needs N visible cards.
"""

from __future__ import annotations

import argparse
import os
import platform
import shutil
import subprocess
import sys
import time


def power_limit() -> str | None:
    """`name, power.limit` of the first card from nvidia-smi, or None."""
    if shutil.which("nvidia-smi") is None:
        return None
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    lines = out.stdout.strip().splitlines()
    return lines[0] if out.returncode == 0 and lines else None


def probe_devices(device: str = "cuda", n_devices: int = 0) -> int:
    """Print the devices the port runs on and the stream x ch grids of
    `n_devices` of them (all of them when 0). Returns the device count.
    Raises RuntimeError for cuda without a card or with fewer than
    `n_devices` cards."""
    import torch
    print(f"torch {torch.__version__}  cuda {torch.version.cuda}  "
          f"device={device}")
    if device == "cpu":
        print(f"  device[cpu] {platform.processor() or platform.machine()} "
              f"{os.cpu_count()} cores, {torch.get_num_threads()} torch "
              "threads")
        n = n_devices or 1
    else:
        from pysdr_tpu_torch.device import resolve_device
        resolve_device("cuda")
        have = torch.cuda.device_count()
        for i in range(have):
            p = torch.cuda.get_device_properties(i)
            print(f"  device[cuda:{i}] {p.name} sm_{p.major}{p.minor} "
                  f"{p.multi_processor_count} SMs "
                  f"{p.total_memory / 2 ** 30:.1f} GiB")
        smi = power_limit()
        if smi is not None:
            print(f"  nvidia-smi: {smi}")
        if n_devices > have:
            raise RuntimeError(f"--devices {n_devices} needs {n_devices} "
                               f"CUDA devices but only {have} are visible "
                               "(list CPU grids with --device cpu)")
        n = n_devices or have
    facs = [(s, n // s) for s in range(1, n + 1) if n % s == 0]
    print(f"  {n} device(s); stream x ch mesh shapes: "
          + " ".join(f"{a}x{b}" for a, b in facs))
    return n


def probe_replay(path: str):
    import numpy as np

    from pysdr_tpu_torch.io import datfile
    rd = datfile.DatReader(path)
    h = rd.header
    print(f"replay {path}:")
    print(f"  fs={rd.srate / 1e6:.6f} MHz  fc={rd.fc / 1e6:.6f} MHz "
          f"nchan={h.nchan} dtype={h.dtype} tag={h.tag}")
    x = rd.read_data(min(1 << 16, 4096))
    data_bytes = os.path.getsize(path) - rd._data_start
    dur = data_bytes / (rd._isize * rd.srate)     # honors compact dtypes
    print(f"  ~{dur:.1f} s of capture; first block: rms="
          f"{np.sqrt(np.mean(np.abs(x) ** 2)):.4f} "
          f"peak={np.max(np.abs(x)):.4f} dc={np.mean(x):.5f}")
    rd.close()


def probe_native() -> bool:
    from pysdr_tpu_torch.runtime import native
    ok = native.available()
    print("native C++ runtime (libsdrio.so): "
          + ("available" if ok else
             "NOT built (make -C pysdr_tpu_torch/native failed)"))
    return ok


def probe_synth():
    import numpy as np

    from pysdr_tpu_torch.io import synth
    src = synth.SynthSource(
        [synth.SignalSpec(offset_hz=50e3, mode="am", amplitude=0.5,
                          audio_hz=400.0)], 512e3, noise_rms=0.001)
    t0 = time.perf_counter()
    x = src.read_data(1 << 18)
    rate = len(x) / (time.perf_counter() - t0)
    print(f"synth source: ok rms={np.sqrt(np.mean(np.abs(x) ** 2)):.3f} "
          f"({rate / 1e6:.1f} Msamp/s host generation)")


def probe_rtl_tcp(hostport: str):
    """Connect to an rtl_tcp server and dump its identity + a stream
    sample (the reference's check_sdr_settings dump, utils.py:358-422,
    over the network path)."""
    import numpy as np

    from pysdr_tpu_torch.io import rtltcp
    host, _, port = hostport.partition(":")
    src = rtltcp.RtlTcpSource(host or "127.0.0.1", int(port or 1234),
                              fs=1.024e6, fc=100e6)
    try:
        print(f"rtl_tcp {hostport}: tuner={src.tuner} "
              f"(type {src.tuner_type}), "
              f"{src.tuner_gain_count} gain steps")
        x = src.read_data(1 << 15)
        print(f"  stream: {len(x)} samples  "
              f"rms={np.sqrt(np.mean(np.abs(x) ** 2)):.4f} "
              f"peak={np.max(np.abs(x)):.4f} dc={np.mean(x):.5f} "
              f"dropped={src.dropped}")
    finally:
        src.close()


def smoke(device: str = "cuda") -> bool:
    """One end-to-end block of the port's ReceiverBank on `device` (the
    reference's `-test` hook, pySDR.py:126-128). Returns True when the
    400 Hz AM tone comes out (audio rms > 1e-3)."""
    import numpy as np

    from pysdr_tpu_torch.config import PipelineConfig, ReceiverConfig
    from pysdr_tpu_torch.models.receiver import ReceiverBank
    from pysdr_tpu_torch.tables import Mode
    cfg = PipelineConfig(fs_in=512e3, fs_out=48e3, out_block=2048,
                         foffset_hz=60e3,
                         receivers=(ReceiverConfig(fc_hz=100e6,
                                                   mode=Mode.AM),))
    bank = ReceiverBank(cfg, device=device)
    d = bank.design
    t = np.arange(d.in_block) / d.fs_in
    x = (0.5 * (1 + 0.5 * np.sin(2 * np.pi * 400 * t))
         * np.exp(2j * np.pi * 60e3 * t)).astype(np.complex64)
    t0 = time.perf_counter()
    audio = bank.step(x)
    dt = time.perf_counter() - t0
    rms = float(np.sqrt(np.mean(audio.real ** 2)))
    ok = rms > 1e-3
    print(f"smoke: 1 block ({d.in_block} samples) on {bank.device} ran in "
          f"{dt:.1f}s, audio rms={rms:.4f} {'OK' if ok else 'SILENT?'}")
    return ok


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="pysdr_tpu_torch.probe")
    ap.add_argument("--replay", type=str, default=None)
    ap.add_argument("--rtl-tcp", type=str, default=None,
                    metavar="HOST:PORT",
                    help="probe a live rtl_tcp server")
    ap.add_argument("--smoke", action="store_true",
                    help="run one block end to end")
    ap.add_argument("--devices", type=int, default=0,
                    help="list the --mesh grids of N devices (on the CPU, "
                         "N repeats of the one CPU device)")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="where the smoke block runs (default cuda; never "
                         "falls back to the CPU)")
    args = ap.parse_args(argv)
    try:
        probe_devices(args.device, args.devices)
    except RuntimeError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    probe_native()
    probe_synth()
    if args.replay:
        if not os.path.exists(args.replay):
            print(f"error: {args.replay} not found", file=sys.stderr)
            return 2
        probe_replay(args.replay)
    if args.rtl_tcp:
        try:
            probe_rtl_tcp(args.rtl_tcp)
        except (OSError, ConnectionError, TimeoutError) as e:
            print(f"rtl_tcp {args.rtl_tcp}: {e}", file=sys.stderr)
            return 2
    if args.smoke and not smoke(args.device):
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
