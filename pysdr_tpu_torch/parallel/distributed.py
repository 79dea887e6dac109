"""Multi-process initialization + scaling harness (counterpart of
pysdr_tpu/parallel/distributed.py).

The reference is strictly single-host (SURVEY.md §2.10 row 5: mp.Pipe/
Queue/Event intra-host only). The JAX package scales across hosts with
`jax.distributed`; the port does so with `torch.distributed`: every
process runs the same program over its own devices, the stream axis of
the grid runs across ranks, and a stream halo that crosses a rank
boundary goes by `dist.send`/`dist.recv` of the segment's tail
(parallel/stream.left_halos); the carried tail and demod state come from
the last rank by broadcast. One process drives its own devices as in the
single-process path.

Usage (one command per process):

    python -m pysdr_tpu_torch.parallel.distributed \\
        --coordinator HOST0:1234 --nprocs 4 --proc-id $I [--demo rx|chan]

gloo on CPU only (`--cpu-devices N`, N repeats of the CPU device a
process); NCCL on CUDA is wired but not run across GPUs (the card host
has one). Under torchrun the flags are optional. The module also backs
the two-process CPU test (tests/test_torch_distributed.py).
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch


def init_distributed(coordinator: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None,
                     device: str = "cuda") -> bool:
    """Initialize torch.distributed (gloo for the CPU, NCCL for cuda)
    when running multi-process; no-op (and False) for single-process runs
    so the same entry point serves both.

    Under torchrun (MASTER_ADDR and WORLD_SIZE > 1 in the environment)
    pass NO flags. Without those and without flags this stays
    single-process LOUDLY (each process computing alone with rank 0
    everywhere is exactly the silent failure to avoid)."""
    import torch.distributed as dist
    backend = "gloo" if device == "cpu" else "nccl"
    if num_processes is None:
        num_processes = int(os.environ.get("PYSDR_TPU_NPROCS", "1"))
    if num_processes <= 1 and coordinator is None:
        if os.environ.get("MASTER_ADDR") \
                and int(os.environ.get("WORLD_SIZE", "1")) > 1:
            dist.init_process_group(backend, init_method="env://")
            return True
        print("init_distributed: single-process (no --coordinator/"
              "--nprocs flags and no torchrun environment detected)",
              flush=True)
        return False
    if coordinator is None or process_id is None or num_processes < 1:
        raise ValueError("a multi-process run needs --coordinator "
                         "HOST:PORT, --nprocs and --proc-id")
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id)
    return True


def _rank_world() -> tuple[int, int]:
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _local_devices(devices) -> list:
    from pysdr_tpu_torch.parallel.mesh import indexed
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    return [indexed(d) for d in devices]


def global_mesh(n_stream: int = 1, devices=None):
    """The global stream x ch grid: rank r drives n_stream / world stream
    rows over its local `devices` (default its visible cards), so the
    stream axis runs across ranks and every channel shard of a row is
    local."""
    from pysdr_tpu_torch.parallel.mesh import Mesh
    rank, world = _rank_world()
    local = _local_devices(devices)
    if n_stream % world:
        raise ValueError(f"{n_stream} stream rows do not split over "
                         f"{world} processes")
    rows = n_stream // world
    if not local or len(local) % rows:
        raise ValueError(f"{len(local)} local devices do not split into "
                         f"{rows} stream rows")
    cols = len(local) // rows
    grid = tuple(tuple(local[r * cols:(r + 1) * cols]) for r in range(rows))
    return Mesh(grid, {"stream": n_stream, "ch": cols},
                stream_offset=rank * rows, rank=rank, world=world)


def _global_ch_mesh(devices=None):
    """A channel-only grid over every process's devices: rank r drives
    channel shards r*L .. r*L + L - 1 of its L local devices."""
    from pysdr_tpu_torch.parallel.mesh import Mesh
    rank, world = _rank_world()
    local = _local_devices(devices)
    return Mesh((tuple(local),), {"ch": world * len(local)},
                ch_offset=rank * len(local), rank=rank, world=world)


def _digest(pieces) -> float:
    """sum |audio| over this process's shards, summed over all ranks."""
    total = torch.tensor(sum(float(p.abs().double().sum().cpu())
                             for p in pieces), dtype=torch.float64)
    rank, world = _rank_world()
    if world > 1:
        import torch.distributed as dist
        dist.all_reduce(total)
    return float(total)


def _tone_bank(n_ch: int, device):
    from pysdr_tpu_torch.config import PipelineConfig, ReceiverConfig
    from pysdr_tpu_torch.models.receiver import ReceiverBank
    from pysdr_tpu_torch.tables import Mode
    rxs = tuple(ReceiverConfig(fc_hz=100e6 + 20e3 * i, mode=Mode.AM,
                               agc_enabled=False)
                for i in range(max(n_ch, 1)))
    cfg = PipelineConfig(fs_in=512e3, fs_out=48e3, out_block=128,
                         foffset_hz=60e3, receivers=rxs)
    return ReceiverBank(cfg, device=device)


def _local_part(x: np.ndarray, mesh, seg: int) -> torch.Tensor:
    """This rank's stream segments of a global host block, as float32
    pairs on its first device."""
    rows = len(mesh.devices)
    part = x[mesh.stream_offset * seg:(mesh.stream_offset + rows) * seg]
    return torch.from_numpy(np.ascontiguousarray(
        part.view(np.float32).reshape(-1, 2))).to(mesh.first)


def demo_receiver(n_stream: int, devices=None) -> float:
    """One sharded stream-processor step over the global grid; prints a
    digest every process can cross-check (halo-exchange probe)."""
    from pysdr_tpu_torch.parallel import stream as stream_mod
    mesh = global_mesh(n_stream, devices)
    bank = _tone_bank(mesh.n_ch, mesh.first)
    seg = 4 * bank.design.in_block
    proc, halo = stream_mod.make_stream_processor(bank, mesh, seg)
    n_total = mesh.n_stream * seg
    t = np.arange(n_total) / bank.design.fs_in
    x = (0.5 * np.exp(2j * np.pi * 60e3 * t)).astype(np.complex64)
    digest = _digest(proc(_local_part(x, mesh, seg), bank.params))
    print(f"distributed rx ok: pid={mesh.rank} mesh={dict(mesh.shape)} "
          f"halo={halo} digest={digest:.4f}", flush=True)
    return digest


def demo_streaming(n_stream: int, devices=None) -> float:
    """TWO consecutive super-blocks through the STATE-CONTINUOUS
    streaming processor over the global grid: the carried RF tail and
    demod state cross the process boundary between calls, so matching
    digests prove the repeated-call sharded path across processes."""
    from pysdr_tpu_torch.parallel import stream as stream_mod
    mesh = global_mesh(n_stream, devices)
    bank = _tone_bank(mesh.n_ch, mesh.first)
    seg = 4 * bank.design.in_block
    proc, halo = stream_mod.make_streaming_processor(bank, mesh, seg)
    n_total = mesh.n_stream * seg
    first = mesh.first
    tail = torch.zeros((halo, 2), dtype=torch.float32, device=first)
    nb = torch.zeros(bank.n_rx, dtype=torch.int64, device=first)
    bb = torch.zeros(bank.n_rx, dtype=torch.int64, device=first)
    dstate = bank.state.ch.demod
    digest = 0.0
    for call in range(2):
        t = (call * n_total + np.arange(n_total)) / bank.design.fs_in
        x = (0.5 * np.exp(2j * np.pi * 60e3 * t)).astype(np.complex64)
        audio, nb, bb, tail, dstate, _ = proc(
            _local_part(x, mesh, seg), bank.params, tail, nb, bb, dstate)
        digest += _digest(audio)
    print(f"distributed streaming ok: pid={mesh.rank} "
          f"mesh={dict(mesh.shape)} halo={halo} digest={digest:.4f}",
          flush=True)
    return digest


def demo_channelizer(devices=None) -> float:
    """One channel-sharded channelizer step, the channel axis across
    every process's devices."""
    from pysdr_tpu_torch.models.channelizer_bank import (
        ChannelizerBank, ChannelizerBankConfig, ChannelSettings)
    from pysdr_tpu_torch.parallel import chanshard
    from pysdr_tpu_torch.tables import Mode
    mesh = _global_ch_mesh(devices)
    n_ch = 8 * mesh.n_ch
    cfg = ChannelizerBankConfig(
        fs_in=n_ch * 48e3, n_channels=n_ch, fs_out=48e3, out_block=128,
        fc_hz=100e6,
        channels=tuple(ChannelSettings(mode=Mode.AM, agc_enabled=False)
                       for _ in range(n_ch)))
    cb = ChannelizerBank(cfg, device=mesh.first)
    proc, slices = chanshard.make_channelizer_processor(cb, mesh)
    states, params = chanshard.shard_inputs(cb, mesh, slices)
    offs = np.fft.fftfreq(n_ch, 1.0 / cfg.fs_in)
    t = np.arange(cb.design.in_block) / cfg.fs_in
    x = np.exp(2j * np.pi * offs[1] * t).astype(np.complex64)
    xp = torch.from_numpy(x.view(np.float32).reshape(-1, 2)).to(mesh.first)
    _, audio = proc(states, xp, params)
    digest = _digest(audio)
    print(f"distributed chan ok: pid={mesh.rank} n_ch={n_ch} "
          f"digest={digest:.4f}", flush=True)
    return digest


def main(argv=None):
    ap = argparse.ArgumentParser(prog="pysdr_tpu_torch.parallel.distributed")
    ap.add_argument("--coordinator", default=None,
                    help="HOST:PORT of process 0 (torchrun sets it)")
    ap.add_argument("--nprocs", type=int, default=None)
    ap.add_argument("--proc-id", type=int, default=None)
    ap.add_argument("--n-stream", type=int, default=1)
    ap.add_argument("--demo", choices=["rx", "chan", "streaming", "both"],
                    default="both")
    ap.add_argument("--cpu-devices", type=int, default=0,
                    help="emulate N local CPU devices per process")
    args = ap.parse_args(argv)

    devices = (["cpu"] * args.cpu_devices) if args.cpu_devices else None
    init_distributed(args.coordinator, args.nprocs, args.proc_id,
                     device="cpu" if args.cpu_devices else "cuda")
    if args.demo in ("rx", "both"):
        demo_receiver(args.n_stream, devices)
    if args.demo in ("chan", "both"):
        demo_channelizer(devices)
    if args.demo in ("streaming", "both"):
        demo_streaming(args.n_stream, devices)
    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
