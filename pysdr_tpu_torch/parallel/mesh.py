"""Device grid construction (counterpart of pysdr_tpu/parallel/mesh.py).

The reference's parallel axes are OS processes: one process per RX
(MP_SCHEME 3, reference am.py:85-114) and thread pipelines. The port's
axes are a 2-D grid of devices, driven from one process as the JAX
package drives its Mesh from one controller:

  'ch'     — channel parallelism: shards of the receiver bank's channel
             axis (the arbitrary-N generalization of MAX_RX=6);
  'stream' — time parallelism: contiguous stream segments processed
             with overlap-discard halos (SURVEY.md §2.10).

A device may appear more than once: that is how a grid runs on the one
CPU device (the counterpart of the JAX package's virtual CPU devices) or
on one card, its shards issued in turn. Multi-process runs
(parallel/distributed.py) build their grid with `global_mesh` there.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class Mesh:
    """The devices this process drives, as an (S_local, C_local) grid of
    torch.devices (row r, column c), with the GLOBAL axis sizes in
    `shape`, keyed "stream" and "ch" (only the axes the mesh has, as the
    JAX Mesh keys them). Local row 0 is global stream index
    `stream_offset`, local column 0 global channel shard `ch_offset`;
    `rank` and `world` are the torch.distributed process's (0 and 1 in
    one process)."""
    devices: tuple
    shape: dict
    stream_offset: int = 0
    ch_offset: int = 0
    rank: int = 0
    world: int = 1

    @property
    def n_stream(self) -> int:
        return self.shape.get("stream", 1)

    @property
    def n_ch(self) -> int:
        return self.shape.get("ch", 1)

    @property
    def first(self) -> torch.device:
        """The device of local shard (0, 0)."""
        return self.devices[0][0]


@dataclasses.dataclass(frozen=True)
class Shard:
    """One shard of a mesh's local grid: its place in grid order (row by
    row), its local row and column, its global stream index, its device
    and the channel rows it owns."""
    index: int
    row: int
    col: int
    stream: int
    device: torch.device
    rows: slice


def shards(mesh: Mesh, slices) -> list:
    """The local shards in grid order; `slices[c]` the channel rows of
    local column c."""
    out = []
    for r, row in enumerate(mesh.devices):
        for c, (dev, sl) in enumerate(zip(row, slices)):
            out.append(Shard(len(out), r, c, mesh.stream_offset + r, dev,
                             sl))
    return out


def indexed(device) -> torch.device:
    """A torch.device with its index: "cuda" becomes the current card."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def _devices(devices) -> list:
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    return [indexed(d) for d in devices]


def make_mesh(n_stream: int = 1, n_ch: int | None = None,
              devices=None) -> Mesh:
    """An (n_stream, n_ch) grid over the first n_stream*n_ch of `devices`
    (default: the visible CUDA devices), row by row; n_ch defaults to
    all of them over n_stream rows."""
    devices = _devices(devices)
    nd = len(devices)
    if n_ch is None:
        if n_stream < 1 or nd % n_stream:
            raise ValueError(f"{nd} devices do not split into {n_stream} "
                             "stream rows")
        n_ch = nd // n_stream
    if n_stream < 1 or n_ch < 1 or n_stream * n_ch > nd:
        raise ValueError(f"a {n_stream} x {n_ch} mesh needs "
                         f"{max(n_stream * n_ch, 1)} devices, {nd} given")
    grid = tuple(tuple(devices[r * n_ch:(r + 1) * n_ch])
                 for r in range(n_stream))
    return Mesh(grid, {"stream": n_stream, "ch": n_ch})


def single_axis_mesh(axis: str = "ch", devices=None) -> Mesh:
    """A one-axis mesh over all of `devices`: one row of channel shards,
    or one column of stream shards."""
    devices = _devices(devices)
    if not devices:
        raise ValueError("a mesh needs at least one device")
    if axis == "ch":
        grid = (tuple(devices),)
    elif axis == "stream":
        grid = tuple((d,) for d in devices)
    else:
        raise ValueError(f"unknown mesh axis {axis!r} (stream or ch)")
    return Mesh(grid, {axis: len(devices)})


def gather(pieces, mesh: Mesh, device="cpu") -> torch.Tensor:
    """Per-shard outputs in grid order (row by row), each (channels of
    the shard, T, ...), as one tensor (channels, rows * T, ...) on
    `device`: a column's stream shards side by side in time, the columns
    stacked."""
    cols = len(mesh.devices[0])
    return torch.cat([torch.cat([p.to(device) for p in pieces[c::cols]],
                                dim=1) for c in range(cols)], dim=0)
