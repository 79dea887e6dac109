"""ctypes wrappers of the scan kernels in csrc/scan.cu.

Each wrapper checks dtype, shape, strides and device and raises on
anything its kernel does not take, allocates the outputs with
torch.empty, launches on the current CUDA stream without synchronising,
raises if the launch returned a CUDA error, and counts its launches in
`<wrapper>.launches` (build.count_launch; reset with
kernels.reset_launch_counts). The plain
torch twins are ops.scanops.linrec_ref / sr_latch_ref.

Both kernels carry between time tiles by look-back (see csrc/scan.cu).
Its status words and control words (the epoch, a count of finished
blocks, the per-row tile tickets) live in one `_Lookback` per kernel and
device, kept across calls. The epoch is on the card: each launch tags
its words with it and its last block moves it on, clearing the words
when it wraps, so no launch takes a changing value from the host and
none clears a buffer first; the two buffers grow together when a larger
shape comes. Eager launches take the buffers of their (device, stream);
a launch captured into a CUDA graph takes those of the graph, which the
capture names with `lookback_scope`, and a capture without one raises.
"""

from __future__ import annotations

import contextlib
import threading

import torch

from pysdr_tpu_torch.kernels import build

# the fewest blocks a launch is given where a longer tile would leave
# fewer: with 132 SMs, enough to keep the card's memory busy
MIN_BLOCKS = 128
# linrec: 64 threads per column, each scanning a run of 8 or 16 samples
LINREC_RUNS = (16, 8)
# sr_latch: 16 samples a lane, one or four warps a tile
LATCH_RUN = 16
LATCH_WARPS = (4, 1)


def linrec_geometry(batch: int, n: int, k: int) -> tuple[int, int, int]:
    """(tile samples, threads per block, tiles per row) of a linrec
    launch over `batch` rows of n samples and k columns: a block per
    (row, tile), the longer tile where it still gives MIN_BLOCKS."""
    for run in LINREC_RUNS:
        tile = 64 * run
        tiles = -(-n // tile)
        if batch * tiles >= MIN_BLOCKS or run == LINREC_RUNS[-1]:
            return tile, 64 * k, tiles


def sr_latch_geometry(batch: int, n: int) -> tuple[int, int, int]:
    """(tile samples, threads per block, tiles per row) of an sr_latch
    launch, as for linrec_geometry."""
    for warps in LATCH_WARPS:
        tile = 32 * warps * LATCH_RUN
        tiles = -(-n // tile)
        if batch * tiles >= MIN_BLOCKS or warps == LATCH_WARPS[-1]:
            return tile, 32 * warps, tiles


# the control words ahead of the row tickets: the epoch count and the
# finished blocks (csrc/scan.cu, kCtlTickets)
CTL_HEAD = 2
# the largest epoch a status word's tag holds: linrec's 64-bit words a
# 30-bit one, sr_latch's bytes a 5-bit one (csrc/scan.cu)
MAX_EPOCH = {"linrec": (1 << 30) - 1, "sr_latch": 31}


class _Lookback:
    """Status words and control words of one kernel's launches that run
    one after another (one stream, or one graph's replays). `ctl` holds
    the epoch, the finished blocks and the tickets, which the kernel
    keeps (csrc/scan.cu); a launch leaves the words tagged with its
    epoch, so the two grow together, both zeroed: the epoch starts again
    with words that are all clean."""

    def __init__(self, device, dtype, per_slot: int, max_epoch: int):
        self.device = device
        self.dtype = dtype
        self.per_slot = per_slot
        self.max_epoch = max_epoch
        self.words = torch.zeros(0, dtype=dtype, device=device)
        self.ctl = torch.zeros(0, dtype=torch.int32, device=device)
        self.lock = threading.Lock()

    @classmethod
    def of(cls, kind: str, device) -> "_Lookback":
        """linrec: three tagged 64-bit words a slot; sr_latch: one byte."""
        if kind == "linrec":
            return cls(device, torch.int64, 3, MAX_EPOCH[kind])
        return cls(device, torch.uint8, 1, MAX_EPOCH[kind])

    def claim(self, slots: int, rows: int) -> None:
        """Room for `slots` status slots and `rows` tickets. Call under
        self.lock, and launch before releasing it. Growing allocates, so
        it raises while the stream is being captured: the capture's
        warm-up runs the same shapes first."""
        need = slots * self.per_slot
        if self.words.numel() >= need and self.ctl.numel() >= CTL_HEAD + rows:
            return
        if self.device.type == "cuda" and \
                torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                "scan look-back buffers would grow inside a CUDA graph "
                "capture: run the captured step once first")
        cap = max(self.words.numel(), 1 << (need - 1).bit_length())
        rows_cap = max(self.ctl.numel() - CTL_HEAD,
                       1 << (rows - 1).bit_length())
        self.words = torch.zeros(cap, dtype=self.dtype, device=self.device)
        self.ctl = torch.zeros(CTL_HEAD + rows_cap, dtype=torch.int32,
                               device=self.device)


class Lookbacks:
    """The look-back buffers of one CUDA graph, kind by kind: launches
    inside `lookback_scope(this)` take these, so the graph's replays,
    which run one after another, own them alone."""

    def __init__(self):
        self._by_kind: dict = {}

    def get(self, kind: str, device: torch.device) -> _Lookback:
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        lb = self._by_kind.get(kind)
        if lb is None:
            lb = self._by_kind[kind] = _Lookback.of(kind, device)
        if lb.device != device:
            raise ValueError(f"{kind}: look-back buffers of {lb.device} "
                             f"used on {device}")
        return lb


_scope = threading.local()


@contextlib.contextmanager
def lookback_scope(lookbacks: Lookbacks):
    """Within: this thread's scan launches use `lookbacks`' buffers (a
    graph's capture and the warm-up before it)."""
    prev = getattr(_scope, "lookbacks", None)
    _scope.lookbacks = lookbacks
    try:
        yield lookbacks
    finally:
        _scope.lookbacks = prev


_lookbacks: dict = {}
_lookbacks_lock = threading.Lock()


def _lookback(kind: str, device: torch.device) -> _Lookback:
    """The buffers of this launch: those of the thread's lookback_scope,
    else those of the current (device, stream); a capture must name
    its own."""
    scoped = getattr(_scope, "lookbacks", None)
    if scoped is not None:
        return scoped.get(kind, device)
    if torch.cuda.is_current_stream_capturing():
        raise RuntimeError(
            f"{kind}: a CUDA graph capture must name its look-back "
            "buffers (kernels.scan.lookback_scope)")
    key = (kind, device.index, torch.cuda.current_stream(device).cuda_stream)
    with _lookbacks_lock:
        lb = _lookbacks.get(key)
        if lb is None:
            lb = _lookbacks[key] = _Lookback.of(kind, device)
        return lb


def _a_layout(a, shape, device) -> tuple[int, int, int, int]:
    """(a_mode, pointer, stride along B, stride along k) of linrec's `a`:
    mode 0 a python scalar, 1 a tensor with stride 0 along n, or n = 1
    (one value per row and column), 2 a contiguous tensor."""
    if isinstance(a, (int, float)):
        return 0, 0, 0, 0
    if not isinstance(a, torch.Tensor):
        raise ValueError(f"a: expected a tensor or a float, got {type(a)}")
    if a.dtype != torch.float32:
        raise ValueError(f"a: expected torch.float32, got {a.dtype}")
    if tuple(a.shape) != tuple(shape):
        raise ValueError(f"a: expected shape {tuple(shape)}, got "
                         f"{tuple(a.shape)}")
    if a.stride(1) == 0 or shape[1] == 1:
        mode = 1
    elif a.is_contiguous():
        mode = 2
    else:
        raise ValueError("a: must be contiguous or have stride 0 along n "
                         f"(strides {a.stride()})")
    if a.device.type != "cuda" or a.device != device:
        raise ValueError(f"a: expected a CUDA tensor on {device}, got "
                         f"{a.device}")
    return mode, a.data_ptr(), a.stride(0), a.stride(2)


def linrec(a, b: torch.Tensor, y_prev: torch.Tensor):
    """y[i] = a[i]*y[i-1] + b[i] along axis 1. b float32 (B, n, k)
    contiguous CUDA, k <= 4; a a float32 tensor of b's shape, contiguous
    or with stride 0 along n (a per-column constant, expanded: read once
    a column, never copied), or a python float; y_prev (B, k). Returns
    (y (B, n, k), y_last (B, k))."""
    if b.dim() != 3:
        raise ValueError(f"b: expected (B, n, k), got {tuple(b.shape)}")
    B, n, k = b.shape
    if n < 1 or k > 4 or B * n * k >= 2 ** 31:
        raise ValueError(f"linrec: unsupported shape {(B, n, k)} "
                         "(k <= 4 columns)")
    f32 = (torch.float32,)
    build.check_tensors((b, "b", f32, (B, n, k)),
                        (y_prev, "y_prev", f32, (B, k)))
    if y_prev.device != b.device:
        raise ValueError("linrec: inputs on different devices")
    a_mode, a_ptr, sa_b, sa_k = _a_layout(a, (B, n, k), b.device)
    a_scalar = float(a) if a_mode == 0 else 0.0
    tile, _, tiles = linrec_geometry(B, n, k)
    y = torch.empty_like(b)
    y_last = torch.empty((B, k), dtype=torch.float32, device=b.device)
    lib = build.library()
    with torch.cuda.device(b.device):
        lb = _lookback("linrec", b.device)
        stream = torch.cuda.current_stream().cuda_stream
        with lb.lock:
            lb.claim(B * k * tiles, B)
            rc = lib.pysdr_linrec_f32(
                a_ptr, a_scalar, sa_b, sa_k, a_mode, b.data_ptr(),
                y_prev.data_ptr(), y.data_ptr(), y_last.data_ptr(), B, n, k,
                tile, lb.words.data_ptr(), lb.words.numel(),
                lb.ctl.data_ptr(), lb.max_epoch, stream)
    build.check_launch(rc, "linrec")
    build.count_launch(linrec)
    return y, y_last


linrec.launches = 0


def sr_latch(set_: torch.Tensor, reset: torch.Tensor, g_prev: torch.Tensor):
    """Set/reset latch along axis 1. set_, reset bool (B, n) contiguous
    CUDA; g_prev float32 (B,). Returns (gate float32 (B, n), gate_last (B,))."""
    if set_.dim() != 2:
        raise ValueError(f"set_: expected (B, n), got {tuple(set_.shape)}")
    B, n = set_.shape
    if n < 1 or B * n >= 2 ** 31:
        raise ValueError(f"sr_latch: unsupported shape {(B, n)}")
    build.check_tensors((set_, "set_", (torch.bool,), (B, n)),
                        (reset, "reset", (torch.bool,), (B, n)),
                        (g_prev, "g_prev", (torch.float32,), (B,)))
    if reset.device != set_.device or g_prev.device != set_.device:
        raise ValueError("sr_latch: inputs on different devices")
    tile, _, tiles = sr_latch_geometry(B, n)
    gate = torch.empty((B, n), dtype=torch.float32, device=set_.device)
    gate_last = torch.empty((B,), dtype=torch.float32, device=set_.device)
    lib = build.library()
    with torch.cuda.device(set_.device):
        lb = _lookback("sr_latch", set_.device)
        stream = torch.cuda.current_stream().cuda_stream
        with lb.lock:
            lb.claim(B * tiles, B)
            # bool and uint8 share one byte per element: pass the storage
            rc = lib.pysdr_sr_latch_u8(
                set_.data_ptr(), reset.data_ptr(), g_prev.data_ptr(),
                gate.data_ptr(), gate_last.data_ptr(), B, n, tile,
                lb.words.data_ptr(), lb.words.numel(), lb.ctl.data_ptr(),
                lb.max_epoch, stream)
    build.check_launch(rc, "sr_latch")
    build.count_launch(sr_latch)
    return gate, gate_last


sr_latch.launches = 0
