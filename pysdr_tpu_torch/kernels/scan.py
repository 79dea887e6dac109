"""ctypes wrappers of the scan kernels in csrc/scan.cu.

Each wrapper checks dtype, shape, contiguity and device
(kernels.build.check_tensors) and raises on anything its kernel does not
take, allocates the outputs with
torch.empty, launches on the current CUDA stream without synchronising,
raises if the launch returned a CUDA error, and counts its launches in
`<wrapper>.launches` (reset with kernels.reset_launch_counts). The plain
torch twins are ops.scanops.linrec_ref / sr_latch_ref.
"""

from __future__ import annotations

import torch

from pysdr_tpu_torch.kernels import build


def _threads(n: int) -> int:
    """Threads per block: about 32 samples of serial work each, a power
    of two in [32, 1024]."""
    t = 32
    while t < 1024 and t * 32 < n:
        t *= 2
    return t


def linrec(a: torch.Tensor, b: torch.Tensor, y_prev: torch.Tensor):
    """y[i] = a[i]*y[i-1] + b[i] along axis 1. a, b float32 (B, n, k)
    contiguous CUDA; y_prev (B, k). Returns (y (B, n, k), y_last (B, k))."""
    if a.dim() != 3:
        raise ValueError(f"a: expected (B, n, k), got {tuple(a.shape)}")
    B, n, k = a.shape
    if n < 1 or B * n * k >= 2 ** 31:
        raise ValueError(f"linrec: unsupported shape {(B, n, k)}")
    f32 = (torch.float32,)
    build.check_tensors((a, "a", f32, (B, n, k)), (b, "b", f32, (B, n, k)),
                        (y_prev, "y_prev", f32, (B, k)))
    if b.device != a.device or y_prev.device != a.device:
        raise ValueError("linrec: inputs on different devices")
    y = torch.empty_like(a)
    y_last = torch.empty((B, k), dtype=torch.float32, device=a.device)
    lib = build.library()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.pysdr_linrec_f32(a.data_ptr(), b.data_ptr(),
                                  y_prev.data_ptr(), y.data_ptr(),
                                  y_last.data_ptr(), B, n, k, _threads(n),
                                  stream)
    build.check_launch(rc, "linrec")
    linrec.launches += 1
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
    gate = torch.empty((B, n), dtype=torch.float32, device=set_.device)
    gate_last = torch.empty((B,), dtype=torch.float32, device=set_.device)
    lib = build.library()
    with torch.cuda.device(set_.device):
        stream = torch.cuda.current_stream().cuda_stream
        # bool and uint8 share one byte per element: pass the storage as is
        rc = lib.pysdr_sr_latch_u8(set_.data_ptr(), reset.data_ptr(),
                                   g_prev.data_ptr(), gate.data_ptr(),
                                   gate_last.data_ptr(), B, n, _threads(n),
                                   stream)
    build.check_launch(rc, "sr_latch")
    sr_latch.launches += 1
    return gate, gate_last


sr_latch.launches = 0
