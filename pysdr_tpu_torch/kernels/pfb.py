"""ctypes wrapper of the PFB branch-filter kernel in csrc/pfb.cu.

Same discipline as kernels/scan.py: the wrapper checks dtype, shape,
contiguity, device and alignment, allocates the outputs with
torch.empty, launches on the current CUDA stream without synchronising,
raises if the launch returned a CUDA error, and counts its launches in
`pfb_branch.launches` (build.count_launch). The plain torch twin is
ops.channelizer.branch_filter_ref.
"""

from __future__ import annotations

import numpy as np
import torch

from pysdr_tpu_torch.kernels import build

# wire dtype -> (code in pysdr_pfb_branch, dequantize scale of ops/cplx)
WIRES = {torch.float32: (0, 1.0),
         torch.int16: (1, float(np.float32(1.0 / 32767.0))),
         torch.int8: (2, float(np.float32(1.0 / 127.0)))}


def pfb_branch(x_wire: torch.Tensor, hist: torch.Tensor,
               taps: torch.Tensor):
    """Branch filter of one wire block, dequantizing in the load.

    x_wire float32 / int16 / int8 (n, 2) pairs, n % N == 0; hist
    complex64 ((K-1)*N,) dequantized tail of the previous block; taps
    float32 (N, K) from pack_branch_weights. All contiguous, on one CUDA
    device. Returns (v complex64 (n // N, N), new_hist ((K-1)*N,))."""
    if not isinstance(taps, torch.Tensor) or taps.dim() != 2:
        raise ValueError(f"taps: expected (N, K), got "
                         f"{tuple(getattr(taps, 'shape', ()))}")
    nch, k = taps.shape
    if not isinstance(x_wire, torch.Tensor) or x_wire.dim() != 2:
        raise ValueError(f"x_wire: expected (n, 2), got "
                         f"{tuple(getattr(x_wire, 'shape', ()))}")
    n = x_wire.shape[0]
    if n < 1 or n % nch or 2 * n >= 2 ** 31:
        raise ValueError(f"pfb_branch: block of {n} samples is not a "
                         f"positive multiple of N={nch} below 2^30")
    build.check_tensors((x_wire, "x_wire", tuple(WIRES), (n, 2)),
                        (hist, "hist", (torch.complex64,), ((k - 1) * nch,)),
                        (taps, "taps", (torch.float32,), (nch, k)))
    for name, t in (("x_wire", x_wire), ("hist", hist)):
        # the kernel loads these as 2-element vectors
        if t.data_ptr() % (2 * t.element_size()):
            raise ValueError(f"{name}: storage is not aligned to its pairs")
    if hist.device != x_wire.device or taps.device != x_wire.device:
        raise ValueError("pfb_branch: inputs on different devices")
    wire, scale = WIRES[x_wire.dtype]
    v = torch.empty((n // nch, nch), dtype=torch.complex64,
                    device=x_wire.device)
    new_hist = torch.empty_like(hist)
    lib = build.library()
    with torch.cuda.device(x_wire.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.pysdr_pfb_branch(x_wire.data_ptr(), wire, scale,
                                  hist.data_ptr(), taps.data_ptr(),
                                  v.data_ptr(), new_hist.data_ptr(), n, nch,
                                  k, stream)
    build.check_launch(rc, "pfb_branch")
    build.count_launch(pfb_branch)
    return v, new_hist


pfb_branch.launches = 0
