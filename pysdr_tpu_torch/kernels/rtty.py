"""ctypes wrapper of the RTTY soft-bit + matched-filter kernel in
csrc/rtty.cu.

Same discipline as kernels/pfb.py: the wrapper checks dtype, shape,
contiguity and device, allocates the outputs with torch.empty, launches
on the current CUDA stream without synchronising, raises if the launch
returned a CUDA error, and counts its launches in `rtty_scores.launches`
(build.count_launch).
The plain torch twin is models.rtty.rtty_scores_ref.
"""

from __future__ import annotations

import torch

from pysdr_tpu_torch.kernels import build

N_SYMBOLS = 32                 # the Baudot templates, one warp per (o, c)


def rtty_scores(mags: torch.Tensor, mark_bins: torch.Tensor,
                space_bins: torch.Tensor, soft_tail: torch.Tensor,
                templates: torch.Tensor):
    """Soft bits of one block after the carried tail, and their matched
    scores against the 32 templates.

    mags float32 (F, nfft); mark_bins, space_bins int32 (C,), taken
    modulo nfft; soft_tail float32 (T, C); templates float32 (32, L). All
    contiguous, on one CUDA device. Returns (soft float32 (T+F, C),
    scores float32 (max(T+F-L+1, 0), C, 32)). C = 0 launches nothing;
    templates too long for one block's shared memory fail the launch."""
    for name, t, dims in (("mags", mags, 2), ("soft_tail", soft_tail, 2),
                          ("templates", templates, 2),
                          ("mark_bins", mark_bins, 1)):
        if not isinstance(t, torch.Tensor) or t.dim() != dims:
            raise ValueError(f"{name}: expected {dims} dimensions, got "
                             f"{tuple(getattr(t, 'shape', ()))}")
    f, nfft = mags.shape
    nch = mark_bins.shape[0]
    t_rows = soft_tail.shape[0]
    length = templates.shape[1]
    build.check_tensors(
        (mags, "mags", (torch.float32,), (f, nfft)),
        (mark_bins, "mark_bins", (torch.int32,), (nch,)),
        (space_bins, "space_bins", (torch.int32,), (nch,)),
        (soft_tail, "soft_tail", (torch.float32,), (t_rows, nch)),
        (templates, "templates", (torch.float32,), (N_SYMBOLS, length)))
    dev = mags.device
    if any(t.device != dev for t in (mark_bins, space_bins, soft_tail,
                                     templates)):
        raise ValueError("rtty_scores: inputs on different devices")
    rows = t_rows + f
    soft = torch.empty((rows, nch), dtype=torch.float32, device=dev)
    scores = torch.empty((max(rows - length + 1, 0), nch, N_SYMBOLS),
                         dtype=torch.float32, device=dev)
    if nch == 0 or rows == 0:
        return soft, scores
    lib = build.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.pysdr_rtty_scores(
            mags.data_ptr(), mark_bins.data_ptr(), space_bins.data_ptr(),
            soft_tail.data_ptr(), templates.data_ptr(), soft.data_ptr(),
            scores.data_ptr(), f, nfft, nch, t_rows, length, stream)
    build.check_launch(rc, "rtty_scores")
    build.count_launch(rtty_scores)
    return soft, scores


rtty_scores.launches = 0
