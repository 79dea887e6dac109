"""Device selection and precision policy.

`resolve_device("cuda")` never degrades to the CPU: a run that asked for
the card and has none fails loudly, so a CPU number can never pass for a
GPU one.
"""

from __future__ import annotations

import dataclasses

import torch


def resolve_device(name: str | torch.device = "cuda") -> torch.device:
    """"cuda" (the main-path default) or "cpu" -> torch.device. Raises
    RuntimeError for "cuda" when no CUDA device is present."""
    dev = torch.device(name)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device 'cuda' requested but torch.cuda.is_available() is "
                "False (pass --device cpu to run on the CPU)")
        # full float32 matmuls and convolutions: the parity oracle is f32
        # JAX on the CPU, so TF32 stays off until a measured change
        # turns it on
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {name!r} (cuda or cpu)")
    return dev


def map_tensors(fn, obj):
    """Apply fn to every tensor of a (nested) dataclass of tensors."""
    if isinstance(obj, torch.Tensor):
        return fn(obj)
    if dataclasses.is_dataclass(obj):
        return type(obj)(**{f.name: map_tensors(fn, getattr(obj, f.name))
                            for f in dataclasses.fields(obj)})
    return obj


def leaves(obj) -> list:
    """The tensors of a (nested) dataclass of tensors, in field order."""
    if isinstance(obj, torch.Tensor):
        return [obj]
    if dataclasses.is_dataclass(obj):
        return [t for f in dataclasses.fields(obj)
                for t in leaves(getattr(obj, f.name))]
    return []


def copy_tensors(dst, src) -> None:
    """Copy every tensor of the dataclass `src` into the same field of
    `dst` (same structure), in place: dst's tensors keep their storage.
    A field that is None in dst is skipped."""
    if dst is None:
        return
    if isinstance(dst, torch.Tensor):
        if src is not dst:
            dst.copy_(src)
        return
    for f in dataclasses.fields(dst):
        copy_tensors(getattr(dst, f.name), getattr(src, f.name))
