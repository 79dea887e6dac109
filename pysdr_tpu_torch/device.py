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
