"""Torch DSP operators; the scans dispatch to hand-written CUDA kernels
for CUDA tensors (pysdr_tpu_torch/kernels)."""
