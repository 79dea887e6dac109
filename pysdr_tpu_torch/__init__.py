"""pysdr_tpu_torch — the multi-receiver SDR main path in PyTorch for an
NVIDIA H100.

A second package beside `pysdr_tpu` (the JAX reference, held against it
by the tests/test_torch_*.py parity suite). It runs the main path end to
end: a `.dat` replay or the synth source feeds `runtime.executive`, which
drives `models.receiver.ReceiverBank` (1-N receivers in one passband,
mode/squelch/AGC held as data) into wav sinks.

Layout (mirrors pysdr_tpu):
  ops/       torch DSP ops: wire formats, exact NCO, mix+resample,
             overlap-save FIR, scans, AGC, demod
  kernels/   hand-written CUDA kernels (csrc/*.cu), their nvcc build and
             ctypes wrappers
  models/    ReceiverBank (nn.Module)
  runtime/   the streaming executive
  convert.py carry JAX-bank state, params and constants across
  app.py     `python -m pysdr_tpu_torch`

The jax-free host modules of pysdr_tpu (config, tables, rates, ops.fir,
io.*, runtime.{audio,ringbuffer,profiler,watchdog}, app's parser) are
imported, not copied. Nothing here imports jax.
"""

__version__ = "0.1.0"
