"""pysdr_tpu_torch — the multi-receiver SDR main path in PyTorch for an
NVIDIA H100.

A second package beside `pysdr_tpu` (the JAX reference, held against it
by the tests/test_torch_*.py parity suite). It runs the main path end to
end: a `.dat` replay or the synth source feeds `runtime.executive`, which
drives `models.receiver.ReceiverBank` (1-N receivers in one passband,
mode/squelch/AGC held as data) into wav sinks.

Layout (mirrors pysdr_tpu):
  ops/       torch DSP ops: wire formats, exact NCO, mix+resample,
             overlap-save FIR, scans, AGC, demod, channelizer, spectrum;
             ops/fir.py designs the filters
  kernels/   hand-written CUDA kernels (csrc/*.cu), their nvcc build and
             ctypes wrappers
  models/    ReceiverBank, ChannelizerBank, display, RTTY decoder
  runtime/   the streaming executive, sinks, watchdog, control servers,
             web viewer, C++ replay streamer (native/sdrio.cpp)
  io/        .dat container, synth source, rtl_tcp client
  config.py, rates.py, tables.py   receiver configs, rate plans, menus
  convert.py carry JAX-bank state, params and constants across
  app.py     `python -m pysdr_tpu_torch`

The host modules (config, tables, rates, ops.fir, io.synth, io.rtltcp,
every runtime module but the executive, the app's parser and source
picker) are the port's own copies of pysdr_tpu's, each naming its
original. Nothing here imports jax or pysdr_tpu.
"""

__version__ = "0.1.0"
