"""The executive's one-pass C++ quantizer of an integer RF wire
(runtime/native.wire_quantizer, native/sdrio.cpp) against
ops/cplx.quantize_host, the wire's definition: the same codes bit for
bit on random pairs, every half-integer tie, signed zeros, values past
full scale and every CS8 and CU8 byte; and an executive on the CPU that
uploads those codes, counts the blocks in stage_ms["wire_native"], and
falls back to quantize_host where the library is unavailable."""

import numpy as np
import pytest
import torch

from pysdr_tpu_torch.config import PipelineConfig, ReceiverConfig
from pysdr_tpu_torch.io import datfile
from pysdr_tpu_torch.models.receiver import ReceiverBank
from pysdr_tpu_torch.ops import cplx
from pysdr_tpu_torch.runtime import native
from pysdr_tpu_torch.runtime.executive import Executive
from pysdr_tpu_torch.tables import Mode

pytestmark = pytest.mark.skipif(not native.available(),
                                reason="native lib not built")

torch.set_num_threads(1)

F32 = np.float32


def _case(name: str, s: float) -> np.ndarray:
    """Float32 values of one kind, as (n, 2) pairs."""
    if name == "random":
        rng = np.random.default_rng(20231)
        x = np.concatenate([rng.standard_normal(8192) * 0.4,
                            rng.uniform(-1.3, 1.3, 8192)])
    elif name == "ties":
        # every k + 0.5 over [-s - 2, s + 2], divided by s
        k = np.arange(-int(s) - 2, int(s) + 2, dtype=F32)
        x = (k + F32(0.5)) / F32(s)
    elif name == "zeros":
        x = np.array([0.0, -0.0, 1e-45, -1e-45, 1e-30, -1e-30], F32)
    elif name == "beyond":
        past = (F32(s) + F32(0.5)) / F32(s)
        x = np.array([1.0, -1.0, np.nextafter(F32(1), F32(2)),
                      -np.nextafter(F32(1), F32(2)), past, -past, 2.0,
                      -2.0, 1e6, -1e6, 3e38, -3e38, np.inf, -np.inf], F32)
    elif name == "cs8":
        # the CS8 streamer's floats: b / 128 for all 256 bytes
        x = np.arange(-128, 128).astype(F32) * F32(1.0 / 128.0)
    elif name == "cu8":
        # the CU8 converter's floats: (b - 127.5) / 127.5
        x = (np.arange(256).astype(F32) - F32(127.5)) * F32(1.0 / 127.5)
    x = np.asarray(x, F32)
    return np.ascontiguousarray(np.resize(x, x.size + x.size % 2)
                                .reshape(-1, 2))


@pytest.mark.parametrize("case", ["random", "ties", "zeros", "beyond",
                                  "cs8", "cu8"])
@pytest.mark.parametrize("wire", ["i8", "i16"])
def test_native_pass_is_quantize_host_bit_for_bit(wire, case):
    s = cplx.WIRES[wire].scale
    xp = _case(case, s)
    with np.errstate(over="ignore"):        # 3e38 * s is inf
        want = cplx.quantize_host(xp, wire)
    got = np.empty(xp.shape, cplx.WIRES[wire].np_dtype)
    native.wire_quantizer(got.dtype)(xp, got.ctypes.data, s)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_no_native_pass_for_the_f32_wire():
    assert native.wire_quantizer(np.float32) is None


CFG = PipelineConfig(fs_in=512e3, fs_out=48e3, out_block=1024,
                     foffset_hz=60e3, receivers=(
                         ReceiverConfig(fc_hz=10e6, mode=Mode.AM,
                                        agc_enabled=False),))
N_BLOCKS = 4


@pytest.fixture(scope="module")
def cs8_replay(tmp_path_factory):
    """A CS8 .dat of N_BLOCKS blocks: every byte value, then seeded
    random bytes (so both full-scale ends and -128 are on the wire)."""
    in_block = ReceiverBank(CFG, device="cpu").design.in_block
    rng = np.random.default_rng(7)
    raw = np.concatenate([np.arange(-128, 128, dtype=np.int8),
                          rng.integers(-128, 128, 2 * N_BLOCKS * in_block
                                       - 256, dtype=np.int8)])
    path = str(tmp_path_factory.mktemp("wire") / "cs8.dat")
    w = datfile.DatWriter(path, fs=CFG.fs_in, fc=10e6 - 60e3, dtype="int8")
    w.save_data(raw)
    w.close()
    return path, in_block


@pytest.mark.parametrize("wire,lib", [("i8", True), ("i16", True),
                                      ("i8", False), ("f32", True)])
def test_executive_uploads_quantize_hosts_codes(cs8_replay, monkeypatch,
                                                wire, lib):
    """An executive over the replay uploads, block by block, exactly
    quantize_host's codes of the block read: with the library, the native
    pass writes every block's into its staging tensor
    (stage_ms["wire_native"] counts each block drained); with the library
    unavailable, or on the f32 wire, quantize_host's codes are copied
    into it and the count stays 0."""
    path, in_block = cs8_replay
    if not lib:
        monkeypatch.setattr(native, "_load", lambda: None)
    bank = ReceiverBank(CFG, device="cpu")
    seen = []
    step = bank.step_device

    def record(xb):
        seen.append(xb.clone())
        return step(xb)
    bank.step_device = record
    ex = Executive(bank, datfile.DatReader(path), loop_source=False,
                   wire=wire)
    ex.run()
    ex.stop()
    ref = datfile.DatReader(path)
    want = [cplx.quantize_host(ref.read_data(in_block).view(F32)
                               .reshape(-1, 2), wire)
            for _ in range(N_BLOCKS)]
    assert ex.n_blocks == len(seen) == N_BLOCKS
    for got, w in zip(seen, want):
        assert got.dtype == cplx.WIRES[wire].torch_dtype
        np.testing.assert_array_equal(got.numpy(), w)
    native_pass = lib and wire != "f32"
    assert ex.stage_ms["wire_native"] == (N_BLOCKS if native_pass else 0)

