""".dat recording and replay container (counterpart of
pysdr_tpu/io/datfile.py, the same format):

  magic b'PSDRTPU1' | u32 header_bytes | JSON header
  { fs, fc, nchan, dtype, tag, timestamp } | raw samples (little-endian)

Samples are interleaved complex64 by default (nchan channels interleaved
sample-major), or "int16" / "int8" / "uint8" re,im pairs: full scale
|x| = 1.0, int16/32768, int8/128, (uint8-127.5)/127.5, clipped. The
port's recording taps write through DatWriter; DatReader replays a file
and reads a tap back; write_dat and read_dat move a whole array.
"""

from __future__ import annotations

import dataclasses
import json
import os
import struct
import time

import numpy as np

MAGIC = b"PSDRTPU1"

# IQ-pair integer formats: (numpy dtype, full-scale divisor, offset)
_INT_IQ = {"int16": (np.int16, 32768.0, 0.0),
           "int8": (np.int8, 128.0, 0.0),
           "uint8": (np.uint8, 127.5, 127.5)}


def _quantize_iq(x: np.ndarray, dtype: str) -> np.ndarray:
    """complex -> interleaved integer re,im pairs, clipped at full scale."""
    dt, scale, off = _INT_IQ[dtype]
    pairs = np.stack([x.real, x.imag], -1).reshape(-1)
    lo, hi = (0, 255) if dtype == "uint8" else (-scale, scale - 1)
    return np.clip(np.rint(pairs * scale + off), lo, hi).astype(dt)


def _dequantize_iq(raw: np.ndarray, dtype: str) -> np.ndarray:
    """Interleaved integer pairs -> complex64."""
    dt, scale, off = _INT_IQ[dtype]
    f = ((raw.astype(np.float32) - np.float32(off))
         * np.float32(1.0 / scale)).reshape(-1, 2)
    return (f[:, 0] + 1j * f[:, 1]).astype(np.complex64)


def timestamped_name(tag: str, t: float | None = None) -> str:
    """tag_YYYYMMDD_HHMMSS.dat, in local time."""
    lt = time.localtime(t if t is not None else time.time())
    return f"{tag}_{time.strftime('%Y%m%d_%H%M%S', lt)}.dat"


@dataclasses.dataclass
class DatHeader:
    fs: float
    fc: float = 0.0
    nchan: int = 1
    dtype: str = "complex64"
    tag: str = "raw_iq"
    timestamp: float = 0.0


class DatWriter:
    """Streaming writer: the header at open, then `save_data` per block."""

    def __init__(self, path: str, fs: float, fc: float = 0.0, nchan: int = 1,
                 dtype: str = "complex64", tag: str = "raw_iq"):
        self.header = DatHeader(fs=fs, fc=fc, nchan=nchan, dtype=dtype,
                                tag=tag, timestamp=time.time())
        self.path = path
        self._f = open(path, "wb")
        hdr = json.dumps(dataclasses.asdict(self.header)).encode()
        self._f.write(MAGIC + struct.pack("<I", len(hdr)) + hdr)
        self.nsamples = 0

    def save_data(self, x) -> int:
        """Append samples: (n,) or, with nchan > 1, (n, nchan) channel-last.
        Into an integer container, complex samples, float (n, 2) pairs or
        real floats quantize at full scale; samples already of its dtype
        are written as they are. Returns the values taken."""
        x = np.asarray(x)
        n_in = x.size
        if self.header.nchan > 1 and x.ndim == 2:
            x = x.reshape(-1)
        dtype = self.header.dtype
        if dtype in _INT_IQ:
            if x.dtype != np.dtype(dtype):
                if np.issubdtype(x.dtype, np.floating):
                    if x.ndim == 2 and x.shape[-1] == 2:
                        x = x[..., 0] + 1j * x[..., 1]
                    x = x.astype(np.complex64)
                elif not np.iscomplexobj(x):
                    raise TypeError(f"cannot write {x.dtype} samples into "
                                    f"an {dtype} IQ container")
                x = _quantize_iq(x, dtype)
        else:
            x = x.astype(dtype, copy=False)
        self._f.write(x.tobytes())
        self.nsamples += n_in // self.header.nchan
        return n_in

    def close(self):
        self._f.close()


class DatReader:
    """Replay reader, optionally from `start_sec` into the file."""

    def __init__(self, path: str, start_sec: float = 0.0):
        self._f = open(path, "rb")
        if self._f.read(8) != MAGIC:
            self._f.close()
            raise ValueError(f"{path}: not a pysdr-tpu .dat file")
        (hlen,) = struct.unpack("<I", self._f.read(4))
        self.header = DatHeader(**json.loads(self._f.read(hlen)))
        self._data_start = self._f.tell()
        self._iq_pairs = self.header.dtype in _INT_IQ
        self._isize = (np.dtype(self.header.dtype).itemsize
                       * (2 if self._iq_pairs else 1) * self.header.nchan)
        end = os.fstat(self._f.fileno()).st_size
        self.nsamples = (end - self._data_start) // self._isize
        if start_sec > 0:
            self.seek_seconds(start_sec)

    @property
    def srate(self) -> float:
        return self.header.fs

    @property
    def fc(self) -> float:
        return self.header.fc

    def seek_seconds(self, t: float):
        self._f.seek(self._data_start + int(t * self.header.fs) * self._isize)

    def read_data(self, n: int | None = None, loop: bool = False):
        """Read n frames (None: the rest of the file); loop=True wraps
        around at the end. Returns (n,) or (n, nchan)."""
        if n is None:
            raw = self._f.read()
        else:
            want = n * self._isize
            raw = self._f.read(want)
            while loop and len(raw) < want:
                self._f.seek(self._data_start)
                got = self._f.read(want - len(raw))
                if not got:
                    break                 # no samples: do not spin
                raw += got
        x = np.frombuffer(raw, dtype=self.header.dtype)
        if self._iq_pairs:
            x = _dequantize_iq(x, self.header.dtype)
        if self.header.nchan > 1:
            x = x.reshape(-1, self.header.nchan)
        return x

    def close(self):
        self._f.close()


def write_dat(path: str, x, fs: float, fc: float = 0.0, tag: str = "raw_iq"):
    """Write x, (n,) or (n, nchan) channel-last, to a new .dat file in
    x's own dtype."""
    x = np.asarray(x)
    nchan = 1 if x.ndim == 1 else x.shape[1]
    w = DatWriter(path, fs=fs, fc=fc, nchan=nchan, dtype=str(x.dtype),
                  tag=tag)
    w.save_data(x)
    w.close()


def read_dat(path: str):
    """A whole .dat file: (samples as DatReader.read_data gives them,
    its header)."""
    r = DatReader(path)
    x = r.read_data()
    r.close()
    return x, r.header
