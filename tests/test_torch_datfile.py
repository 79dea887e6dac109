"""The port's .dat container against pysdr_tpu.io.datfile: a file either
one writes, the other reads back with the same header and samples, for
every sample format, one or several channels, a start offset and a
looped read."""

import numpy as np
import pytest

from pysdr_tpu.io import datfile as jdat
from pysdr_tpu_torch.io import datfile

DTYPES = ("complex64", "int16", "int8", "uint8")
SIDES = {"port writes, JAX reads": (datfile, jdat),
         "JAX writes, port reads": (jdat, datfile)}


def samples(seed, n, nchan):
    """Complex samples inside full scale, with the edges of the integer
    formats' range."""
    rng = np.random.default_rng(seed)
    x = (rng.uniform(-1, 1, (n, nchan)) + 1j * rng.uniform(-1, 1, (n, nchan))
         ).astype(np.complex64)
    x.flat[:3] = (1.0 + 1.0j, -1.0 - 1.0j, 0.5 - 0.25j)
    return x if nchan > 1 else x[:, 0]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("side", list(SIDES))
@pytest.mark.parametrize("nchan", (1, 3))
def test_written_by_one_read_by_the_other(tmp_path, side, dtype, nchan):
    wmod, rmod = SIDES[side]
    path = str(tmp_path / "x.dat")
    x = samples(7, 1000, nchan)
    w = wmod.DatWriter(path, fs=48e3, fc=100.5e6, nchan=nchan, dtype=dtype,
                       tag="baseband")
    w.save_data(x[:400])
    w.save_data(x[400:])
    w.close()
    assert w.nsamples == 1000
    r = rmod.DatReader(path)
    got = r.read_data()
    r.close()
    assert (r.header.fs, r.header.fc, r.header.nchan, r.header.dtype,
            r.header.tag) == (48e3, 100.5e6, nchan, dtype, "baseband")
    assert (r.srate, r.fc, r.nsamples) == (48e3, 100.5e6, 1000)
    # the same file read by the writer's own module: the same samples
    ref = wmod.DatReader(path).read_data()
    np.testing.assert_array_equal(got, ref)
    assert got.shape == x.shape and got.dtype == np.complex64
    step = {"complex64": 0.0, "int16": 1 / 32768, "int8": 1 / 128,
            "uint8": 1 / 127.5}[dtype]
    # half a step of rounding on each of re, im; a full one where +1.0
    # clips
    for part in (np.real, np.imag):
        assert np.abs(part(got) - part(x)).max() <= step


@pytest.mark.parametrize("dtype", DTYPES[1:])
@pytest.mark.parametrize("form", ("complex", "pairs", "real", "raw"))
def test_quantized_bytes_equal_the_reference(tmp_path, dtype, form):
    """Into an integer container, complex samples, float (n, 2) pairs,
    real floats and samples already of its dtype give the reference
    writer's bytes (beyond the timestamp in the header)."""
    x = samples(8, 300, 1)
    data = {"complex": x,
            "pairs": np.stack([x.real, x.imag], -1).astype(np.float32),
            "real": x.real.astype(np.float32),
            "raw": np.arange(-64, 64).astype(dtype)}[form]
    out = []
    for mod, name in ((datfile, "port.dat"), (jdat, "jax.dat")):
        w = mod.DatWriter(str(tmp_path / name), fs=8e3, dtype=dtype)
        w.save_data(data)
        w.close()
        out.append(mod.DatReader(str(tmp_path / name)).read_data())
    np.testing.assert_array_equal(*out)


def test_samples_of_another_int_type_raise(tmp_path):
    for mod in (datfile, jdat):
        w = mod.DatWriter(str(tmp_path / "x.dat"), fs=8e3, dtype="int8")
        with pytest.raises(TypeError, match="int32"):
            w.save_data(np.arange(8, dtype=np.int32))
        w.close()


def test_start_offset_and_looped_read_match_the_reference(tmp_path):
    path = str(tmp_path / "x.dat")
    x = samples(9, 2000, 1)
    jdat.write_dat(path, x, fs=1000.0, fc=7e6)
    for start in (0.0, 0.25, 1.5):
        r, jr = datfile.DatReader(path, start), jdat.DatReader(path, start)
        np.testing.assert_array_equal(r.read_data(300),
                                      jr.read_data(300))
        # past the end: wraps to the first sample
        np.testing.assert_array_equal(r.read_data(1900, loop=True),
                                      jr.read_data(1900, loop=True))
        r.close()
        jr.close()
    np.testing.assert_array_equal(datfile.DatReader(path).read_data(),
                                  x)


def test_not_a_dat_file_raises(tmp_path):
    path = tmp_path / "x.dat"
    path.write_bytes(b"RIFF....WAVE")
    with pytest.raises(ValueError, match="not a pysdr-tpu .dat file"):
        datfile.DatReader(str(path))


def test_timestamped_name_matches_the_reference():
    t = 1.7e9
    assert datfile.timestamped_name("raw_iq", t) == \
        jdat.timestamped_name("raw_iq", t)


@pytest.mark.parametrize("dtype", ("complex64", "int16"))
@pytest.mark.parametrize("nchan", (1, 3))
def test_write_dat_round_trip_through_both_readers(tmp_path, dtype, nchan):
    """write_dat in x's own dtype, read back whole by the port's read_dat
    and DatReader and by the JAX reader: the same header and samples."""
    x = samples(9, 500, nchan)
    if dtype == "int16":
        x = np.round(np.stack([x.real, x.imag], -1) * 32767).astype(
            np.int16).reshape(x.shape[0], -1)
    paths = {}
    for mod, name in ((datfile, "port.dat"), (jdat, "jax.dat")):
        paths[name] = str(tmp_path / name)
        mod.write_dat(paths[name], x, fs=96e3, fc=7.1e6, tag="baseband")
    for name, path in paths.items():
        got, hdr = datfile.read_dat(path)
        ref, jhdr = jdat.read_dat(path)
        np.testing.assert_array_equal(got, ref)
        assert (hdr.fs, hdr.fc, hdr.nchan, hdr.dtype, hdr.tag) == \
            (jhdr.fs, jhdr.fc, jhdr.nchan, jhdr.dtype, jhdr.tag) == \
            (96e3, 7.1e6, x.shape[1] if x.ndim == 2 else 1, dtype,
             "baseband"), name
        r = datfile.DatReader(path)
        np.testing.assert_array_equal(r.read_data(), got)
        r.close()
    body = [open(p, "rb").read() for p in paths.values()]
    assert body[0][-x.nbytes:] == body[1][-x.nbytes:]
