"""The scipy golden chain of tests/test_golden_parity.py (an independent
NumPy/SciPy receive chain: resample_poly, firwin AF filters, a serial
AGC, a serial squelch latch) run against the port's ReceiverBank on the
CPU, at the reference tests' own bounds: the JAX bank's name in that
module is pointed at the port's bank for the test's duration."""

import ctypes
import dataclasses
import gc

import pytest
import threadpoolctl
import torch

import test_golden_parity as golden
from pysdr_tpu_torch import config, tables
from pysdr_tpu_torch.models.receiver import ReceiverBank

torch.set_num_threads(1)


@pytest.fixture(autouse=True, scope="module")
def release_heap():
    """After this module, give its freed heap back to the OS, so that the
    next test module in this worker process (tests/test_parity.py's RSS
    growth check among them) starts without megabytes of free but
    resident heap that a new allocation would reuse unseen."""
    yield
    gc.collect()
    getattr(ctypes.CDLL(None), "malloc_trim", lambda pad: 0)(0)


@pytest.fixture(autouse=True)
def one_blas_thread():
    """The golden chain's numpy/scipy BLAS calls on one thread: beside
    the other test workers, OpenBLAS's own thread pool ran these tests
    7x slower than on one thread."""
    with threadpoolctl.threadpool_limits(1):
        yield


def port_bank(jcfg):
    """The port's bank, on the CPU, for a JAX-package PipelineConfig."""
    def copy(obj, cls, **kw):
        return cls(**{**{f.name: getattr(obj, f.name)
                         for f in dataclasses.fields(obj)}, **kw})
    rxs = tuple(copy(r, config.ReceiverConfig, mode=tables.Mode(int(r.mode)))
                for r in jcfg.receivers)
    return ReceiverBank(copy(jcfg, config.PipelineConfig, receivers=rxs),
                        device="cpu")


@pytest.fixture
def on_the_port(monkeypatch):
    monkeypatch.setattr(golden, "ReceiverBank", port_bank)


@pytest.mark.parametrize("mode,agc,bound_db", [
    (golden.Mode.AM, False, 30.0), (golden.Mode.AM_SYNC, False, 35.0),
    (golden.Mode.NFM, False, 25.0), (golden.Mode.USB, False, 25.0),
    (golden.Mode.USB, True, 30.0), (golden.Mode.CW, False, 25.0),
    (golden.Mode.WFM, False, 25.0)], ids=lambda v: getattr(v, "name", v))
def test_golden_chain_parity(mode, agc, bound_db, rng, on_the_port):
    golden.test_golden_chain_parity(mode, agc, bound_db, rng)


def test_golden_wfm2_stereo(rng, on_the_port):
    golden.test_golden_wfm2_stereo(rng)


def test_golden_squelch_drop(rng, on_the_port):
    golden.test_golden_squelch_drop(rng)
