"""The comparison that decides `correct`, on the CPU at small sizes: the
program agrees with the plain reference, and a run with its timed path
broken underneath, or the reference in the precision below the
configuration's in the program's place (the control), comes out not
correct.

    python -m pytest -q sdrbench/tests
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from sdrbench import control, harness, reference
from sdrbench.tests import tiny

SEED = 2**31 + 12345


def _run(c, fault=None, seconds=0.5):
    res = harness.run_cell(c, SEED, seconds, False, "cpu", fault=fault,
                           log=lambda *a: None)
    return harness.correct(res), res


@pytest.mark.parametrize("make", [
    lambda: tiny.bank_cell(),
    lambda: tiny.bank_cell(capture="cs8", wire="i8", audio_wire="i16"),
    lambda: tiny.bank_cell(loop="open"),
    lambda: tiny.bank_cell(capture="cu8", wire="i8", audio_wire="i16"),
    lambda: tiny.chan_cell(),
    lambda: tiny.chan_cell(loop="open")],
    ids=["f32", "cs8_i16", "live", "cu8_i16", "chan_i8", "chan_live"])
def test_the_program_agrees_with_the_reference(make):
    ok, res = _run(make())
    assert ok, res["checks"]
    assert res["attempted"] > 0


def _state_unchanged(app):
    """A step that returns its state unchanged."""
    graphs = app.ex.bank._graphs
    step = graphs.impl

    def frozen(state, x_wire, params):
        _, out = step(state, x_wire, params)
        return state, out
    graphs.impl = frozen


def _answer_altered(app):
    """The loudest receiver's audio altered by 1 % where it is
    produced."""
    bank = app.ex.bank
    dec = bank.audio_from_wire

    def altered(w):
        a = dec(w).copy()
        a[np.argmax(np.abs(a).sum(1))] *= np.float32(1.01)
        return a
    bank.audio_from_wire = altered


def _half_precision(app):
    """The audio handed on in float16."""
    bank = app.ex.bank
    dec = bank.audio_from_wire

    def half(w):
        a = dec(w)
        return (a.real.astype(np.float16).astype(np.float32)
                + 1j * a.imag.astype(np.float16).astype(np.float32)
                ).astype(np.complex64)
    bank.audio_from_wire = half


_CELLS = {"bank": lambda: tiny.bank_cell(),
          "bank_i16": lambda: tiny.bank_cell(capture="cs8", wire="i8",
                                             audio_wire="i16"),
          "chan": lambda: tiny.chan_cell()}
_FAULTS = {"state_unchanged": _state_unchanged,
           "answer_altered": _answer_altered, "float16": _half_precision}
_BROKEN = [(c, f) for c in _CELLS for f in _FAULTS]


@pytest.mark.parametrize("cell,fault", _BROKEN,
                         ids=[f"{c}-{f}" for c, f in _BROKEN])
def test_a_broken_timed_path_is_not_correct(cell, fault):
    make, fault = _CELLS[cell], _FAULTS[fault]
    c = make()
    c.traffic["compare_blocks"] = 24          # every block of the window
    ok, res = _run(c, fault=fault)
    assert not ok, res["checks"]


@pytest.mark.parametrize("make", [lambda: tiny.bank_cell(),
                                  lambda: tiny.bank_cell(
                                      capture="cs8", wire="i8",
                                      audio_wire="i16"),
                                  lambda: tiny.chan_cell()],
                         ids=["f32", "cs8_i16", "chan_i8"])
def test_the_tf32_control_is_not_correct(make):
    c = make()
    c.traffic["compare_blocks"] = 12          # as many as a live run
    got = control.readings(c, SEED, 60, "cpu")
    assert not harness.passed(got), got


def test_one_pole_scan_is_the_recurrence():
    g = torch.Generator().manual_seed(3)
    b = torch.randn((3, 1000), generator=g)
    y0 = torch.randn(3, generator=g)
    for a in (0.5, 0.9985, 0.999):
        want = torch.empty_like(b, dtype=torch.float64)
        y = y0.double()
        for i in range(b.shape[1]):
            y = a * y + b[:, i].double()
            want[:, i] = y
        got = reference.one_pole_scan(a, b, y0, reference.Arith())
        assert torch.allclose(got.double(), want, rtol=1e-5, atol=1e-4)


def test_latch_follows_the_last_command():
    s = torch.tensor([[0, 1, 0, 0, 0, 1, 0], [0, 0, 0, 0, 0, 0, 0]]) > 0
    r = torch.tensor([[0, 0, 1, 1, 0, 1, 0], [0, 0, 0, 1, 0, 0, 0]]) > 0
    gate, last = reference.latch(s, r)
    assert gate.tolist() == [[1, 1, 0, 0, 0, 1, 1], [1, 1, 1, 0, 0, 0, 0]]
    assert last[1, 2].item() == -1 and last[1, 3].item() == 3


def test_round_tf32_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2**-10, 1.0 + 2**-11 + 2**-13, -3.0000002])
    y = reference.round_tf32(x)
    assert y[0] == x[0]
    assert y[1] == 1.0 + 2**-10
    assert y[2] == -3.0
