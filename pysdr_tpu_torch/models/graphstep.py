"""A bank's device step over static buffers, captured once as a CUDA graph
and replayed: the port's counterpart of the JAX banks'
`self._step = jax.jit(self._step_impl)` (pysdr_tpu/models/receiver.py,
channelizer_bank.py), which compiles the whole step once and dispatches
one executable a block.

The step body reads a static input block, the bank's state, params and
constants, computes the bank's functional `_step_impl`, writes the new
state back into the same state tensors (`copy_`) and its outputs into
static output tensors. So every tensor the body touches keeps its
address from block to block, and a graph captured once stays right:

  * on the CPU, and on a card with `graph=False`, the body runs as it is
    (eagerly, on the same static buffers, so an aliasing fault of the
    body shows on the CPU too);
  * on a card with `graph=True`, the first block of each (wire dtype,
    in_block) runs `_step_impl` once on a side stream (the warm-up: cuFFT
    plans, cuBLAS workspaces, the scans' look-back buffers; the bank's
    state is not written), captures the body on that stream, and then
    replays it; every later block of that key copies its input into the
    static block and replays. A failed capture or replay raises; nothing
    falls back to the eager body.

What a replay needs of the caller, and what `check` enforces: the bank's
state, params and constants are the captured tensors (control verbs copy
into them; rebinding one raises at the next replay). The outputs are the
graph's own and are overwritten by the next block. The scans' look-back
buffers of a graph are its own (kernels.scan.lookback_scope), and the
kernels it captured are added to the launch counts at every replay
(kernels.build.capture_tally, kernels.add_launches).
"""

from __future__ import annotations

import dataclasses

import torch

from pysdr_tpu_torch import kernels
from pysdr_tpu_torch.device import copy_tensors, leaves
from pysdr_tpu_torch.kernels import build, scan


def _made(res) -> tuple:
    """A step's outputs as a tuple of the tensors it made."""
    if isinstance(res, torch.Tensor):
        return (res,)
    return tuple(r for r in res if r is not None)


@dataclasses.dataclass
class _Step:
    """One (wire dtype, in_block): its static input and outputs, and on a
    card its graph, the launches a replay makes and the tensors it
    captured."""
    x: torch.Tensor
    outs: tuple
    graph: torch.cuda.CUDAGraph | None = None
    launches: dict | None = None
    bound: tuple = ()
    lookbacks: scan.Lookbacks | None = None


class StepGraphs:
    """The launcher of one bank's step. `impl(state, x, params)` is the
    bank's functional step, returning (new_state, outputs): a tensor, or
    a tuple with None for an output not made; `constants()` the tensors
    the step reads besides state and params."""

    def __init__(self, bank, impl, constants, graph: bool = True):
        self.bank = bank
        self.impl = impl
        self.constants = constants
        self.graph = bool(graph) and bank.device.type == "cuda"
        self._steps: dict = {}
        self._stream = None

    @property
    def count(self) -> int:
        """Graphs captured so far."""
        return sum(s.graph is not None for s in self._steps.values())

    def _tensors(self) -> tuple:
        b = self.bank
        return (*leaves(b.state), *leaves(b.params), *self.constants())

    def body(self, x: torch.Tensor, outs: tuple) -> None:
        """One block over the static buffers: the functional step, its new
        state copied into the state tensors, its outputs into `outs`."""
        b = self.bank
        new_state, res = self.impl(b.state, x, b.params)
        copy_tensors(b.state, new_state)
        for o, r in zip(outs, _made(res)):
            o.copy_(r)

    def prepare(self, dtype: torch.dtype, in_block: int) -> _Step:
        """The static buffers of (dtype, in_block) blocks, and on a card
        with graph=True their captured graph; made at the first call."""
        key = (dtype, int(in_block))
        st = self._steps.get(key)
        if st is None:
            st = self._steps[key] = self._make(dtype, int(in_block))
        return st

    def _warm_up(self, x) -> tuple:
        # the functional step once, the bank's state left as it was: the
        # outputs' shapes and dtypes
        return _made(self.impl(self.bank.state, x, self.bank.params)[1])

    def _make(self, dtype, n) -> _Step:
        dev = self.bank.device
        x = torch.zeros((n, 2), dtype=dtype, device=dev)
        if not self.graph:
            return _Step(x=x, outs=tuple(
                torch.empty_like(r) for r in self._warm_up(x)))
        if self._stream is None:
            self._stream = torch.cuda.Stream(dev)
        side, cur = self._stream, torch.cuda.current_stream(dev)
        lbs = scan.Lookbacks()
        side.wait_stream(cur)
        with torch.cuda.stream(side), scan.lookback_scope(lbs):
            res = self._warm_up(x)
        cur.wait_stream(side)
        outs = tuple(torch.empty_like(r) for r in res)
        del res
        side.wait_stream(cur)
        g = torch.cuda.CUDAGraph()
        # "global": any other thread's unsafe CUDA call during the capture
        # fails it, and so the step, loudly (the executive prepares
        # before it starts its prefetch thread)
        with build.capture_tally() as tally, scan.lookback_scope(lbs), \
                torch.cuda.graph(g, stream=side,
                                 capture_error_mode="global"):
            self.body(x, outs)
        cur.wait_stream(side)
        return _Step(x=x, outs=outs, graph=g, launches=dict(tally),
                     bound=self._tensors(), lookbacks=lbs)

    def check(self, st: _Step) -> None:
        """Raise unless the bank still holds the tensors `st` captured."""
        now = self._tensors()
        if len(now) != len(st.bound) or any(
                a is not b for a, b in zip(now, st.bound)):
            raise RuntimeError(
                "the bank's state, params or constants were rebound after "
                "its step was captured: copy into them instead")

    def run(self, x_wire: torch.Tensor) -> tuple:
        """One block: x_wire (in_block, 2) into the static input, then
        the body or the replay. Returns the static outputs, valid until
        the next block."""
        if x_wire.dim() != 2 or x_wire.shape[1] != 2:
            raise ValueError(f"x_wire: expected (n, 2) pairs, got "
                             f"{tuple(x_wire.shape)}")
        st = self.prepare(x_wire.dtype, x_wire.shape[0])
        st.x.copy_(x_wire)
        if st.graph is None:
            self.body(st.x, st.outs)
        else:
            self.check(st)
            st.graph.replay()
            kernels.add_launches(st.launches)
        return st.outs
