"""A device body over static buffers, captured once as a CUDA graph and
replayed: the port's counterpart of the JAX package's jit sites, which
compile a device path once and dispatch one executable a call.

`capture` is the launcher every graph of the port goes through: a bank's
step here (`StepGraphs`, the JAX banks' `jax.jit(self._step_impl)`,
pysdr_tpu/models/receiver.py, channelizer_bank.py) and each shard of the
--mesh adapters (parallel/adapter.py, the JAX package's
`jax.jit(proc_impl)` over `shard_map`, pysdr_tpu/parallel/stream.py,
chanshard.py).

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
import gc

import torch

from pysdr_tpu_torch import kernels
from pysdr_tpu_torch.device import copy_tensors, leaves, map_tensors
from pysdr_tpu_torch.kernels import build, scan


def _made(res) -> tuple:
    """A step's outputs as a tuple of the tensors it made."""
    if isinstance(res, torch.Tensor):
        return (res,)
    return tuple(r for r in res if r is not None)


def empty_like(res):
    """Uninitialised tensors shaped as `res`: a tensor, a tuple of them
    or a (nested) dataclass of them, with None kept."""
    if isinstance(res, tuple):
        return tuple(empty_like(r) for r in res)
    return map_tensors(torch.empty_like, res)


def check_bound(now, bound: tuple, what: str) -> None:
    """Raise unless `now` are the very tensors `bound` (a graph reads the
    addresses it captured, so a rebound tensor would go unseen)."""
    now = tuple(now)
    if len(now) != len(bound) or any(a is not b
                                     for a, b in zip(now, bound)):
        raise RuntimeError(f"{what} were rebound after the graph was "
                           "captured: copy into them instead")


@dataclasses.dataclass
class Captured:
    """A body captured as a CUDA graph: the launches a replay makes (the
    capture's tally), the look-back buffers the graph names, and the
    tensors it captured (`bound`, as `tensors()` gave them then)."""
    graph: torch.cuda.CUDAGraph
    launches: dict
    lookbacks: scan.Lookbacks
    tensors: object
    bound: tuple
    what: str = "the captured tensors"

    def check(self) -> None:
        """Raise unless `tensors()` still gives the tensors captured."""
        check_bound(self.tensors(), self.bound, self.what)

    def replay(self) -> None:
        """check, one replay on the current stream, its launches counted."""
        self.check()
        self.graph.replay()
        kernels.add_launches(self.launches)


def capture(device, warm_up, body, tensors, stream=None,
            what: str = "the captured tensors"):
    """Capture a functional body over static buffers as a CUDA graph on
    `device` (the rules every graph of the port follows):

      * warm_up() runs the body's computation once on a side stream (its
        cuFFT plans, cuBLAS workspaces and the scans' look-back buffers)
        and returns its results without writing any captured tensor;
      * the static outputs are made like them (empty_like) on the
        current stream;
      * body(outs) is captured on the side stream, under the graph's own
        scan.lookback_scope and build.capture_tally, with
        capture_error_mode "global": any other thread's unsafe CUDA call
        during the capture fails it loudly; Python's garbage collector
        runs just before the capture and not during it;
      * `tensors()` gives the tensors the graph reads and writes besides
        its outputs; Captured.check raises when one was rebound.

    Returns (Captured, outs)."""
    device = torch.device(device)
    with torch.cuda.device(device):
        side = stream if stream is not None else torch.cuda.Stream(device)
        cur = torch.cuda.current_stream(device)
        lbs = scan.Lookbacks()
        side.wait_stream(cur)
        with torch.cuda.stream(side), scan.lookback_scope(lbs):
            res = warm_up()
        cur.wait_stream(side)
        outs = empty_like(res)
        del res
        side.wait_stream(cur)
        g = torch.cuda.CUDAGraph()
        # a garbage collection inside the capture that destroys another
        # graph (one held in a reference cycle) invalidates the capture:
        # collect before it, and not during it
        gc.collect()
        enabled = gc.isenabled()
        gc.disable()
        try:
            with build.capture_tally() as tally, \
                    scan.lookback_scope(lbs), \
                    torch.cuda.graph(g, stream=side,
                                     capture_error_mode="global"):
                body(outs)
        finally:
            if enabled:
                gc.enable()
        cur.wait_stream(side)
    return Captured(graph=g, launches=dict(tally), lookbacks=lbs,
                    tensors=tensors, bound=tuple(tensors()),
                    what=what), outs


@dataclasses.dataclass
class _Step:
    """One (wire dtype, in_block): its static input and outputs, and on a
    card its captured graph and the tensors it captured."""
    x: torch.Tensor
    outs: tuple
    captured: Captured | None = None
    bound: tuple = ()


_BANK_TENSORS = "the bank's state, params or constants"


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
        return sum(s.captured is not None for s in self._steps.values())

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
            return _Step(x=x, outs=empty_like(self._warm_up(x)))
        if self._stream is None:
            self._stream = torch.cuda.Stream(dev)
        # the executive prepares before it starts its prefetch thread
        cap, outs = capture(dev, lambda: self._warm_up(x),
                            lambda outs: self.body(x, outs), self._tensors,
                            self._stream, _BANK_TENSORS)
        return _Step(x=x, outs=outs, captured=cap, bound=cap.bound)

    def check(self, st: _Step) -> None:
        """Raise unless the bank still holds the tensors `st` captured."""
        check_bound(self._tensors(), st.bound, _BANK_TENSORS)

    def run(self, x_wire: torch.Tensor) -> tuple:
        """One block: x_wire (in_block, 2) into the static input, then
        the body or the replay. Returns the static outputs, valid until
        the next block."""
        if x_wire.dim() != 2 or x_wire.shape[1] != 2:
            raise ValueError(f"x_wire: expected (n, 2) pairs, got "
                             f"{tuple(x_wire.shape)}")
        st = self.prepare(x_wire.dtype, x_wire.shape[0])
        st.x.copy_(x_wire)
        if st.captured is None:
            self.body(st.x, st.outs)
        else:
            st.captured.replay()
        return st.outs
