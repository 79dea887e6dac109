"""The traced stretch of a `--trace 1` run: torch.profiler over a few
blocks after the measured window, reduced to device time by kernel, the
seconds the device was busy, and its idle gaps labelled by the host
spans the harness records around each call into the program.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import time

import torch

SPAN_PREFIX = "sdrbench."
TOP = 10


@contextlib.contextmanager
def span(name: str):
    """A host span the traced stretch labels idle gaps with."""
    with torch.profiler.record_function(SPAN_PREFIX + name):
        yield


@dataclasses.dataclass
class Trace:
    window_s: float                     # host wall of the stretch
    busy_s: float                       # union of device activity
    kernels: dict                       # name -> (launches, device s)
    device_ops: list                    # [[name, s]] the longest in total
    idle_gaps: list                     # [[host spans, s]] summed by label

    def timing(self, kernel: str) -> tuple[int, float]:
        """(launches, device s) of the hand kernel `kernel`, whose device
        function is `<kernel>_kernel`."""
        n, s = 0, 0.0
        for name, (cnt, sec) in self.kernels.items():
            if f"{kernel}_kernel" in name:
                n, s = n + cnt, s + sec
        return n, s


def _union(iv: list) -> list:
    out = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def stretch(fn, device: torch.device) -> Trace:
    """Run fn() under torch.profiler and reduce what it recorded."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        wall = time.perf_counter() - t0
    dev_events, spans = [], []
    for e in prof.events():
        if e.name.startswith(SPAN_PREFIX):
            # a host span; its mirror on the device's timeline (the
            # profiler's annotation of the range there) is no activity
            if e.device_type != torch.autograd.DeviceType.CUDA:
                spans.append((e.time_range.start, e.time_range.end,
                               e.name[len(SPAN_PREFIX):]))
        elif e.device_type == torch.autograd.DeviceType.CUDA:
            dev_events.append(e)
    kernels: dict = collections.defaultdict(lambda: [0, 0.0])
    iv = []
    for e in dev_events:
        a, b = e.time_range.start, e.time_range.end
        if b <= a:
            continue
        k = kernels[e.name]
        k[0] += 1
        k[1] += (b - a) * 1e-6
        iv.append((a, b))
    busy = _union(iv)
    gaps: dict = collections.defaultdict(float)
    for (_, a), (b, _) in zip(busy, busy[1:]):
        mid = 0.5 * (a + b)
        labels = sorted({s[2] for s in spans if s[0] <= mid <= s[1]})
        gaps["+".join(labels) or "other"] += (b - a) * 1e-6
    ops = sorted(((n[:120], v[1]) for n, v in kernels.items()),
                 key=lambda t: -t[1])
    return Trace(
        window_s=wall, busy_s=sum(b - a for a, b in busy) * 1e-6,
        kernels={n: tuple(v) for n, v in kernels.items()},
        device_ops=[[n, s] for n, s in ops[:TOP]],
        idle_gaps=[[n, s] for n, s in sorted(gaps.items(),
                                             key=lambda t: -t[1])[:TOP]])
