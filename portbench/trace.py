"""The device trace of a traced window, reduced to what the per-layer
metrics and the result's breakdown read.

`torch.profiler` records the card's kernels, copies and sets
(activities=[CUDA]). A short marker kernel (`torch.cuda._sleep`) is
launched on an idle card at a known host time, which places the
trace's clock on the host's, so that each idle gap of the card can be
named by the span the host was in.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

# host seconds kept free of launches at both edges of the trace: the
# profiler keeps a kernel only if it starts and ends inside its window
MARGIN_S = 0.02
MARKER = "spin_kernel"


def short_name(name: str) -> str:
    """A kernel's name without its return type, namespaces and
    arguments: "void (anonymous namespace)::k<float>(float const*)" ->
    "k<float>"."""
    base = name.replace("(anonymous namespace)::", "")
    if base.startswith("void "):
        base = base[5:]
    return base.split("(")[0][:80]


@dataclass
class DeviceTrace:
    """Device operations of a traced span on the host clock (seconds):
    (name, start, end), the span's host edges, and per kernel base name
    (short name up to its first "<") the launches and seconds."""

    ops: List[Tuple[str, float, float]]
    t0: float
    t1: float
    kernels: Dict[str, List[float]] = field(default_factory=dict)

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0

    def busy_intervals(self) -> List[Tuple[float, float]]:
        """The union of the operations' intervals inside the span."""
        out: List[List[float]] = []
        for _, a, b in sorted(self.ops, key=lambda o: o[1]):
            a, b = max(a, self.t0), min(b, self.t1)
            if b <= a:
                continue
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return [(a, b) for a, b in out]

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals())

    def gaps(self) -> List[Tuple[float, float]]:
        """The idle stretches of the card inside the span."""
        edges = [self.t0]
        for a, b in self.busy_intervals():
            edges += [a, b]
        edges.append(self.t1)
        return [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]

    def top_ops(self, n: int = 10) -> List[list]:
        by: Dict[str, float] = {}
        for name, a, b in self.ops:
            by[name] = by.get(name, 0.0) + (b - a)
        return [[k, v] for k, v in sorted(by.items(),
                                          key=lambda kv: -kv[1])[:n]]

    def launches(self, base: str) -> int:
        return int(self.kernels.get(base, [0, 0.0])[0])

    def seconds(self, base: str) -> float:
        return self.kernels.get(base, [0, 0.0])[1]


class Tracer:
    """`with Tracer() as tr: ...` traces the card over the block; tr.trace
    is the DeviceTrace of the block, on the host clock."""

    def __enter__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile

        self._torch = torch
        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.__enter__()
        torch.cuda.synchronize()
        time.sleep(MARGIN_S)
        self._marker_host = time.monotonic()
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        self.t0 = time.monotonic()
        return self

    def __exit__(self, *exc):
        torch = self._torch
        torch.cuda.synchronize()
        self.t1 = time.monotonic()
        time.sleep(MARGIN_S)
        self._prof.__exit__(*exc)
        if exc[0] is None:
            t = time.monotonic()
            self.trace = self._reduce()
            self.reduce_s = time.monotonic() - t
        return False

    def _device_events(self):
        """(name, start s, end s) of every device operation, on the
        trace's clock, from the profiler's raw events (its Python event
        tree is slow to build for 10^5 launches)."""
        cuda = self._torch.autograd.DeviceType.CUDA
        for e in self._prof.profiler.kineto_results.events():
            if e.device_type() == cuda:
                a = e.start_ns() / 1e9
                yield e.name(), a, a + e.duration_ns() / 1e9

    def _reduce(self) -> DeviceTrace:
        raw = []
        marker = None
        for name, a, b in self._device_events():
            name = short_name(name)
            if MARKER in name and marker is None:
                marker = a
                continue
            raw.append((name, a, b))
        if marker is None:
            raise RuntimeError("the trace lost its marker kernel")
        shift = self._marker_host - marker
        ops = [(n, a + shift, b + shift) for n, a, b in raw]
        kernels: Dict[str, List[float]] = {}
        for n, a, b in ops:
            k = kernels.setdefault(n.split("<")[0], [0, 0.0])
            k[0] += 1
            k[1] += b - a
        return DeviceTrace(ops=ops, t0=self.t0, t1=self.t1, kernels=kernels)
