"""Spans and counters of what the host does in a solve, for the
benchmark's per-layer metrics (portbench/spans.py reads them).

    trace.start()
    with trace.span("prep.bucketize"):
        ...
    with trace.sync("pcg"):  # a span "sync.pcg", counted once
        n = int(term)
    trace.count("name")
    with trace.timer("rcs.assemble", device):  # device time, no sync
        ...
    trace.settle()  # after a sync that covers the timed work
    spans, counters = trace.stop()

`stop()` returns the spans as (name, t0, t1, depth) in start order,
depth being the number of recorded spans that enclose the span, and the
counters as {name: value}. A timer counts its blocks under its name and
adds their seconds to the counter "<name>_s": on the card from two CUDA
events, read by the next `settle()` (which the caller places after a
sync it makes anyway, so the timer adds none), on the CPU from the
host clock at once. The recorder is off until `start()`, and a run
that never calls it records nothing: `span`, `sync` and `timer` then
check one module global and return one shared no-op context manager,
with no clock read, no event and nothing allocated or appended.

Every time is `time.monotonic()`, the clock that the benchmark's
harness times its solves on and onto which its device trace is placed
(portbench/trace.py shifts the trace by a marker kernel launched at a
known monotonic time), so program spans and device operations need no
further alignment. The recorder keeps no state beyond the current
record, and serves the one host thread that a solve runs on.
"""

from __future__ import annotations

import time
from typing import Dict, List, Tuple

import torch

_on = False
_spans: List[Tuple[str, float, float]] = []
_counters: Dict[str, float] = {}
# (counter, start event, end event) of the CUDA timers not read yet
_pending: List[tuple] = []


class _Off:
    """The context manager of every span while the recorder is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Span:
    __slots__ = ("name", "t0")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.t0 = time.monotonic()
        return self

    def __exit__(self, *exc):
        _spans.append((self.name, self.t0, time.monotonic()))
        return False


def span(name: str):
    """A context manager that records the block as a span `name`."""
    if not _on:
        return _OFF
    return _Span(name)


def sync(site: str):
    """The span "sync.<site>" around a blocking device-to-host read,
    counted once under that name."""
    if not _on:
        return _OFF
    name = "sync." + site
    _counters[name] = _counters.get(name, 0) + 1
    return _Span(name)


class _Timer:
    __slots__ = ("name", "cuda", "a")

    def __init__(self, name: str, cuda: bool):
        self.name = name
        self.cuda = cuda

    def __enter__(self):
        if self.cuda:
            self.a = torch.cuda.Event(enable_timing=True)
            self.a.record()
        else:
            self.a = time.monotonic()
        return self

    def __exit__(self, *exc):
        _counters[self.name] = _counters.get(self.name, 0) + 1
        if self.cuda:
            b = torch.cuda.Event(enable_timing=True)
            b.record()
            _pending.append((self.name + "_s", self.a, b))
        else:
            _add_seconds(self.name + "_s", time.monotonic() - self.a)
        return False


def _add_seconds(name: str, s: float) -> None:
    _counters[name] = _counters.get(name, 0.0) + s


def timer(name: str, device):
    """A context manager that times the block's work on `device` (a
    torch.device): counted under `name`, its seconds added to
    "<name>_s" (on the card at the next `settle()`)."""
    if not _on:
        return _OFF
    return _Timer(name, device.type == "cuda")


def settle() -> None:
    """Adds the seconds of the card's timed blocks recorded since the
    last call to their counters. Call it only after a sync that covers
    them: reading a CUDA event that has not completed raises."""
    for name, a, b in _pending:
        _add_seconds(name, a.elapsed_time(b) / 1e3)
    _pending.clear()


def count(name: str, n: int = 1) -> None:
    """Adds n to the counter `name`."""
    if _on:
        _counters[name] = _counters.get(name, 0) + n


def add(name: str, t0: float, t1: float) -> None:
    """Records a span from monotonic times the caller took itself."""
    if _on:
        _spans.append((name, t0, t1))


def since(name: str, t0: float) -> float:
    """Records the span (name, t0, now) and returns now; while off it
    returns t0 and reads no clock."""
    if not _on:
        return t0
    t1 = time.monotonic()
    _spans.append((name, t0, t1))
    return t1


def start() -> None:
    """Clears the record and turns recording on."""
    global _on
    _spans.clear()
    _counters.clear()
    _pending.clear()
    _on = True


def stop():
    """Turns recording off and hands over the record: (spans,
    counters)."""
    global _on
    _on = False
    out = []
    stack: List[float] = []  # end times of the enclosing spans
    for name, t0, t1 in sorted(_spans, key=lambda s: (s[1], -s[2])):
        while stack and t1 > stack[-1]:
            stack.pop()
        out.append((name, t0, t1, len(stack)))
        stack.append(t1)
    counters = dict(_counters)
    _spans.clear()
    _counters.clear()
    _pending.clear()
    return out, counters
