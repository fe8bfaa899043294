"""Spans and counters of what the host does in a solve, for the
benchmark's per-layer metrics (portbench/spans.py reads them).

    trace.start()
    with trace.span("prep.bucketize"):
        ...
    with trace.sync("pcg"):  # a span "sync.pcg", counted once
        n = int(term)
    trace.count("name")
    spans, counters = trace.stop()

`stop()` returns the spans as (name, t0, t1, depth) in start order,
depth being the number of recorded spans that enclose the span, and the
counters as {name: value}. The recorder is off until `start()`, and a
run that never calls it records nothing: `span` and `sync` then check
one module global and return one shared no-op context manager, with no
clock read and nothing allocated or appended.

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

_on = False
_spans: List[Tuple[str, float, float]] = []
_counters: Dict[str, int] = {}


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
    return out, counters
