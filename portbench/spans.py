"""The program's own spans and counters (rootba_tpu_torch.log.trace) as
the span metrics read them, and the names of the card's idle gaps.

The recorder is on only in a traced run (--trace 1). run.py loads a
cell's per-layer readers before the window of a traced run, and no
per-layer reader in an untraced run, so each span reader calls
`begin()` as it loads: the recorder is on for the window and off in
every run the driver times end to end. `install`, which run.py calls
before the traced solve (on the card), keeps the window's record apart
and starts a new one for the traced solve; the first `read` stops the
recorder. A span belongs to the solve whose harness window [t0, t2]
holds it. On a program without the recorder `recorder()` is None and
the readers read nothing.
"""

from __future__ import annotations

import bisect
from typing import List, Optional, Sequence, Tuple

Span = Tuple[str, float, float, int]  # (name, t0, t1, depth)


def recorder():
    """rootba_tpu_torch.log.trace, or None where the program lacks it."""
    try:
        from rootba_tpu_torch.log import trace
    except ImportError:
        return None
    return trace


def begin() -> None:
    tr = recorder()
    if tr is not None:
        tr.start()


def install(ctx) -> None:
    tr = recorder()
    if tr is None or hasattr(ctx, "program_window"):
        return
    ctx.program_window = tr.stop()
    tr.start()


def records(ctx):
    """(the window's record, the traced solve's record), each (spans,
    counters) or None."""
    tr = recorder()
    if tr is None:
        return None, None
    if not hasattr(ctx, "program_records"):
        last = tr.stop()
        window = getattr(ctx, "program_window", None)
        ctx.program_records = ((last, None) if window is None
                               else (window, last))
    return ctx.program_records


def of_solve(spans: Sequence[Span], solve) -> List[Span]:
    return [s for s in spans if solve.t0 <= s[1] and s[2] <= solve.t2]


def union_s(intervals) -> float:
    """The length of the union of (t0, t1) intervals."""
    return sum(b - a for a, b in merged(intervals))


def inside(spans: Sequence[Span], is_outer) -> List[Span]:
    """The spans that lie inside a span that `is_outer` accepts (those
    may not nest in one another)."""
    box = sorted((s[1], s[2]) for s in spans if is_outer(s))
    starts = [a for a, _ in box]
    out = []
    for s in spans:
        i = bisect.bisect_right(starts, s[1]) - 1
        if not is_outer(s) and i >= 0 and s[2] <= box[i][1]:
            out.append(s)
    return out


def is_sync(name: str) -> bool:
    return name.startswith("sync.")


def lm_iterations(ctx) -> int:
    return sum(s.lm_iterations for s in ctx.solves)


def seconds_per_solve(ctx, match) -> Optional[float]:
    """Mean over the window's solves of the union of the spans whose
    name `match` accepts; None where no solve has one."""
    spans = (records(ctx)[0] or ([], {}))[0]
    per = [[(s[1], s[2]) for s in of_solve(spans, solve) if match(s[0])]
           for solve in ctx.solves]
    if not any(per):
        return None
    return sum(union_s(p) for p in per) / len(per)


def overlap_s(a, b) -> float:
    """The length of the intersection of two sorted lists of disjoint
    intervals."""
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def merged(intervals) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def name_gaps(gaps, harness, program: Sequence[Span], n: int = 10) -> list:
    """The n longest of the card's idle `gaps` [(a, b)], longest first,
    as [name, seconds]: the harness span (name, t0, t1) that holds the
    gap's midpoint ("harness" where none does), then "/" and the
    innermost program span that holds it, where one does
    ("host_prep/prep.build.pair_stream")."""
    out = []
    for a, b in sorted(gaps, key=lambda g: g[0] - g[1])[:n]:
        mid = 0.5 * (a + b)
        name = next((nm for nm, s0, s1 in harness if s0 <= mid < s1),
                    "harness")
        inner = max((s for s in program if s[1] <= mid < s[2]),
                    key=lambda s: s[3], default=None)
        if inner is not None:
            name = f"{name}/{inner[0]}"
        out.append([name, b - a])
    return out
