#!/usr/bin/env python3
"""Where a benchmark cell's solve spends its host time, from the port's
own spans (rootba_tpu_torch.log.trace), on one card.

    python3 scripts/span_breakdown.py OUT_DIR [--cells A,B] [--seed N]
        [--solves K] [--sync-debug 1]

For each cell of BENCHMARK.json (default: all) it sets up as
portbench/run.py does (the twin's BAL file ordered by --seed, one
warm-up solve), then, in one process:

  * with --sync-debug 1, one solve under
    torch.cuda.set_sync_debug_mode("warn") with the recorder on: every
    synchronising call, by source line, and the innermost program span
    around it (a read outside a sync.* span inside an lm.attempt is one
    the program does not count);
  * the recorder's cost per call while off (`span`, `sync`, `since`,
    `timer`, `count`) and on (`span`, `count`), from a loop of 10^6
    calls, and of the timer on, with its CUDA events and their read,
    from 10^4;
  * 2K solves, recorder off and on in turns (off, on, on, off, ...),
    so that the host's drift falls on both sides: each solve's time, and
    per span name the mean seconds per solve of those with it on;
  * one solve under portbench.trace.Tracer (torch.profiler; taken
    again, up to twice, where the trace lost its marker kernel) with the
    recorder on: per span name its seconds against the untraced mean
    (the profiler's inflation), the card's idle gaps named by the
    harness and program spans (portbench.spans.name_gaps), lm_idle, and
    how much of load_s and host_prep_s the load.* and the outermost
    prep.* and post.* spans cover.

Writes OUT_DIR/spans-<cell>.json per cell and prints one summary line
per cell.
"""

from __future__ import annotations

import argparse
import collections
import gc
import json
import os
import sys
import time
import traceback
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import run, spans, twin  # noqa: E402


def per_name(record, solves) -> dict:
    """Mean seconds per solve of each span name (union per solve)."""
    out = {}
    names = {s[0] for s in record}
    for solve in solves:
        mine = spans.of_solve(record, solve)
        for name in names:
            out[name] = out.get(name, 0.0) + spans.union_s(
                (s[1], s[2]) for s in mine if s[0] == name)
    return {k: v / len(solves) for k, v in sorted(out.items())}


def coverage(record, solve) -> dict:
    mine = spans.of_solve(record, solve)
    load = spans.union_s((s[1], s[2]) for s in mine
                         if s[3] == 0 and s[0].startswith("load."))
    prep = spans.union_s((s[1], s[2]) for s in mine if s[3] == 0
                         and s[0].startswith(("prep.", "post.")))
    host_prep = solve.bundle_adjust_s - solve.minimizer_s
    return {"load_s": solve.load_s, "load_spans_s": load,
            "load_share": load / solve.load_s,
            "host_prep_s": host_prep, "prep_post_spans_s": prep,
            "host_prep_share": prep / host_prep}


def recorder_cost(trace, n=1_000_000, n_timer=10_000) -> dict:
    """Nanoseconds per call of the recorder's entry points (the timer
    on the card, with its two CUDA events and their read, n_timer
    times while on)."""
    import torch

    def per_call(fn, calls=n):
        t = time.perf_counter()
        fn()
        return 1e9 * (time.perf_counter() - t) / calls

    dev = torch.device("cuda")

    def timers_loop(calls=n):
        for _ in range(calls):
            with trace.timer("x", dev):
                pass

    def timers_read():
        timers_loop(n_timer)
        torch.cuda.synchronize()
        trace.settle()

    def counts_loop():
        for _ in range(n):
            trace.count("x", 3)

    def spans_loop():
        for _ in range(n):
            with trace.span("x"):
                pass

    def syncs_loop():
        for _ in range(n):
            with trace.sync("x"):
                pass

    def since_loop():
        t = 0.0
        for _ in range(n):
            trace.since("x", t)

    def empty_loop():
        for _ in range(n):
            pass

    trace.stop()
    out = {"loop_ns": per_call(empty_loop), "span_off_ns":
           per_call(spans_loop), "sync_off_ns": per_call(syncs_loop),
           "since_off_ns": per_call(since_loop),
           "timer_off_ns": per_call(timers_loop),
           "count_off_ns": per_call(counts_loop)}
    trace.start()
    out["span_on_ns"] = per_call(spans_loop)
    out["count_on_ns"] = per_call(counts_loop)
    out["timer_on_ns"] = per_call(timers_read, n_timer)
    trace.stop()
    return out


def sync_scan(program, dataset, solver, trace) -> dict:
    """Every synchronising call of one solve, by source line, with the
    innermost program span around it."""
    import torch

    hits = []

    def show(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" not in str(message):
            return
        stack = [f for f in traceback.extract_stack()[:-1]
                 if "rootba_tpu_torch" in f.filename]
        where = (f"{Path(stack[-1].filename).relative_to(ROOT)}:"
                 f"{stack[-1].lineno} {stack[-1].name}" if stack else
                 f"{filename}:{lineno}")
        hits.append((time.monotonic(), where))

    trace.start()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = show
        torch.cuda.set_sync_debug_mode("warn")
        try:
            s = program.solve(dataset, solver)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    record, _ = trace.stop()
    by = collections.Counter()
    for t, where in hits:
        inner = max((x for x in record if x[1] <= t <= x[2]),
                    key=lambda x: x[3], default=None)
        attempt = any(x[0] == "lm.attempt" and x[1] <= t <= x[2]
                      for x in record)
        by[(where, inner[0] if inner else "-", attempt)] += 1
    its = s.lm_iterations
    return {"lm_iterations": its, "syncs": len(hits), "by_site": [
        {"where": w, "span": sp, "in_attempt": a, "count": c,
         "per_iter": c / its} for (w, sp, a), c in by.most_common()]}


def measure(cell_name, seed, k, sync_debug, out_dir: Path) -> dict:
    import torch

    from portbench.trace import Tracer
    from rootba_tpu_torch.log import trace

    cell = run.Cell(run.read_json(ROOT / "BENCHMARK.json"), cell_name)
    program = run.Program("cuda")
    program.build()
    conf = cell.config
    dataset = dict(conf["dataset"], quiet=True)
    solver = dict(cell.traffic["solver"])
    tmp = Path(os.environ.get("TMPDIR") or run.CACHE)
    tmp.mkdir(parents=True, exist_ok=True)
    path = tmp / f"spans-{cell_name}-{seed}.txt"
    dataset["input"] = str(path)
    tw = twin.generate(conf["num_cams"], conf["num_lms"], conf["num_obs"],
                       conf["twin_seed"], **conf["twin"])
    twin.write_bal(tw, str(path), order_seed=seed)
    del tw
    out = {"cell": cell_name, "seed": seed,
           "device": torch.cuda.get_device_name(0)}
    try:
        program.solve(dataset, dict(solver,
                                    max_num_iterations=run.WARMUP_ITERATIONS))
        gc.collect()
        if sync_debug:
            out["sync_scan"] = sync_scan(program, dataset, solver, trace)
            gc.collect()
        out["recorder_ns"] = recorder_cost(trace)
        times = {False: [], True: []}
        on_solves, on_record, counters = [], [], collections.Counter()
        for i in range(2 * k):
            recording = i % 4 in (1, 2)
            if recording:
                trace.start()
            torch.cuda.synchronize()
            solve = program.solve(dataset, solver)
            gc.collect()
            if recording:
                rec, cnt = trace.stop()
                on_record += rec
                on_solves.append(solve)
                counters.update(cnt)
            times[recording].append(solve.t2 - solve.t0)
        out["solve_s_off"], out["solve_s_on"] = times[False], times[True]
        out["untraced_per_name_s"] = per_name(on_record, on_solves)
        its = sum(s.lm_iterations for s in on_solves)
        out["syncs_per_iter"] = {k_: v / its for k_, v in counters.items()}
        out["coverage"] = [coverage(on_record, s) for s in on_solves]

        for attempt in range(3):
            trace.start()
            try:
                with Tracer() as tr:
                    traced = program.solve(dataset, solver)
                break
            except RuntimeError as e:  # a trace that lost its marker
                if attempt == 2:
                    raise
                print(f"[spans] {e}; tracing again", file=sys.stderr)
            finally:
                rec, _ = trace.stop()
        out["traced_per_name_s"] = per_name(rec, [traced])
        out["inflation"] = {
            n: out["traced_per_name_s"][n] / v
            for n, v in out["untraced_per_name_s"].items()
            if v > 0 and n in out["traced_per_name_s"]}
        dt = tr.trace
        out["traced_solve_s"] = traced.t2 - traced.t0
        out["device_idle"] = 100.0 * (1.0 - dt.busy_s() / dt.window_s)
        attempts = spans.merged((s[1], s[2]) for s in rec
                                if s[0] == "lm.attempt")
        total = sum(b - a for a, b in attempts)
        out["lm_idle"] = 100.0 * (1.0 - spans.overlap_s(
            attempts, dt.busy_intervals()) / total)
        out["idle_gaps"] = spans.name_gaps(dt.gaps(), traced.spans(), rec,
                                           n=30)
        out["traced_coverage"] = coverage(rec, traced)
    finally:
        path.unlink(missing_ok=True)
    (out_dir / f"spans-{cell_name}.json").write_text(json.dumps(out,
                                                                indent=1))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("out_dir")
    ap.add_argument("--cells", default="")
    ap.add_argument("--seed", type=int, default=2 ** 31 + 11)
    ap.add_argument("--solves", type=int, default=2)
    ap.add_argument("--sync-debug", type=int, default=1)
    args = ap.parse_args()
    out_dir = Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    os.environ["TORCH_EXTENSIONS_DIR"] = str(run.CACHE / "torch_extensions")
    cells = (args.cells.split(",") if args.cells else
             [w["name"] for w in run.read_json(ROOT / "BENCHMARK.json")
              ["workloads"]])
    for name in cells:
        o = measure(name, args.seed, args.solves, args.sync_debug, out_dir)
        print(json.dumps({
            "cell": name, "device": o["device"],
            "solve_s_off": o["solve_s_off"], "solve_s_on": o["solve_s_on"],
            "recorder_ns": o["recorder_ns"],
            "syncs_per_iter": o["syncs_per_iter"],
            "unwrapped_in_attempt": [
                x for x in o.get("sync_scan", {}).get("by_site", [])
                if x["in_attempt"] and not x["span"].startswith("sync.")],
            "lm_idle": o["lm_idle"], "device_idle": o["device_idle"],
            "idle_gaps": o["idle_gaps"][:8]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
