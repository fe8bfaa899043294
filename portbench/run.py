#!/usr/bin/env python3
"""Run one cell of BENCHMARK.json and print its result as one JSON line.

    python3 portbench/run.py --workload traf257.sqrt-f32 --seed 7 \\
        --seconds 30 --trace 0

from the root of a checkout on a machine with the card(s) the cell
asks for. A request is one whole solve of a BAL problem the way the
`bal` CLI runs it: `load_normalized_bal_problem` on the BAL text file,
then `bundle_adjust(..., device="cuda")`, which leaves the solution in
host memory. Set-up (imports, CUDA init, the kernels' build and load,
the configuration's twin and its file under TMPDIR, its observation
lines in an order drawn from --seed, one warm-up solve of 2 LM
iterations) is timed as `setup_s`; then whole solves run back to back
until the first one that ends after --seconds. After the window the
plain reference (portbench/references/) judges every solve of the
window, and the result's `correct` says whether each number it compares
is within its limit (portbench/limits/<workload>.json).

Everything of one cell is found by name: the configuration's file in
BENCHMARK.json, portbench/traffic/<traffic>.json,
portbench/limits/<workload>.json, and each metric's reader,
portbench/metrics/<metric>.py, which defines read(ctx) (a number, or
None where it finds nothing to read) and may define install(ctx),
called before a traced window, and KERNELS, {launch counter: kernel
name in the trace}, which the traced window must hold exactly.
--trace 1 runs the window under the profiler and reports the cell's
per-layer metrics; --trace 0 its end-to-end metrics.

The run fails, printing no result, without the card(s), and if jax,
jaxlib, flax or the JAX package rootba_tpu is loaded once the window
has closed.
"""

from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / "build" / "portbench"
FORBIDDEN = ("jax", "jaxlib", "flax", "rootba_tpu")
RETRACES = 3
# LM iterations of the warm-up solve that set-up runs before the window
WARMUP_ITERATIONS = 2

if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def process_age_s() -> float:
    """Seconds since this process started (Linux)."""
    with open("/proc/self/stat") as fp:
        start_ticks = int(fp.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as fp:
        uptime = float(fp.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def read_json(path: Path) -> dict:
    with open(path) as fp:
        return json.load(fp)


class Cell:
    """One workload of BENCHMARK.json with its files."""

    def __init__(self, manifest: dict, workload: str, root: Path = ROOT):
        cells = {w["name"]: w for w in manifest["workloads"]}
        if workload not in cells:
            raise SystemExit(f"unknown workload {workload!r}; "
                             f"known: {', '.join(sorted(cells))}")
        w = cells[workload]
        self.name = workload
        self.chips = w["chips"]
        conf = {c["name"]: c for c in manifest["configs"]}[w["config"]]
        self.config = read_json(root / conf["file"])
        self.traffic = read_json(root / "portbench" / "traffic"
                                 / f"{w['traffic']}.json")
        self.limits = read_json(root / "portbench" / "limits"
                                / f"{workload}.json")

        def mine(m):
            return m.get("workloads") is None or workload in m["workloads"]

        self.end_to_end = [m for m in manifest["end_to_end"] if mine(m)]
        self.per_layer = [m for m in manifest["per_layer"] if mine(m)]


class Solve:
    """One request of the window: host times of its two calls, the
    solver's summary and the problem, which holds the solution."""

    def __init__(self, t0, t1, t2, summary, problem):
        self.t0, self.t1, self.t2 = t0, t1, t2
        self.summary = summary
        self.problem = problem

    @property
    def load_s(self) -> float:
        return self.t1 - self.t0

    @property
    def bundle_adjust_s(self) -> float:
        return self.t2 - self.t1

    @property
    def minimizer_s(self) -> float:
        return self.summary.minimizer_time_in_seconds

    @property
    def lm_iterations(self) -> int:
        return len(self.summary.iterations) - 1

    def spans(self):
        """(name, start, end) of what the host did in this solve."""
        lm0 = self.t2 - self.minimizer_s
        return [("load", self.t0, self.t1), ("host_prep", self.t1, lm0),
                ("lm", lm0, self.t2)]

    def answer(self) -> dict:
        p = self.problem
        return dict(obs_lm=p.obs_lm, obs_cam=p.obs_cam, obs_uv=p.obs_uv,
                    cam_q=p.cam_q, cam_t=p.cam_t, cam_intr=p.cam_intr,
                    lm_p=p.lm_p,
                    initial_cost=self.summary.initial_cost.all.error,
                    final_cost=self.summary.final_cost.all.error)


class Context:
    """What the metric readers read: the cell, the window's solves and
    host times, the memory peak, and in a traced run the device trace
    of the window (`trace`), the trace that holds every launch the
    kernel metrics count (`kernel_trace`), the launch counters and the
    probes' records."""

    def __init__(self, cell: Cell):
        self.cell = cell
        self.solves = []
        self.setup_s = None
        self.window_s = None
        self.window_peak_bytes = None
        self.trace = None
        self.kernel_trace = None
        self.traced_solves = []
        self.launches = {}
        self.probes = {}


def _options(cls, values: dict):
    """An options dataclass of the program with `values` set, each
    converted to its field's type (enums parsed by name)."""
    import enum

    o = cls()
    for k, v in values.items():
        cur = getattr(o, k)
        if isinstance(cur, enum.Enum):
            v = type(cur).parse(v)
        elif not isinstance(cur, bool) and isinstance(cur, (int, float)):
            v = type(cur)(v)
        setattr(o, k, v)
    return o


class Program:
    """The system under test, imported by name: the CLI's load and
    solve, on `device`."""

    def __init__(self, device: str):
        from rootba_tpu_torch.bal.problem import load_normalized_bal_problem
        from rootba_tpu_torch.config.options import (
            BalDatasetOptions,
            SolverOptions,
        )
        from rootba_tpu_torch.log.summary import SolverSummary
        from rootba_tpu_torch.ops import kernels
        from rootba_tpu_torch.solver.lm import bundle_adjust

        self.device = device
        self.kernels = kernels
        self._load = load_normalized_bal_problem
        self._ba = bundle_adjust
        self._summary = SolverSummary
        self._ds = BalDatasetOptions
        self._so = SolverOptions

    def build(self):
        """Build (first run of a checkout) and load every kernel library
        and the native tokenizer."""
        from rootba_tpu_torch.native import runtime

        if self.device == "cuda":
            self.kernels.build_all()
            for name in self.kernels.SOURCES:
                self.kernels.load(name)
        runtime.available()

    def solve(self, dataset: dict, solver: dict) -> Solve:
        t0 = time.monotonic()
        problem = self._load(_options(self._ds, dataset))
        t1 = time.monotonic()
        summary = self._summary()
        self._ba(problem, _options(self._so, solver), summary,
                 device=self.device)
        return Solve(t0, t1, time.monotonic(), summary, problem)


def _sync(device: str):
    if device == "cuda":
        import torch

        torch.cuda.synchronize()


def run_window(program: Program, dataset: dict, solver: dict,
               seconds: float) -> tuple:
    """Whole solves back to back until the first that ends after
    `seconds`: (solves, window seconds)."""
    _sync(program.device)
    w0 = time.monotonic()
    solves = []
    while True:
        solves.append(program.solve(dataset, solver))
        # the garbage of each solve is collected before the next starts,
        # not at a moment the allocator picks inside a solve
        gc.collect()
        if time.monotonic() - w0 >= seconds:
            break
    return solves, time.monotonic() - w0


def _retake_kernel_trace(ctx, program, readers, dataset, solver):
    """The window's trace where it holds exactly the launches that the
    wrappers counted for every kernel a metric reads; else a trace of
    one more solve, taken again up to RETRACES times (a trace has been
    seen to lose launches). None where none holds them."""
    from portbench.trace import Tracer

    pairs = {}
    for mod in readers.values():
        pairs.update(getattr(mod, "KERNELS", {}))
    trace, launches = ctx.trace, ctx.launches
    for attempt in range(RETRACES + 1):
        if all(trace.launches(k) == launches.get(c, 0)
               for c, k in pairs.items()):
            return trace
        if attempt == RETRACES:
            break
        print(f"[portbench] trace {attempt} lost launches; retaking one "
              f"solve", file=sys.stderr, flush=True)
        for rec in ctx.probes.values():
            rec.clear()
        program.kernels.reset_launches()
        with Tracer() as tr:
            program.solve(dataset, solver)
        trace, launches = tr.trace, dict(program.kernels.LAUNCHES)
    return None


def idle_gaps(ctx: Context, n: int = 10) -> list:
    """The n longest idle stretches of the card in the traced solves,
    each named by the host span it fell in."""
    spans = [s for solve in ctx.traced_solves for s in solve.spans()]
    out = []
    for a, b in sorted(ctx.trace.gaps(), key=lambda g: g[0] - g[1])[:n]:
        mid = 0.5 * (a + b)
        out.append([next((nm for nm, s0, s1 in spans if s0 <= mid < s1),
                         "harness"), b - a])
    return out


def log_solve(what: str, s: Solve) -> None:
    its = s.summary.iterations[1:]
    print(f"[portbench] {what} solve: {s.t2 - s.t0:.3f} s (load "
          f"{s.load_s:.3f}, bundle_adjust {s.bundle_adjust_s:.3f}, "
          f"minimizer {s.minimizer_s:.3f}), {len(its)} LM iterations, "
          f"{sum(it.linear_solver_iterations for it in its)} linear solver "
          f"iterations, {sum(not it.step_is_successful for it in its)} "
          f"rejected, final cost {s.summary.final_cost.all.error!r}",
          file=sys.stderr, flush=True)


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def main(argv=None, *, device: str = "cuda", root: Path = ROOT) -> int:
    """Run the cell; `device` and `root` (the checkout) are for the CPU
    tests, which drive a run without the card."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    manifest = read_json(root / "BENCHMARK.json")
    cell = Cell(manifest, args.workload, root)
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")

    import torch

    if device == "cuda" and (not torch.cuda.is_available()
                             or torch.cuda.device_count() < cell.chips):
        print(f"[portbench] {cell.name} needs {cell.chips} CUDA card(s); "
              f"this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    if device == "cuda":
        torch.cuda.init()

    from portbench import twin

    program = Program(device)
    program.build()

    conf, traffic = cell.config, cell.traffic
    dataset = dict(conf["dataset"], quiet=True)
    solver = dict(traffic["solver"])
    tmp = Path(os.environ.get("TMPDIR") or CACHE)
    tmp.mkdir(parents=True, exist_ok=True)
    path = tmp / f"portbench-{cell.name}-{args.seed}.txt"
    dataset["input"] = str(path)
    tw = twin.generate(conf["num_cams"], conf["num_lms"], conf["num_obs"],
                       conf["twin_seed"], **conf["twin"])
    twin.write_bal(tw, str(path), order_seed=args.seed)
    del tw
    try:
        return _run(args, cell, program, dataset, solver, path,
                    root / "portbench")
    finally:
        path.unlink(missing_ok=True)


def _run(args, cell, program, dataset, solver, path, bench: Path) -> int:
    import torch

    device = program.device
    cuda = device == "cuda"
    warm = dict(solver, max_num_iterations=WARMUP_ITERATIONS)
    program.solve(dataset, warm)
    gc.collect()
    _sync(device)

    ctx = Context(cell)
    metric_list = cell.end_to_end if not args.trace else cell.per_layer
    readers = {m["name"]: load_module(bench / "metrics" / f"{m['name']}.py",
                                      f"portbench_metric_{i}")
               for i, m in enumerate(metric_list)}
    setup_peak = torch.cuda.max_memory_allocated() if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    ctx.setup_s = process_age_s()
    ctx.solves, ctx.window_s = run_window(program, dataset, solver,
                                          args.seconds)
    ctx.window_peak_bytes = torch.cuda.max_memory_allocated() if cuda else 0
    for s in ctx.solves:
        log_solve("window", s)
    if args.trace and cuda:
        # device metrics read one more solve under the profiler, which
        # slows the launch-bound stages; every other metric reads the
        # untraced window
        from portbench.trace import Tracer

        for mod in readers.values():
            if hasattr(mod, "install"):
                mod.install(ctx)
        program.kernels.reset_launches()
        with Tracer() as tr:
            traced, _ = run_window(program, dataset, solver, 0.0)
        log_solve("traced", traced[0])
        ctx.trace = tr.trace
        ctx.traced_solves = traced
        ctx.launches = dict(program.kernels.LAUNCHES)
        print(f"[portbench] trace of {len(tr.trace.ops)} device operations "
              f"read in {tr.reduce_s:.3f} s", file=sys.stderr, flush=True)
    t_closed = time.monotonic()
    if ctx.trace is not None:
        ctx.kernel_trace = _retake_kernel_trace(ctx, program, readers,
                                                dataset, solver)
    metrics = {}
    units = {m["name"]: m["unit"] for m in cell.end_to_end + cell.per_layer}
    for name, mod in readers.items():
        v = mod.read(ctx)
        if v is not None:
            metrics[name] = {"value": v, "unit": units[name]}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": cell.chips,
           "memory_peak_bytes": max(setup_peak, ctx.window_peak_bytes)}
    solves = ctx.solves + ctx.traced_solves
    result = {"correct": False, "attempted": len(solves), "failed": 0,
              "metrics": metrics, "device": dev}
    if ctx.trace is not None:
        dev["busy_s"] = ctx.trace.busy_s()
        dev["window_s"] = ctx.trace.window_s
        result["breakdown"] = {"device_ops": ctx.trace.top_ops(10),
                               "idle_gaps": idle_gaps(ctx)}

    print(f"[portbench] setup {ctx.setup_s:.3f} s, window {ctx.window_s:.3f} "
          f"s ({len(ctx.solves)} solves), readers and trace "
          f"{time.monotonic() - t_closed:.3f} s", file=sys.stderr, flush=True)
    # the program's state goes before the reference runs on the card
    answers = [s.answer() for s in solves]
    ctx = solves = None
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    ref = load_module(bench / "references"
                      / f"{cell.config['reference']}.py",
                      "portbench_reference")
    per_solve = ref.judge(str(path), dataset, solver,
                          solver["max_num_iterations"], answers, device)
    limits = cell.limits
    checks = {k: {"value": max(p[k] for p in per_solve), "limit": lim}
              for k, lim in limits.items()}
    result["failed"] = sum(any(not p[k] <= lim for k, lim in limits.items())
                           for p in per_solve)
    result["correct"] = result["failed"] == 0
    result["checks"] = checks
    for k, c in checks.items():
        print(f"[portbench] {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    found = forbidden_modules()
    if found:
        print(f"[portbench] loaded in the benchmark's process: "
              f"{', '.join(found)}", file=sys.stderr)
        return 3
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
