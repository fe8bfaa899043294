#!/usr/bin/env python3
"""The float32-vs-float64 cost gap of both packages on one twin, on the
CPU.

    python3 scripts/f32_gap.py [--cams 3068] [--iters 3] [--threads 4]
                               [--out OUT.json]

Writes chip_smoke.py's final-3068 twin (TWINS["final3068"], seed 17)
with its camera, landmark and observation counts scaled by
cams / 3068 (the observations per landmark and the covisibility knobs
kept), loads it with bench.py's preprocessing (chip_smoke.PREPROCESS)
and solves it `--iters` LM iterations with function_tolerance 0 in four
runs: the JAX package (rootba_tpu) and the port (rootba_tpu_torch, on
the CPU), each in float64 and float32. Each run is a process of its
own (the JAX package enables x64 only for float64, as its CLI does).
Below 2,049 cameras `dense_rcs_max_cameras` is set under the camera
count, so every run takes BSR mode, the route of the full-size twin.

Prints each run's costs, accept/reject flags and CG counts, each
float32 cost's relative distance from the same package's float64 cost
at the same iteration (the gap), and one JSON object at the end (also
written to OUT.json when given). It needs both packages, so it runs
where JAX is installed, not on the card's machine.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
WORK = ROOT / "build" / "f32_gap"
RUNS = (("jax", True), ("jax", False), ("port", True), ("port", False))


def twin_path(cams: int) -> Path:
    """The scaled final-3068 twin as BAL text (written once)."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from rootba_tpu_torch.bal.synthetic import (
        generate_synthetic_bal,
        write_bal_file,
    )

    t = dict(cs.TWINS["final3068"])
    scale = cams / t.pop("num_cams")
    lms = round(t.pop("num_lms") * scale)
    obs = round(t.pop("num_obs") * scale)
    path = WORK / f"problem-{cams}-{lms}-f32gap.txt"
    if not path.exists():
        WORK.mkdir(parents=True, exist_ok=True)
        p = generate_synthetic_bal(num_cams=cams, num_lms=lms,
                                   mean_obs_per_lm=obs / lms,
                                   pixel_noise=1.0, seed=17, **t)
        write_bal_file(p, str(path))
    return path


def solve(pkg: str, use_double: bool, path: str, iters: int,
          threads: int) -> dict:
    """One solve in this process; the run's costs, flags and CG counts."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs

    opts = dict(use_double=use_double, max_num_iterations=iters,
                function_tolerance=0.0, verbosity_level=0)
    if pkg == "jax":
        import jax

        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_num_cpu_devices", 1)
        jax.config.update("jax_enable_x64", use_double)
        from rootba_tpu.bal import problem as P
        from rootba_tpu.cli.common import parse_bal_app_arguments
        from rootba_tpu.solver.lm import bundle_adjust

        app = parse_bal_app_arguments(
            "f32 gap", ["--input", path, "--quiet", *cs.PREPROCESS])
        kw = dict(num_devices=1)
    else:
        import torch

        torch.set_num_threads(threads)
        from rootba_tpu_torch.bal import problem as P
        from rootba_tpu_torch.cli.common import parse_bal_app_arguments
        from rootba_tpu_torch.solver.lm import bundle_adjust

        app = parse_bal_app_arguments(
            "f32 gap", ["--input", path, "--quiet", *cs.PREPROCESS])[0]
        kw = dict(device="cpu")
    problem = P.load_normalized_bal_problem(app.dataset)
    opts["dense_rcs_max_cameras"] = min(2048, problem.num_cameras - 1)
    solver = app.solver
    for k, v in opts.items():
        setattr(solver, k, v)
    if pkg == "jax":
        solver.num_devices = kw.pop("num_devices")
    t = time.monotonic()
    s = bundle_adjust(problem, solver, **kw)
    return dict(cost=[i.cost.all.error for i in s.iterations],
                accepted=[i.step_is_successful for i in s.iterations],
                cg_iters=[i.linear_solver_iterations for i in s.iterations],
                solve_s=time.monotonic() - t)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cams", type=int, default=3068)
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--threads", type=int, default=4)
    ap.add_argument("--out", default=None)
    ap.add_argument("--solve", nargs=3, metavar=("PKG", "DOUBLE", "PATH"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.solve:
        pkg, dbl, path = args.solve
        print(json.dumps(solve(pkg, dbl == "1", path, args.iters,
                               args.threads)))
        return 0
    path = twin_path(args.cams)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               OMP_NUM_THREADS=str(args.threads))
    res = {"twin": path.name, "cams": args.cams, "iters": args.iters,
           "runs": {}}
    for pkg, dbl in RUNS:
        name = f"{pkg}_{'f64' if dbl else 'f32'}"
        t = time.monotonic()
        r = subprocess.run(
            [sys.executable, __file__, "--iters", str(args.iters),
             "--threads", str(args.threads), "--solve", pkg,
             "1" if dbl else "0", str(path)],
            capture_output=True, text=True, env=env)
        if r.returncode != 0:
            print(r.stdout + r.stderr, file=sys.stderr)
            return 1
        run = json.loads(r.stdout.strip().splitlines()[-1])
        run["wall_s"] = time.monotonic() - t
        res["runs"][name] = run
        print(f"{name}: costs {run['cost']}, accepted {run['accepted']}, "
              f"CG {run['cg_iters']}, solve {run['solve_s']:.1f} s, wall "
              f"{run['wall_s']:.1f} s", flush=True)
    for pkg in ("jax", "port"):
        a, b = res["runs"][f"{pkg}_f32"], res["runs"][f"{pkg}_f64"]
        gap = [abs(x - y) / abs(y) for x, y in zip(a["cost"], b["cost"])]
        res[f"{pkg}_gap"] = gap
        print(f"{pkg}: f32 vs f64 rel per iteration "
              f"{['%.3e' % g for g in gap]}, max {max(gap):.3e}",
              flush=True)
    jg, pg = max(res["jax_gap"]), max(res["port_gap"])
    res["port_over_jax"] = pg / jg if jg > 0 else None
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(res, indent=1))
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
