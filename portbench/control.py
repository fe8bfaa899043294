#!/usr/bin/env python3
"""The readings that the limits of a cell are set from (not run by the
benchmark).

    python3 portbench/control.py --workload traf257.sqrt-f32 \\
        --seeds 11,12,13 [--program] [--control]

For each seed it writes the cell's twin, its lines ordered by the seed,
and perturbs it with that seed (a run perturbs with the
configuration's seed: here each seed is another starting point), and
judges with the cell's
reference (portbench/references/) one solve of the program (--program:
the window's call, once; its wall `program_s` and its CG iterations
`program_cg` beside the numbers) and one of the control (--control: the
reference itself, put in the program's place and computed one
precision below the configuration's: TF32 products for float32,
float32 for float64). It prints one JSON line per seed with both sets
of numbers; a sound program reads below each limit, the control above
at least one.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import run, twin  # noqa: E402


def control_precision(solver: dict) -> str:
    return "f32" if solver["use_double"] else "tf32"


def control_answer(ref, path: str, dataset: dict, solver: dict,
                   device) -> dict:
    """The reference solved in the control's precision, as an answer."""
    p = ref.preprocess(ref.read_bal(path), dataset)
    got = ref.solve(p, solver, solver["max_num_iterations"], device,
                    precision=control_precision(solver))
    return dict(obs_lm=p["obs_lm"], obs_cam=p["obs_cam"],
                obs_uv=p["obs_uv"], **got["state"],
                initial_cost=got["costs"][0], final_cost=got["final_cost"])


def main(argv=None, *, device: str = "cuda", root: Path = ROOT) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--program", action="store_true")
    ap.add_argument("--control", action="store_true")
    args = ap.parse_args(argv)
    cell = run.Cell(run.read_json(root / "BENCHMARK.json"), args.workload,
                    root)
    ref = run.load_module(root / "portbench" / "references"
                          / f"{cell.config['reference']}.py",
                          "portbench_reference")
    program = run.Program(device) if args.program else None
    if program is not None:
        program.build()
    conf, solver = cell.config, dict(cell.traffic["solver"])
    tmp = Path(os.environ.get("TMPDIR") or run.CACHE)
    tmp.mkdir(parents=True, exist_ok=True)
    for seed in (int(s) for s in args.seeds.split(",")):
        path = tmp / f"portbench-control-{cell.name}-{seed}.txt"
        dataset = dict(conf["dataset"], quiet=True, random_seed=seed,
                       input=str(path))
        twin.write_bal(twin.generate(conf["num_cams"], conf["num_lms"],
                                     conf["num_obs"], conf["twin_seed"],
                                     **conf["twin"]), str(path),
                       order_seed=seed)
        answers, names, times = [], [], {}
        if program is not None:
            t = time.monotonic()
            solved = program.solve(dataset, solver)
            times["program_s"] = time.monotonic() - t
            times["program_cg"] = sum(it.linear_solver_iterations for it
                                      in solved.summary.iterations[1:])
            answers.append(solved.answer())
            names.append("program")
        if args.control:
            t = time.monotonic()
            answers.append(control_answer(ref, str(path), dataset, solver,
                                          device))
            times["control_s"] = time.monotonic() - t
            names.append(f"control_{control_precision(solver)}")
        t = time.monotonic()
        numbers = ref.judge(str(path), dataset, solver,
                            solver["max_num_iterations"], answers, device)
        times["judge_s"] = time.monotonic() - t
        path.unlink(missing_ok=True)
        print(json.dumps(dict(workload=cell.name, seed=seed, **times,
                              **dict(zip(names, numbers)))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
