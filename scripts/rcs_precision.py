#!/usr/bin/env python3
"""LM trajectories of one twin in float32 and float64 across the
reduced-camera-system modes, on the card.

    python3 scripts/rcs_precision.py [--twin final3068] [--iters 3]
                                     [--out OUT.json]

Runs the twin (chip_smoke.py's TWINS, seed 17, bench.py's
preprocessing) through the port's CLI with function_tolerance 0 in:
float64 BSR (the reference trajectory), float64 implicit, and float32
BSR, dense and implicit (the implicit operator forms no reduced camera
system, so it has none of the explicit modes' rounding in the folds
H = Jp'Jp - W'W). It prints, per run, the costs, accept/reject flags and
CG iterations, and each cost's relative distance from the float64 BSR
run's at the same iteration; one JSON object at the end, also written
to OUT.json when given.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

# (name, float64?, extra CLI flags)
RUNS = (("f64_bsr", True, ("--sqrt-rcs-mode", "bsr")),
        ("f64_implicit", True, ("--sqrt-rcs-mode", "implicit")),
        ("f32_bsr", False, ("--sqrt-rcs-mode", "bsr")),
        ("f32_dense", False, ("--sqrt-rcs-mode", "dense",
                              "--dense-rcs-max-cameras", "4096")),
        ("f32_implicit", False, ("--sqrt-rcs-mode", "implicit")))


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--twin", default="final3068", choices=sorted(cs.TWINS))
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("rcs_precision: no CUDA device available", file=sys.stderr)
        return 2
    cs.WORK.mkdir(parents=True, exist_ok=True)
    bal = cs.write_twin(args.twin)
    res = {"card": cs.smi_line(), "twin": args.twin, "runs": {}}
    ref = None
    for name, dbl, extra in RUNS:
        t = time.monotonic()
        lg = cs.run_cli(bal, args.iters, f"precision_{args.twin}_{name}",
                        extra, use_double=dbl)
        cost = lg["cost"]
        ref = ref or cost
        run = dict(cost=cost, accepted=lg["step_is_successful"],
                   cg_iters=lg["linear_solver_iterations"][1:],
                   rel_to_f64_bsr=[abs(a - b) / abs(b)
                                   for a, b in zip(cost, ref)],
                   wall_s=time.monotonic() - t)
        res["runs"][name] = run
        print(f"{name}: costs {cost}, accepted {run['accepted']}, CG "
              f"{run['cg_iters']}, rel to f64_bsr "
              f"{['%.2e' % r for r in run['rel_to_f64_bsr']]}", flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(res, indent=1))
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
