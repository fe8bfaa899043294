"""`generate-tables` entry point (analog of the reference's
scripts/generate-tables.py + python/rootba/generate_tables.py): load an
experiments spec, produce the markdown+PNG report.

Spec TOML:

    [options]
    base_path = "."          # optional, default: spec dir
    output_path = "report"   # report output dir
    cache_dir = "cache"      # optional run cache
    metrics = ["cost", "total_time"]        # optional
    tolerances = [0.01, 0.003, 0.001]       # optional

    [[experiments]]
    name = "qr32"
    display_name = "sqrt-BA f32"
    pattern = "runs/01_demo/1_solvers/*qr*"
"""

from __future__ import annotations

import argparse
import os
import sys

from rootba_tpu_torch.eval.experiments import (
    load_all,
    load_experiments_config,
)
from rootba_tpu_torch.eval.report import generate_report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="generate evaluation report")
    ap.add_argument("spec", help="experiments spec TOML")
    ap.add_argument("--no-cache", action="store_true")
    args = ap.parse_args(argv)

    cfg = load_experiments_config(args.spec)
    opts = cfg.get("options", {})
    base = opts.get("base_path", os.path.dirname(args.spec) or ".")
    outdir = os.path.join(base, opts.get("output_path", "report"))

    experiments = load_all(args.spec, use_cache=not args.no_cache)
    path = generate_report(
        experiments, outdir,
        metrics=opts.get("metrics", ("cost", "num_iterations", "total_time",
                                     "linear_solver_time", "peak_memory")),
        tolerances=opts.get("tolerances", (0.01, 0.003, 0.001)),
    )
    print(f"report written to {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
