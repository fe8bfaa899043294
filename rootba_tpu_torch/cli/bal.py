"""`bal` executable: BA solve on one problem (reference app/bal.cpp
:45-121), on the card unless `--device cpu` is given (the CERES
baselines run on the host and need no card).

Usage: python -m rootba_tpu_torch.cli.bal --input problem.txt [options]

A sharded run starts one process per rank with ROOTBA_COORDINATOR
(host:port), ROOTBA_NUM_PROCESSES and ROOTBA_PROCESS_ID set: each joins
the process group (parallel/mesh.py), solves its landmark rows on its
card (every rank on cuda:0 over gloo where there are fewer cards than
ranks), and rank 0 writes the log and the output.
"""

from __future__ import annotations

import os
import sys
import time
from typing import List, Optional

import torch.distributed as dist


def run_app(summary_text: str, argv: Optional[List[str]] = None,
            forced_solver_type: Optional[str] = None) -> int:
    from rootba_tpu_torch.cli.common import parse_bal_app_arguments

    parsed = parse_bal_app_arguments(summary_text, argv, forced_solver_type)
    if parsed is None:
        return 0
    joined = ("ROOTBA_NUM_PROCESSES" in os.environ
              and not dist.is_initialized())
    if joined:
        # before the device is resolved: "cuda" is then this rank's card
        from rootba_tpu_torch.parallel.mesh import init_distributed

        init_distributed()
    try:
        return _run(*parsed)
    finally:
        if joined:
            dist.destroy_process_group()


def _run(options, device_name: str) -> int:
    from rootba_tpu_torch.bal.problem import (
        DatasetSummary,
        PipelineTimingSummary,
        load_normalized_bal_problem,
    )
    from rootba_tpu_torch.config.options import SolverType
    from rootba_tpu_torch.log.ba_log import save_log
    from rootba_tpu_torch.log.summary import SolverSummary
    from rootba_tpu_torch.solver.lm import bundle_adjust
    from rootba_tpu_torch.utils.device import resolve_device

    # before any work: no card and no --device cpu is an error, except
    # for the CERES baselines, which run on the host
    device = (device_name if options.solver.solver_type == SolverType.CERES
              else resolve_device(device_name))

    dataset_summary = DatasetSummary()
    timing = PipelineTimingSummary()
    problem = load_normalized_bal_problem(options.dataset, dataset_summary,
                                          timing)
    solver_summary = SolverSummary()
    bundle_adjust(problem, options.solver, solver_summary, timing,
                  device=device)

    if dist.is_initialized() and dist.get_rank() != 0:
        return 0  # every rank holds the solution; rank 0 writes it
    if options.dataset.save_output:
        t0 = time.monotonic()
        out_path = options.dataset.output_optimized_path
        # .cereal -> reference binary layout (save_rootba,
        # bal_problem.cpp:557-568); .txt/.bal -> reference-readable
        # BAL text; anything else -> npz
        if out_path.endswith(".cereal"):
            from rootba_tpu_torch.bal.rootba_io import save_rootba

            save_rootba(problem, out_path)
        elif out_path.endswith((".txt", ".bal")):
            problem.save_bal(out_path)
        else:
            problem.save_npz(out_path)
        timing.postprocess_time = time.monotonic() - t0

    save_log(options.solver.log, solver_summary, dataset_summary, timing,
             quiet=options.dataset.quiet)
    return 0


def main() -> int:
    return run_app("rootba_tpu_torch bundle adjustment on a BAL problem")


if __name__ == "__main__":
    sys.exit(main())
