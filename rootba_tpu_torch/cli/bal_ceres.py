"""`bal_ceres` executable: forces the external-baseline solver
(reference app/bal_ceres.cpp pattern; numpy and scipy stand in for
Ceres). The baselines run on the host: no card is needed."""

import sys

from rootba_tpu_torch.cli.bal import run_app


def main() -> int:
    return run_app(
        "rootba_tpu_torch bundle adjustment (external host baseline)",
        forced_solver_type="CERES")


if __name__ == "__main__":
    sys.exit(main())
