"""`bal_sc` executable: forces solver_type=SCHUR_COMPLEMENT (reference
app/bal_sc.cpp pattern, e.g. app/bal_qr.cpp:58-61), on the card unless
`--device cpu` is given."""

import sys

from rootba_tpu_torch.cli.bal import run_app


def main() -> int:
    return run_app(
        "rootba_tpu_torch bundle adjustment (forced SCHUR_COMPLEMENT)",
        forced_solver_type="SCHUR_COMPLEMENT")


if __name__ == "__main__":
    sys.exit(main())
