"""Analytic FLOP-count model: QR vs SC landmark marginalization.

Port of the reference's scripts/num_ops/compute_num_ops.py concept: for
a landmark observed n times, estimate the floating-point operations of
the two marginalization strategies and of the per-CG-iteration matvec,
to predict which solver is cheaper for a given obs-count distribution.

Counts follow the port's projection-form sqrt marginalization (see
solver/sqrt_qr.py) rather than the reference's in-place storage QR;
both are reported per landmark.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

POSE = 9


@dataclass
class OpCounts:
    linearize: float  # residual+jacobians per landmark
    marginalize: float  # stage2 per landmark (QR / Hll^-1)
    matvec: float  # implicit RCS matvec per landmark per CG iteration
    rhs: float
    back_substitute: float

    @property
    def total_per_solve(self):
        return (self.linearize + self.marginalize + self.rhs
                + self.back_substitute)


def qr_counts(n: int) -> OpCounts:
    """Projection-form sqrt marginalization for a landmark with n obs."""
    rows = 2 * n
    # projection + analytic jacobians ~ 230 flops per obs
    linearize = 230.0 * n
    # thin QR of [2n+3, 3]: 3 reflections, each ~4 * m * 3 flops, plus
    # Q1 reconstruction (3 more applications)
    m = rows + 3
    marginalize = 2 * (3 * 4 * m * 3)
    # matvec: gather-free core = 2*(2n*9) (Jp x) + 2*(2n*3)*2 (project)
    # + 2*(2n*9) (Jp^T)
    matvec = 2 * rows * POSE * 2 + 4 * rows * 3
    rhs = matvec
    back_substitute = matvec + 30
    return OpCounts(linearize, marginalize, matvec, rhs, back_substitute)


def sc_counts(n: int) -> OpCounts:
    """Explicit SC assembly for a landmark with n obs (O(n^2) blocks)."""
    rows = 2 * n
    linearize = 230.0 * n
    # Hll (rows*9) + 3x3 inverse (~50) + n^2 block products
    # T_i = Jl_i' Jp_i (2*2*3*9 per obs) then n^2 * (3x9' * 3x3 * 3x9)
    marginalize = (2 * rows * 9 + 50 + n * 2 * 2 * 3 * POSE
                   + n * n * (2 * 3 * 3 * POSE + 2 * 3 * POSE * POSE))
    # explicit matvec touches n^2 9x9 blocks
    matvec = n * n * 2 * POSE * POSE
    rhs = 2 * rows * POSE + 2 * rows * 3
    back_substitute = 2 * rows * (POSE + 3) + 50
    return OpCounts(linearize, marginalize, matvec, rhs, back_substitute)


def summarize(obs_counts: np.ndarray, avg_cg_iters: float = 15.0) -> str:
    """Compare expected per-LM-iteration FLOPs for a problem with the
    given per-landmark obs counts."""
    lines = ["n_obs  #lms      QR/lm      SC/lm   QR matvec   SC matvec"]
    uniq, cnt = np.unique(obs_counts, return_counts=True)
    tot_qr = tot_sc = 0.0
    for n, c in zip(uniq, cnt):
        q = qr_counts(int(n))
        s = sc_counts(int(n))
        q_tot = q.total_per_solve + avg_cg_iters * q.matvec
        s_tot = s.total_per_solve + avg_cg_iters * s.matvec
        tot_qr += c * q_tot
        tot_sc += c * s_tot
        lines.append(f"{n:5d} {c:6d} {q_tot:10.0f} {s_tot:10.0f} "
                     f"{q.matvec:11.0f} {s.matvec:11.0f}")
    lines.append(f"TOTAL per LM iteration: QR {tot_qr/1e9:.3f} GFLOP, "
                 f"SC {tot_sc/1e9:.3f} GFLOP "
                 f"(ratio {tot_sc/max(tot_qr,1):.2f}x)")
    return "\n".join(lines)


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description="QR vs SC FLOP model")
    ap.add_argument("input", nargs="?", help="BAL problem file (else use "
                    "a synthetic venice-like distribution)")
    ap.add_argument("--cg-iters", type=float, default=15.0)
    args = ap.parse_args(argv)
    if args.input:
        from rootba_tpu_torch.bal.problem import load_normalized_bal_problem

        p = load_normalized_bal_problem(args.input)
        counts = p.obs_per_landmark()
    else:
        rng = np.random.default_rng(0)
        counts = np.maximum(2, rng.poisson(3.0, 100000) + 2)
    print(summarize(counts, args.cg_iters))
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
