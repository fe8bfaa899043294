"""External-library baseline solver (the role the Ceres path plays in
the reference, src/rootba/ceres/: an independent implementation to
validate and compare the manual solvers against).

Uses scipy.optimize.least_squares (Trust Region Reflective with sparse
Jacobians) on the same residual formulation: Snavely projection with
the loaded problem's axis convention, Huber loss matching the manual
solvers' first-order robust weighting (the reference ships
HuberLossFirstOrderCorrection, ceres/loss_function.hpp:44-54, to make
Ceres' cost comparable), state = per-camera [quaternion-free rodrigues?
no --] decoupled SE3 tangent around the initial pose + intrinsics +
landmark positions.

This is host-side numpy (double), deliberately independent of the
torch solver stack (no torch import, no device); selected with
solver_type = "CERES" for CLI parity. It is the port's copy of the JAX
package's `solver/scipy_baseline.py`.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np

from rootba_tpu_torch.bal import nplie
from rootba_tpu_torch.bal.problem import BalProblem
from rootba_tpu_torch.config.options import RobustNorm, SolverOptions
from rootba_tpu_torch.log.summary import (
    CONVERGENCE,
    NO_CONVERGENCE,
    IterationSummary,
    ResidualInfoHost,
    ResidualItemHost,
    SolverSummary,
    finish_iteration,
    finish_solve,
)


def _project_all(cam_q, cam_t, cam_intr, lm_p, obs_cam, obs_lm, obs_uv):
    p_c = (nplie.quat_rotate(cam_q[obs_cam], lm_p[obs_lm])
           + cam_t[obs_cam])
    z = p_c[:, 2]
    z_safe = np.where(np.abs(z) > 1e-12, z, 1e-12)
    d = p_c[:, :2] / z_safe[:, None]
    r2 = np.sum(d * d, axis=1)
    f = cam_intr[obs_cam, 0]
    k1 = cam_intr[obs_cam, 1]
    k2 = cam_intr[obs_cam, 2]
    proj = (f * (1.0 + r2 * (k1 + r2 * k2)))[:, None] * d
    return proj - obs_uv, z > 0


def compute_residual_info(problem: BalProblem,
                          options: SolverOptions) -> ResidualInfoHost:
    res, valid = _project_all(
        problem.cam_q, problem.cam_t, problem.cam_intr, problem.lm_p,
        problem.obs_cam, problem.obs_lm, problem.obs_uv)
    r2 = np.sum(res * res, axis=1)
    if options.residual.robust_norm == RobustNorm.HUBER:
        c = options.residual.huber_parameter
        w = np.where(r2 < c * c, 1.0, c / np.sqrt(np.maximum(r2, 1e-300)))
        err = 0.5 * (2.0 - w) * w * r2
    else:
        err = 0.5 * r2
    rn = np.sqrt(r2)

    def item(mask):
        return ResidualItemHost(num_obs=int(mask.sum()),
                                error=float(err[mask].sum()),
                                residual_sum=float(rn[mask].sum()))

    all_mask = np.ones_like(valid)
    return ResidualInfoHost(all=item(all_mask), valid=item(valid),
                            is_numerically_valid=bool(
                                np.isfinite(res).all()))


def bundle_adjust_scipy(
    problem: BalProblem,
    options: SolverOptions,
    summary: Optional[SolverSummary] = None,
) -> SolverSummary:
    """Solve in place with scipy least_squares (TRF + sparse jacobian)."""
    from scipy.optimize import least_squares
    from scipy.sparse import lil_matrix

    if summary is None:
        summary = SolverSummary()
    t0 = time.monotonic()

    N = problem.num_cameras
    M = problem.num_landmarks
    O = problem.num_observations
    q0 = problem.cam_q.copy()
    t0v = problem.cam_t.copy()
    intr0 = problem.cam_intr.copy()
    lm0 = problem.lm_p.copy()

    # state: per camera decoupled tangent [v(3), w(3), dintr(3)] around
    # the initial pose; per landmark absolute position
    def unpack(x):
        cam = x[:9 * N].reshape(N, 9)
        dq = nplie.so3_exp(cam[:, 3:6])
        q = nplie.quat_normalize(nplie.quat_mul(dq, q0))
        t = nplie.quat_rotate(dq, t0v) + cam[:, 0:3]
        intr = intr0 + cam[:, 6:9]
        lm = x[9 * N:].reshape(M, 3)
        return q, t, intr, lm

    def residuals(x):
        q, t, intr, lm = unpack(x)
        res, _ = _project_all(q, t, intr, lm, problem.obs_cam,
                              problem.obs_lm, problem.obs_uv)
        return res.reshape(-1)

    # jacobian sparsity: obs row-pair touches its camera's 9 + lm's 3
    sparsity = lil_matrix((2 * O, 9 * N + 3 * M), dtype=np.int8)
    rows = np.arange(O)
    for rr in (2 * rows, 2 * rows + 1):
        for j in range(9):
            sparsity[rr, 9 * problem.obs_cam + j] = 1
        for j in range(3):
            sparsity[rr, 9 * N + 3 * problem.obs_lm + j] = 1

    x0 = np.zeros(9 * N + 3 * M)
    x0[9 * N:] = lm0.reshape(-1)

    loss = ("huber" if options.residual.robust_norm == RobustNorm.HUBER
            else "linear")

    # Per-iteration rootba-style cost records (the role the reference's
    # BalIterationCallback plays for Ceres, ceres/bal_iteration_callback
    # .hpp:47: re-evaluate the cost in rootba's own all/valid accounting
    # per solver iteration so logs are comparable across solvers).
    def record_iteration(x, iteration):
        q, t, intr, lm = unpack(x)
        tmp = BalProblem(q, t, intr, lm, problem.obs_lm,
                         problem.obs_cam, problem.obs_uv, quiet=True)
        ri = compute_residual_info(tmp, options)
        it = IterationSummary(iteration=iteration)
        it.cost = ri
        it.step_is_successful = True
        it.linear_solver_type = "scipy_trf"
        now = time.monotonic() - t0
        prev_cum = (summary.iterations[-1].cumulative_time_in_seconds
                    if summary.iterations else 0.0)
        it.iteration_time_in_seconds = now - prev_cum
        it.cumulative_time_in_seconds = now
        finish_iteration(summary, it)
        if options.verbosity_level >= 2:
            print(f"scipy baseline it {iteration}: "
                  f"cost {ri.all.error:.6e} valid {ri.valid.error:.6e}")

    record_iteration(x0, 0)  # iteration 0 = initial cost, like the
    # manual drivers (bal_bundle_adjustment.cpp:311-322)
    count = {"i": 0}

    def callback(intermediate_result=None, x=None):
        count["i"] += 1
        xi = intermediate_result if x is None else x
        if hasattr(xi, "x"):  # OptimizeResult form
            xi = xi.x
        record_iteration(xi, count["i"])

    result = least_squares(
        residuals, x0,
        jac_sparsity=sparsity,
        method="trf",
        tr_solver="lsmr",
        loss=loss,
        f_scale=options.residual.huber_parameter,
        max_nfev=max(options.max_num_iterations, 1),
        # tolerance mapping mirrors the reference's Ceres path
        # (ceres/option_utils.cpp:107-109: function/gradient/parameter
        # tolerances pass through to the external solver)
        ftol=options.function_tolerance or 1e-12,
        xtol=options.parameter_tolerance or 1e-14,
        gtol=options.gradient_tolerance or 1e-14,
        verbose=0,
        callback=callback,
    )

    q, t, intr, lm = unpack(result.x)
    problem.cam_q[:] = q
    problem.cam_t[:] = t
    problem.cam_intr[:] = intr
    problem.lm_p[:] = lm

    # final state record (TRF's last accepted step may postdate the
    # last callback)
    record_iteration(result.x, count["i"] + 1)

    summary.termination_type = (CONVERGENCE if result.status > 0
                                else NO_CONVERGENCE)
    summary.message = result.message
    summary.total_time_in_seconds = time.monotonic() - t0
    summary.minimizer_time_in_seconds = summary.total_time_in_seconds
    finish_solve(summary, "bal_scipy")
    if options.verbosity_level >= 1:
        print(f"scipy baseline: cost {0.5 * result.cost:.6e} "
              f"({result.message})")
    return summary
