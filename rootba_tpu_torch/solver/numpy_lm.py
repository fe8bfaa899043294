"""Step-comparable external LM baseline in plain numpy.

The scipy TRF baseline (scipy_baseline.py) cross-checks *final* costs,
but TRF is a different trust-region algorithm than the reference's LM,
so per-iteration trajectories are not comparable. This module is the
analog of the reference's Ceres path run with the manual solvers' LM
semantics: the SAME lambda/nu/rho trust-region protocol as
optimize_lm (reference optimize_lm_ours,
src/rootba/solver/bal_bundle_adjustment.cpp:249-544 -- lambda update
on success `lam *= max(1/3, 1-(2*rho-1)^3)`, reject `lam *= nu; nu *=
vee_factor`, acceptance `rho = f_diff/l_diff > min_relative_decrease`,
iteration-0 eval only, function-tolerance termination), with the
linear solve done by dense Schur-complement normal equations and
LAPACK -- fully independent of the torch solver stack (host numpy, no
torch import, no device). It is the port's copy of the JAX package's
`solver/numpy_lm.py`.

Because the inner solve is EXACT (direct dense solve of the reduced
camera system, no CG forcing sequence), trajectories agree with the
manual solvers to the extent the CG eta tolerance allows; the
per-iteration costs are recorded with the same all/valid accounting
(the role of the reference's BalIterationCallback,
src/rootba/ceres/bal_iteration_callback.hpp:47).

Matching the manual solvers requires matching their scaling/damping
semantics exactly:
 - sqrt robust weights on J and r (bal_bundle_adjustment_helper.cpp:45-65)
 - per-landmark Jl column scaling 1/(eps + ||col||)
   (landmark_block_base.ipp:572-587)
 - per-camera Jp jacobi scaling 1/(eps + sqrt(diag2))
   (linearizor_qr.cpp:100-107), eps = sqrt(machine eps)
 - landmark damping lam*I on the SCALED Jl gram, pose damping lam*I on
   the SCALED Jp gram
 - l_diff = -sum_obs v'(0.5 v + r), v = J*inc in the scaled frame
   (sc/landmark_block.hpp:409-446; damping rows excluded)
 - decoupled left SE3 increment (bal_problem.hpp:99-101)
"""

from __future__ import annotations

import math
import time
from typing import Optional

import numpy as np

from rootba_tpu_torch.bal import nplie
from rootba_tpu_torch.bal.problem import BalProblem
from rootba_tpu_torch.config.options import (
    OptimizedCost,
    RobustNorm,
    SolverOptions,
)
from rootba_tpu_torch.log.summary import (
    CONVERGENCE,
    NO_CONVERGENCE,
    IterationSummary,
    SolverSummary,
    finish_iteration,
    finish_solve,
)
from rootba_tpu_torch.solver.scipy_baseline import compute_residual_info


def _hat(v):
    """Batched skew matrices [O,3] -> [O,3,3]."""
    O = v.shape[0]
    m = np.zeros((O, 3, 3), v.dtype)
    m[:, 0, 1] = -v[:, 2]
    m[:, 0, 2] = v[:, 1]
    m[:, 1, 0] = v[:, 2]
    m[:, 1, 2] = -v[:, 0]
    m[:, 2, 0] = -v[:, 1]
    m[:, 2, 1] = v[:, 0]
    return m


def _quat_to_matrix(q):
    w, x, y, z = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = np.stack([
        1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
        2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
        2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
    ], axis=-1)
    return m.reshape(-1, 3, 3)


def linearize_all(q, t, intr, lm_p, obs_cam, obs_lm, obs_uv,
                  robust_norm, huber_c):
    """Analytic residual/Jacobian for every observation, sqrt-robust
    weighted (the numpy mirror of linearize_point,
    bal_bundle_adjustment_helper.cpp:112-146).

    Returns Jp [O,2,9] (pose [v,w] + intrinsics [f,k1,k2]),
    Jl [O,2,3], r [O,2]."""
    R = _quat_to_matrix(q)[obs_cam]
    p_c = np.einsum("oij,oj->oi", R, lm_p[obs_lm]) + t[obs_cam]
    x, y, z = p_c[:, 0], p_c[:, 1], p_c[:, 2]
    zinv = 1.0 / z
    dx, dy = x * zinv, y * zinv
    r2 = dx * dx + dy * dy
    f = intr[obs_cam, 0]
    k1 = intr[obs_cam, 1]
    k2 = intr[obs_cam, 2]
    rp = 1.0 + r2 * (k1 + r2 * k2)
    d = np.stack([dx, dy], axis=-1)
    proj = (f * rp)[:, None] * d
    res = proj - obs_uv

    # d d / d p_c  [O,2,3]
    Dd = np.zeros((len(z), 2, 3))
    Dd[:, 0, 0] = zinv
    Dd[:, 0, 2] = -x * zinv * zinv
    Dd[:, 1, 1] = zinv
    Dd[:, 1, 2] = -y * zinv * zinv
    dr2_dp = 2.0 * (dx[:, None] * Dd[:, 0] + dy[:, None] * Dd[:, 1])
    dproj_dpc = (f * rp)[:, None, None] * Dd + \
        (f * (k1 + 2.0 * k2 * r2))[:, None, None] * \
        np.einsum("oi,oj->oij", d, dr2_dp)

    # pose: p_c' = exp(w^)p_c + v  =>  d p_c/dv = I, d p_c/dw = -hat(p_c)
    Jp = np.zeros((len(z), 2, 9))
    Jp[:, :, 0:3] = dproj_dpc
    Jp[:, :, 3:6] = -np.einsum("oij,ojk->oik", dproj_dpc, _hat(p_c))
    Jp[:, :, 6] = rp[:, None] * d
    Jp[:, :, 7] = (f * r2)[:, None] * d
    Jp[:, :, 8] = (f * r2 * r2)[:, None] * d
    Jl = np.einsum("oij,ojk->oik", dproj_dpc, R)

    if robust_norm == RobustNorm.HUBER:
        rsq = np.sum(res * res, axis=1)
        rn = np.sqrt(np.maximum(rsq, np.finfo(np.float64).tiny))
        w = np.where(rsq < huber_c * huber_c, 1.0, huber_c / rn)
        sw = np.sqrt(w)
        Jp *= sw[:, None, None]
        Jl *= sw[:, None, None]
        res = res * sw[:, None]
    return Jp, Jl, res


class _NumpyLinearizer:
    """Dense Schur-complement linear algebra for one problem."""

    def __init__(self, problem: BalProblem, options: SolverOptions):
        self.opts = options
        self.obs_cam = problem.obs_cam
        self.obs_lm = problem.obs_lm
        self.obs_uv = problem.obs_uv.astype(np.float64)
        self.N = problem.num_cameras
        self.M = problem.num_landmarks
        self.eps = math.sqrt(np.finfo(np.float64).eps)
        # within-landmark observation pair list (i over obs of the
        # landmark x j over obs) for the off-diagonal SC blocks
        order = np.argsort(self.obs_lm, kind="stable")
        self.order = order
        counts = np.bincount(self.obs_lm, minlength=self.M)
        self.counts = counts
        starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
        pi, pj = [], []
        for l in range(self.M):
            seg = order[starts[l]:starts[l] + counts[l]]
            if len(seg) < 2:
                continue
            a, b = np.meshgrid(seg, seg, indexing="ij")
            m = a != b
            pi.append(a[m])
            pj.append(b[m])
        self.pair_i = (np.concatenate(pi) if pi
                       else np.zeros(0, np.int64))
        self.pair_j = (np.concatenate(pj) if pj
                       else np.zeros(0, np.int64))

    def set_state(self, q, t, intr, lm_p):
        self.q, self.t, self.intr, self.lm_p = q, t, intr, lm_p

    def compute_error(self):
        tmp = BalProblem(self.q, self.t, self.intr, self.lm_p,
                         self.obs_lm, self.obs_cam, self.obs_uv,
                         quiet=True)
        return compute_residual_info(tmp, self.opts)

    def linearize(self):
        ropt = self.opts.residual
        Jp, Jl, r = linearize_all(
            self.q, self.t, self.intr, self.lm_p, self.obs_cam,
            self.obs_lm, self.obs_uv, ropt.robust_norm,
            ropt.huber_parameter)
        # per-landmark Jl column scaling over all 2n rows
        colsq = np.zeros((self.M, 3))
        np.add.at(colsq, self.obs_lm, np.sum(Jl * Jl, axis=1))
        self.jl_scale = 1.0 / (self.eps + np.sqrt(colsq))  # [M,3]
        Jl = Jl * self.jl_scale[self.obs_lm][:, None, :]
        # per-camera jacobi scaling from column diag2
        diag2 = np.zeros((self.N, 9))
        np.add.at(diag2, self.obs_cam, np.sum(Jp * Jp, axis=1))
        if self.opts.jacobi_scaling:
            self.pose_scale = 1.0 / (self.eps + np.sqrt(diag2))
        else:
            self.pose_scale = np.ones_like(diag2)
        Jp = Jp * self.pose_scale[self.obs_cam][:, None, :]
        self.Jp, self.Jl, self.r = Jp, Jl, r

    def solve(self, lam):
        """Dense damped SC solve; returns scaled pose increment [N,9]."""
        Jp, Jl, r = self.Jp, self.Jl, self.r
        # Hll (damped) and bl per landmark
        Hll = np.zeros((self.M, 3, 3))
        np.add.at(Hll, self.obs_lm, np.einsum("ori,orj->oij", Jl, Jl))
        Hll += lam * np.eye(3)
        bl = np.zeros((self.M, 3))
        np.add.at(bl, self.obs_lm, np.einsum("ori,or->oi", Jl, r))
        Hll_inv = np.linalg.inv(Hll)
        self.Hll_inv = Hll_inv

        W = np.einsum("ori,orj->oij", Jp, Jl)  # [O,9,3]
        y = np.einsum("lij,lj->li", Hll_inv, bl)  # [M,3]
        bp = np.zeros((self.N, 9))
        np.add.at(bp, self.obs_cam, np.einsum("ori,or->oi", Jp, r))
        b_red = bp.copy()
        np.add.at(b_red, self.obs_cam,
                  -np.einsum("oij,oj->oi", W, y[self.obs_lm]))

        H = np.zeros((self.N, 9, self.N, 9))
        diag = np.zeros((self.N, 9, 9))
        np.add.at(diag, self.obs_cam, np.einsum("ori,orj->oij", Jp, Jp))
        diag += lam * np.eye(9)
        gi = np.arange(self.N)
        H[gi, :, gi, :] += diag
        if len(self.pair_i):
            WHW = np.einsum(
                "oij,ojk,olk->oil",
                W[self.pair_i],
                Hll_inv[self.obs_lm[self.pair_i]],
                W[self.pair_j])
            np.subtract.at(
                H, (self.obs_cam[self.pair_i], slice(None),
                    self.obs_cam[self.pair_j]), WHW)
        # self-pair terms (i == j within a landmark)
        WHW_d = np.einsum(
            "oij,ojk,olk->oil", W, Hll_inv[self.obs_lm], W)
        sub = np.zeros((self.N, 9, 9))
        np.add.at(sub, self.obs_cam, WHW_d)
        H[gi, :, gi, :] -= sub

        dp = np.linalg.solve(H.reshape(9 * self.N, 9 * self.N),
                             -b_red.reshape(-1)).reshape(self.N, 9)
        return dp

    def apply(self, dp):
        """Back-substitute + state update; returns (new state, l_diff)."""
        Jp, Jl, r = self.Jp, self.Jl, self.r
        # dl = -Hll^-1 (bl + W' dp) per landmark, in the scaled frame
        u = np.einsum("ori,oi->or", Jp, dp[self.obs_cam]) + r  # Jp dp + r
        t3 = np.zeros((self.M, 3))
        np.add.at(t3, self.obs_lm, np.einsum("ori,or->oi", Jl, u))
        dl = -np.einsum("lij,lj->li", self.Hll_inv, t3)

        v = (u - r) + np.einsum("ori,oi->or", Jl, dl[self.obs_lm])
        l_diff = -float(np.sum(v * (0.5 * v + r)))

        dp_real = dp * self.pose_scale
        dl_real = dl * self.jl_scale
        q, t = nplie_apply_inc_pose(self.q, self.t, dp_real[:, :6])
        intr = self.intr + dp_real[:, 6:9]
        lm_p = self.lm_p + dl_real
        return (q, t, intr, lm_p), l_diff


def nplie_apply_inc_pose(q, t, inc):
    """Decoupled left SE3 increment (core/lie.py apply_inc_pose)."""
    dq = nplie.so3_exp(inc[:, 3:6])
    q_new = nplie.quat_normalize(nplie.quat_mul(dq, q))
    t_new = nplie.quat_rotate(dq, t) + inc[:, 0:3]
    return q_new, t_new


def bundle_adjust_numpy_lm(
    problem: BalProblem,
    options: SolverOptions,
    summary: Optional[SolverSummary] = None,
) -> SolverSummary:
    """Solve in place with the numpy LM (reference protocol,
    bal_bundle_adjustment.cpp:249-544)."""
    if summary is None:
        summary = SolverSummary()
    t_total = time.monotonic()
    lin = _NumpyLinearizer(problem, options)
    lin.set_state(problem.cam_q.astype(np.float64),
                  problem.cam_t.astype(np.float64),
                  problem.cam_intr.astype(np.float64),
                  problem.lm_p.astype(np.float64))

    min_lambda = 1.0 / options.max_trust_region_radius
    max_lambda = 1.0 / options.min_trust_region_radius
    lam = 1.0 / options.initial_trust_region_radius
    lambda_vee = options.initial_vee
    max_it = options.max_num_iterations
    verbose = options.verbosity_level >= 2

    def cost_of(ri):
        return (ri.all.error
                if options.optimized_cost == OptimizedCost.ERROR
                else ri.valid.error)

    terminated = False
    it = 0
    ri = lin.compute_error()
    while it <= max_it and not terminated:
        it_summary = IterationSummary(iteration=it)
        if it == 0:
            it_summary.cost = ri
            it_summary.step_is_successful = True
            it_summary.step_is_valid = True
            it_summary.trust_region_radius = 1.0 / lam
            it_summary.cumulative_time_in_seconds = (
                time.monotonic() - t_total)
            finish_iteration(summary, it_summary)
            it += 1
            continue

        lin.linearize()
        while it <= max_it and not terminated:
            if it_summary is None:
                it_summary = IterationSummary(iteration=it)
            dp = lin.solve(lam)
            it_summary.linear_solver_type = "numpy_lm"
            backup = (lin.q, lin.t, lin.intr, lin.lm_p)
            new_state, l_diff = lin.apply(dp)
            lin.set_state(*new_state)
            ri2 = lin.compute_error()
            it_summary.cost = ri2
            f_diff = cost_of(ri) - cost_of(ri2)
            rho = f_diff / l_diff if l_diff != 0 else math.inf
            it_summary.relative_decrease = rho
            it_summary.step_is_valid = l_diff > 0
            it_summary.step_is_successful = (
                it_summary.step_is_valid
                and rho > options.min_relative_decrease)
            if verbose:
                print(f"numpy_lm it {it}: cost {cost_of(ri2):.6e} "
                      f"f_diff {f_diff:.4e} l_diff {l_diff:.4e} "
                      f"rho {rho:.4f} lam {lam:.2e}")
            if it_summary.step_is_successful:
                ri = ri2
                lam *= max(1.0 / 3, 1.0 - (2.0 * rho - 1.0) ** 3)
                lam = max(min_lambda, lam)
                lambda_vee = options.initial_vee
                it_summary.trust_region_radius = 1.0 / lam
                it_summary.cumulative_time_in_seconds = (
                    time.monotonic() - t_total)
                finish_iteration(summary, it_summary)
                it += 1
                last = summary.iterations[-1]
                change = abs(last.cost_change.all.error
                             if options.optimized_cost == OptimizedCost.ERROR
                             else last.cost_change.valid.error)
                if change <= options.function_tolerance * cost_of(ri):
                    terminated = True
                    summary.termination_type = CONVERGENCE
                    summary.message = "Function tolerance reached."
                it_summary = None
                break
            lin.set_state(*backup)
            lam = lambda_vee * lam
            lambda_vee *= options.vee_factor
            it_summary.step_is_successful = False
            it_summary.trust_region_radius = 1.0 / lam
            it_summary.cumulative_time_in_seconds = (
                time.monotonic() - t_total)
            finish_iteration(summary, it_summary)
            it += 1
            it_summary = None
            if lam > max_lambda:
                terminated = True
                summary.termination_type = NO_CONVERGENCE
                summary.message = ("Solver did not converge and reached "
                                   f"maximum damping {max_lambda}")

    if not terminated:
        summary.termination_type = NO_CONVERGENCE
        summary.message = (f"Solver did not converge after maximum "
                           f"number of {max_it} iterations")

    problem.cam_q[:] = lin.q
    problem.cam_t[:] = lin.t
    problem.cam_intr[:] = lin.intr
    problem.lm_p[:] = lin.lm_p
    summary.total_time_in_seconds = time.monotonic() - t_total
    summary.minimizer_time_in_seconds = summary.total_time_in_seconds
    finish_solve(summary, "bal_numpy_lm")
    return summary
