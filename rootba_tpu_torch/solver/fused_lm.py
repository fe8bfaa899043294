"""The attempt-loop LM driver (up to fused_obs_threshold observations;
solver/lm.optimize_lm is the host driver above it).

Port of the JAX package's `solver/fused_lm.py`, whose whole minimization
is one device program (a `lax.while_loop` over LM attempts). Here the
loop is in Python and each attempt keeps that body's semantics
(build_fused_lm, fused_lm.py:155-237 there; the reference minimizer,
bal_bundle_adjustment.cpp:249-544):

  * linearize, solve(lambda), apply and evaluate the cost;
  * rho = f_diff / l_diff; the step is valid when the increment, l_diff
    and the new cost are finite and l_diff > 0, successful when also
    rho > min_relative_decrease;
  * on success lambda *= max(1/3, 1 - (2 rho - 1)^3) (>= min_lambda) and
    vee resets; on reject lambda *= vee and vee *= vee_factor;
  * termination on the function tolerance, lambda > max_lambda or the
    iteration cap.

The JAX loop relinearizes on every attempt (bit-identical values while
backtracking); this loop reuses the linearization of a rejected attempt,
which gives the same values. The attempt body is
`LinearizerBase.attempt_at` (solver/lm.py), which the host driver runs
too. It reads a handful of scalars back to the host in one transfer per
attempt (pcg in solver/cg.py adds a read per CG iteration and syncs of
its own; every sync of an attempt is a "sync.*" span of log/trace.py).
That read also timestamps the attempt, so per-iteration times are
measured (timing_attributed=False). The
per-stage split comes from CUDA events recorded at the stage boundaries
and read after the sync (the host clock on the CPU), so it adds no sync
of its own.
Decision arithmetic runs in Python floats (float64), as the JAX loop's
with x64 enabled.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass, field, fields
from typing import List, Optional

import torch

from rootba_tpu_torch.config.options import OptimizedCost, SolverOptions
from rootba_tpu_torch.core.residuals import residual_info_to_host
from rootba_tpu_torch.log import trace
from rootba_tpu_torch.log.summary import (
    CONVERGENCE,
    NO_CONVERGENCE,
    IterationSummary,
    ResidualInfoHost,
    ResidualItemHost,
    SolverSummary,
    error_summary_oneline,
    finish_iteration,
    finish_solve,
)
from rootba_tpu_torch.parallel.mesh import make_mesh

TERM_RUNNING = 0
TERM_FTOL = 1
TERM_MAX_LAMBDA = 2


@dataclass
class IterLog:
    """Per-attempt log records (the JAX loop's IterLog fields)."""

    step_is_valid: List[bool] = field(default_factory=list)
    step_is_successful: List[bool] = field(default_factory=list)
    cost_all_error: List[float] = field(default_factory=list)
    cost_all_rsum: List[float] = field(default_factory=list)
    cost_all_nobs: List[int] = field(default_factory=list)
    cost_valid_error: List[float] = field(default_factory=list)
    cost_valid_rsum: List[float] = field(default_factory=list)
    cost_valid_nobs: List[int] = field(default_factory=list)
    trust_region_radius: List[float] = field(default_factory=list)
    cg_iters: List[int] = field(default_factory=list)
    relative_decrease: List[float] = field(default_factory=list)
    l_diff: List[float] = field(default_factory=list)

    def append(self, ri: ResidualInfoHost, **kw):
        kw.update(cost_all_error=ri.all.error,
                  cost_all_rsum=ri.all.residual_sum,
                  cost_all_nobs=ri.all.num_obs,
                  cost_valid_error=ri.valid.error,
                  cost_valid_rsum=ri.valid.residual_sum,
                  cost_valid_nobs=ri.valid.num_obs)
        for f in fields(self):
            getattr(self, f.name).append(kw[f.name])


def _cost_scalar(ri: ResidualInfoHost, opt_cost) -> float:
    if opt_cost == OptimizedCost.ERROR:
        return ri.all.error
    if opt_cost == OptimizedCost.ERROR_VALID:
        return ri.valid.error
    return ri.valid.error_avg


def _ftol_value(ri: ResidualInfoHost, opt_cost) -> float:
    """The cost the function tolerance compares
    (bal_bundle_adjustment.cpp:174-201)."""
    return ri.all.error if opt_cost == OptimizedCost.ERROR else ri.valid.error


class _StageClock:
    """Per-stage spans of one attempt without a sync of their own. On the
    card each stage boundary records a CUDA event, and `spans` (called
    after a sync that covers the last boundary) reads the device time
    between consecutive events; on the CPU, whose ops run synchronously,
    the boundaries are host clock readings. While the recorder
    (log/trace.py) is on, each lap also records the host span since the
    previous one as "lm.<name>", unless `spans` is False."""

    def __init__(self, device: torch.device, spans: bool = True):
        self.cuda = device.type == "cuda"
        self.t0 = time.monotonic()
        self._host = self.t0 if spans else None
        self.marks = [("start", self._mark())]

    def _mark(self):
        if not self.cuda:
            return time.monotonic()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def lap(self, name: str):
        self.marks.append((name, self._mark()))
        if self._host is not None:
            self._host = trace.since("lm." + name, self._host)

    def spans(self) -> dict:
        out = {}
        for (_, a), (name, b) in zip(self.marks, self.marks[1:]):
            out[name] = a.elapsed_time(b) / 1e3 if self.cuda else b - a
        return out


def optimize_lm_fused(bp, options: SolverOptions,
                      summary: Optional[SolverSummary] = None, *,
                      device: torch.device, linearizer=None, state=None):
    """Run the LM minimization on `device`, sharded over the mesh of
    options.num_devices (parallel.mesh.make_mesh: none without a process
    group) with `bp`'s rows padded to it. Pass `linearizer` (and a
    starting `state`, sharded as its mesh) to reuse one already built.
    Returns (BAState, SolverSummary)."""
    from rootba_tpu_torch.solver.lm import (
        BAState,
        create_linearizer,
        initial_state,
    )

    if summary is None:
        summary = SolverSummary()
    verbose = options.verbosity_level >= 2
    opt_cost = options.optimized_cost
    min_lambda = 1.0 / options.max_trust_region_radius
    max_lambda = 1.0 / options.min_trust_region_radius
    max_it = options.max_num_iterations

    t_total = time.monotonic()
    dtype = torch.float64 if options.use_double else torch.float32
    if linearizer is None:
        linearizer = create_linearizer(
            bp, options, dtype, device,
            make_mesh(options.num_devices, device))
    if state is None:
        state = initial_state(bp, dtype, device, linearizer.mesh)
    cams, lm_ps = state.cams, state.lm_ps
    summary.preprocessor_time_in_seconds = time.monotonic() - t_total

    t_min = time.monotonic()
    ri = residual_info_to_host(linearizer.error(cams, lm_ps))
    logs = IterLog()
    lam = 1.0 / options.initial_trust_region_radius
    vee = options.initial_vee
    logs.append(ri, step_is_valid=True, step_is_successful=True,
                trust_region_radius=1.0 / lam, cg_iters=0,
                relative_decrease=0.0, l_diff=0.0)
    it_times = [time.monotonic() - t_min]
    spans: List[dict] = [{"err": it_times[0]}]

    n_jac, n_res, n_sol = 0, 1, 0
    term = TERM_RUNNING
    it = 1
    lins = pose_scale = None
    while it <= max_it and term == TERM_RUNNING:
        with trace.span("lm.attempt"):
            clock = _StageClock(device)
            if lins is None:
                lins, pose_scale, _ = linearizer.stage1(cams, lm_ps)
                n_jac += 1
                clock.lap("stage1")
            a = linearizer.attempt_at(cams, lm_ps, lins, pose_scale, lam,
                                      clock)
        it_times.append(time.monotonic() - clock.t0)
        ri2, l_diff, inc_finite = a.ri2, a.l_diff, a.inc_finite
        cg_iters = a.cg_iters

        f_diff = _cost_scalar(ri, opt_cost) - _cost_scalar(ri2, opt_cost)
        l_eff = l_diff
        if opt_cost == OptimizedCost.ERROR_VALID_AVG:
            l_eff = l_eff / max(ri.valid.num_obs, 1)
        quality = f_diff / (1.0 if l_eff == 0 else l_eff)
        step_valid = (inc_finite and math.isfinite(l_diff)
                      and ri2.is_numerically_valid and l_eff > 0)
        success = step_valid and quality > options.min_relative_decrease

        # trust-region update (bal_bundle_adjustment.cpp:462-466 on
        # success, :499-500 on reject); the cube by multiplication
        # (float ** raises on overflow)
        t3 = 2.0 * quality - 1.0
        factor = max(1.0 / 3.0, 1.0 - t3 * t3 * t3)
        lam_new = max(min_lambda, lam * factor) if success else vee * lam
        vee = options.initial_vee if success else vee * options.vee_factor

        change = abs(_ftol_value(ri, opt_cost) - _ftol_value(ri2, opt_cost))
        if success and (change <= options.function_tolerance
                        * _ftol_value(ri2, opt_cost)):
            term = TERM_FTOL
        elif not success and lam_new > max_lambda:
            term = TERM_MAX_LAMBDA

        logs.append(ri2, step_is_valid=step_valid,
                    step_is_successful=success,
                    trust_region_radius=1.0 / lam_new, cg_iters=cg_iters,
                    relative_decrease=quality if step_valid else 0.0,
                    l_diff=l_diff)
        if success:
            cams, lm_ps, ri = a.cams, a.lm_ps, ri2
            lins = None  # new linearization point
        lam = lam_new
        it += 1
        n_res += 1
        n_sol += 1
        spans.append(clock.spans())
        if verbose:
            tag = ("Success" if success
                   else ("Reject" if step_valid else "Invalid"))
            print(f"Iteration {it - 1}, error: {ri2.all.error:.8e} "
                  f"[{tag}] tr={1.0 / lam_new:.1e} cg_iter={cg_iters}",
                  flush=True)
    minimizer_time = time.monotonic() - t_min

    # ---- SolverSummary (fields as the JAX loop reconstructs them) ----
    summary.num_linear_solves = n_sol
    summary.num_residual_evaluations = n_res
    summary.num_jacobian_evaluations = n_jac
    cum = summary.preprocessor_time_in_seconds
    for i in range(len(logs.cg_iters)):
        its = IterationSummary(iteration=i)
        its.step_is_valid = logs.step_is_valid[i]
        its.step_is_successful = logs.step_is_successful[i]
        its.cost = ResidualInfoHost(
            all=ResidualItemHost(num_obs=logs.cost_all_nobs[i],
                                 error=logs.cost_all_error[i],
                                 residual_sum=logs.cost_all_rsum[i]),
            valid=ResidualItemHost(num_obs=logs.cost_valid_nobs[i],
                                   error=logs.cost_valid_error[i],
                                   residual_sum=logs.cost_valid_rsum[i]))
        its.trust_region_radius = logs.trust_region_radius[i]
        its.linear_solver_iterations = logs.cg_iters[i]
        its.linear_solver_type = linearizer.linear_solver_type
        its.relative_decrease = logs.relative_decrease[i]
        s = spans[i]
        its.stage1_time_in_seconds = s.get("stage1", 0.0)
        its.jacobian_evaluation_time_in_seconds = s.get("stage1", 0.0)
        setattr(its, linearizer.prepare_field, s.get("stage2", 0.0))
        its.solve_reduced_system_time_in_seconds = s.get("lsolve", 0.0)
        its.back_substitution_time_in_seconds = s.get("bsub", 0.0)
        its.residual_evaluation_time_in_seconds = s.get("err", 0.0)
        its.iteration_time_in_seconds = it_times[i]
        cum += it_times[i]
        its.cumulative_time_in_seconds = cum
        its.timing_attributed = False
        finish_iteration(summary, its)

    if term == TERM_FTOL:
        summary.termination_type = CONVERGENCE
        summary.message = "Function tolerance reached."
    elif term == TERM_MAX_LAMBDA:
        summary.termination_type = NO_CONVERGENCE
        summary.message = (f"Solver did not converge and reached maximum "
                           f"damping lambda of {max_lambda}")
    else:
        summary.termination_type = NO_CONVERGENCE
        summary.message = (f"Solver did not converge after maximum number "
                           f"of {max_it} iterations")
    summary.minimizer_time_in_seconds = minimizer_time
    summary.total_time_in_seconds = time.monotonic() - t_total
    summary.num_threads_given = options.num_threads
    summary.num_threads_used = 1
    finish_solve(summary, linearizer.linear_solver_type)
    if verbose:
        print(f"Final Cost: "
              f"{error_summary_oneline(summary.final_cost, options.use_projection_validity_check())}")
        print(f"{summary.termination_type}: {summary.message}")
    return BAState(cams=cams, lm_ps=lm_ps), summary
