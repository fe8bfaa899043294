"""Solver state, the linearizer facade, the host LM driver and
`bundle_adjust`.

Port of the JAX package's `solver/lm.py` for the main path: the state
(cameras + per-bucket landmark positions), the bucket index upload,
the linearizer base with the host driver's stage calls, the lazy
camera-CSR index and the stage1 of the bucket layout
(`_stage1_common`), the einsum layout's SQUARE_ROOT solver
(`SqrtLinearizer`, solver/sqrt_qr.py), `create_linearizer` (SQUARE_ROOT
on the flat layout, or the einsum layout when asked for and under a
mesh; SCHUR_COMPLEMENT and POWER_SCHUR_COMPLEMENT in
solver/explicit_sc.py), the host LM loop `optimize_lm` with its
checkpoint/resume (utils/checkpoint.py) and `bundle_adjust`, which
routes a problem to it or to the attempt-loop driver
(solver/fused_lm.py), or for solver_type CERES to the host baselines
(solver/numpy_lm.py, solver/scipy_baseline.py).

Under a process group (parallel/mesh.py) `bundle_adjust` pads every
bucket's landmark rows to the mesh, each rank's linearizer keeps its
block of them, and the final landmarks are gathered to every rank; the
checkpoint gathers too, rank 0 writes it, and the ranks agree that it
exists before they resume.
`state_from_numpy` / `state_to_numpy` carry a state across the two
packages as numpy arrays.

The host loop keeps the reference minimizer's control flow
(optimize_lm_ours, bal_bundle_adjustment.cpp:249-544): an outer loop
per linearization point, backtracking attempts inside it that reuse the
linearization, lambda *= max(1/3, 1 - (2 rho - 1)^3) on success and
lambda *= vee on reject, and termination on the function tolerance,
lambda > max_lambda or the iteration cap.

One attempt body serves both drivers: `LinearizerBase.attempt_at`
runs stage2, the linear solve, apply and the cost evaluation and reads
their scalars back in one host transfer (the attempt's only sync), as
the JAX host driver's one-dispatch attempt does. Every stage span is
timed by CUDA events at the stage boundaries (fused_lm._StageClock),
read after that sync, so every iteration has measured stage fields and
timing_attributed=False. The JAX driver's calibration attempts, its
split of a dispatch's total by calibration fractions and its deferred
stage1 sync exist only for that split and are not ported (nor their
options host_fused_attempt, timing_calibration_interval and
defer_stage_sync); timing_mode="measured" routes to this loop.

Not ported: the JAX driver's capacity ladder (degrading "full" to
"half" to separate dispatches on compile-size errors) and its transient
retry of compile-service errors. Eager PyTorch compiles nothing, so a
degrade after torch.cuda.OutOfMemoryError would run the same
allocations and fail again; every error propagates with its cause.
"""

from __future__ import annotations

import math
import os
import time
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from rootba_tpu_torch.bal.bucketing import (
    BucketedProblem,
    bucketize,
    scatter_landmarks,
)
from rootba_tpu_torch.bal.problem import BalProblem, PipelineTimingSummary
from rootba_tpu_torch.config.options import (
    OptimizedCost,
    PreconditionerType,
    RobustNorm,
    SolverOptions,
    SolverType,
)
from rootba_tpu_torch.core import lie
from rootba_tpu_torch.ops.block9 import chol9_inv, inv9_apply
from rootba_tpu_torch.core.residuals import (
    residual_info_from_values,
    residual_info_to_host,
    residual_info_vector,
)
from rootba_tpu_torch.log.summary import (
    CONVERGENCE,
    NO_CONVERGENCE,
    IterationSummary,
    ResidualInfoHost,
    SolverSummary,
    error_summary_oneline,
    finish_iteration,
    finish_solve,
)
from rootba_tpu_torch.parallel.mesh import (
    LandmarkMesh,
    all_reduce_sum,
    gather_to_host,
    host_all_reduce,
    make_mesh,
    pad_rows_for_mesh,
    shard_bucket_index,
    shard_state,
)
from rootba_tpu_torch.solver import sqrt_qr
from rootba_tpu_torch.solver.cg import pcg
from rootba_tpu_torch.solver.fused_lm import _cost_scalar, _StageClock
from rootba_tpu_torch.solver.linearization import (
    BucketIndex,
    CamState,
    compute_error_buckets,
)
from rootba_tpu_torch.utils import checkpoint


class BAState(NamedTuple):
    cams: CamState
    lm_ps: Tuple[torch.Tensor, ...]


def _sophus_eps_sqrt(dtype: torch.dtype) -> float:
    """Sophus::Constants<Scalar>::epsilonSqrt() as used by
    get_effective_jacobi_scaling_epsilon (linearizor_base.cpp:73-79)."""
    return 1e-5 if dtype == torch.float64 else math.sqrt(1e-5)


def make_bucket_indices(bp: BucketedProblem, dtype: torch.dtype,
                        device: torch.device,
                        mesh: Optional[LandmarkMesh] = None
                        ) -> Tuple[BucketIndex, ...]:
    """The buckets' index tensors on `device`; under a mesh only this
    rank's landmark rows are uploaded."""
    out = []
    for b in bp.buckets:
        h = shard_bucket_index(BucketIndex(
            obs_uv=b.obs_uv, cam_idx=b.cam_idx.astype(np.int64),
            mask=b.mask, lm_mask=b.lm_mask), mesh)
        out.append(BucketIndex(
            obs_uv=torch.as_tensor(h.obs_uv, dtype=dtype, device=device),
            cam_idx=torch.as_tensor(h.cam_idx, device=device),
            mask=torch.as_tensor(h.mask, device=device),
            lm_mask=torch.as_tensor(h.lm_mask, device=device)))
    return tuple(out)


def state_from_numpy(arrays: Dict, dtype: torch.dtype,
                     device: torch.device) -> BAState:
    """BAState from numpy arrays {'q': [N,4], 't': [N,3], 'intr': [N,3],
    'lm_ps': per-bucket [L,3]} -- the same arrays the JAX package's
    state holds (CamState q/t/intr and the per-bucket lm_ps)."""
    def up(a):  # a copy: the source arrays may be read-only views
        return torch.tensor(np.asarray(a), dtype=dtype, device=device)

    return BAState(cams=CamState(q=up(arrays["q"]), t=up(arrays["t"]),
                                 intr=up(arrays["intr"])),
                   lm_ps=tuple(up(p) for p in arrays["lm_ps"]))


def state_to_numpy(state: BAState) -> Dict:
    """Inverse of state_from_numpy (arrays keep the state's dtype)."""
    def down(t):
        return t.detach().cpu().numpy()

    return {"q": down(state.cams.q), "t": down(state.cams.t),
            "intr": down(state.cams.intr),
            "lm_ps": [down(p) for p in state.lm_ps]}


def initial_state(bp: BucketedProblem, dtype: torch.dtype,
                  device: torch.device,
                  mesh: Optional[LandmarkMesh] = None) -> BAState:
    """The problem's starting state (under a mesh, this rank's landmark
    rows)."""
    return shard_state(state_from_numpy(
        {"q": bp.cam_q0, "t": bp.cam_t0, "intr": bp.cam_intr0,
         "lm_ps": bp.lm_p0}, dtype, device), mesh)


class Attempt(NamedTuple):
    """One LM attempt's result: the state after the increment, l_diff,
    the cost there, whether the increment was finite, and the linear
    solve's iterations and termination code."""

    cams: CamState
    lm_ps: Tuple[torch.Tensor, ...]
    l_diff: float
    ri2: ResidualInfoHost
    inc_finite: bool
    cg_iters: int
    cg_term: int


class LinearizerBase:
    """Facade of a manual solver (reference solver/linearizor.hpp:47-83).

    A subclass's _build sets up its structures; it provides the stages
      error(cams, lm_ps) -> ResidualInfo
      stage1(cams, lm_ps) -> (lins, pose_scale, failures)
      stage2(lins, lam) -> aux          [damping/RHS/preconditioner/RCS]
      lsolve(lins, aux) -> (inc, stage2, cg_iters, cg_term)
      apply(cams, lm_ps, lins, stage2, pose_scale, inc)
          -> (cams, lm_ps, l_diff)
    All run on `device`; nothing is compiled or cached between calls.
    Under a mesh (parallel.mesh.LandmarkMesh) the buckets and the
    landmark positions hold this rank's landmark rows, the camera CSR is
    off (its gather would cross the ranks' rows), and every sum over
    landmarks is all-reduced: the stages return replicated camera
    quantities.

    The base adds `attempt_at`, the attempt body of both LM drivers,
    and the host driver's calls on the linearizer's own state
    (set_state): linearize, compute_error and attempt, which count the
    solver summary's linear solves and residual and Jacobian
    evaluations and time the iteration's stage fields."""

    linear_solver_type = "?"
    # the iteration field that the stage2 span is logged into: the QR
    # solver logs it as stage2_time (linearizor_qr.cpp), the SC/PoBA
    # solvers as prepare_time (linearizor_sc.cpp)
    prepare_field = "stage2_time_in_seconds"

    def __init__(self, bp: BucketedProblem, options: SolverOptions,
                 dtype: torch.dtype, device: torch.device,
                 mesh: Optional[LandmarkMesh] = None):
        self.options = options
        self.dtype = dtype
        self.device = device
        self.mesh = mesh
        self.num_cameras = bp.num_cameras
        self.bp = bp  # host-side structure (index builders read it)
        self.buckets = make_bucket_indices(bp, dtype, device, mesh)
        # camera-CSR gather-reduce index (replaces segment_sum scatters
        # with a fixed-order sum; see bucketing.CamCsr), uploaded on
        # first access: only the paths that reduce through it pay its
        # host build. Only without a mesh: the CSR gathers slots of
        # every rank's rows, so a mesh keeps segment sums (the JAX
        # package's rule)
        self._cam_csr_cache = None
        self._cam_csr_enabled = (mesh is None
                                 and options.reduction_alg != 0)
        self.robust_norm = (1 if options.residual.robust_norm
                            == RobustNorm.HUBER else 0)
        self.huber = float(options.residual.huber_parameter)
        eps = options.jacobi_scaling_epsilon
        self.jacobi_eps = float(eps) if eps > 0 else _sophus_eps_sqrt(dtype)
        # compensated f32 accumulation for the cancellation-prone sums
        # (CG dots, l_diff); f64 needs none
        self.compensated = (bool(options.compensated_accumulation)
                            and dtype == torch.float32)
        self.state: Optional[BAState] = None
        self.it_summary: Optional[IterationSummary] = None
        self.summary: Optional[SolverSummary] = None
        self._build()

    def _build(self):
        raise NotImplementedError

    @property
    def cam_csr(self):
        """The CamCsrIndex of the problem, or None under
        reduction_alg=0 (or once set to None)."""
        if not self._cam_csr_enabled:
            return None
        if self._cam_csr_cache is None:
            from rootba_tpu_torch.solver.linearization import CamCsrIndex

            self._cam_csr_cache = CamCsrIndex.from_host(self.bp.cam_csr,
                                                        self.device)
        return self._cam_csr_cache

    @cam_csr.setter
    def cam_csr(self, v):
        if v is None:
            self._cam_csr_enabled = False
        else:
            self._cam_csr_cache = v
            self._cam_csr_enabled = True

    def _stage1_common(self, buckets, cams, lm_ps, csr=None):
        """Linearize all buckets in the bucket layout, Jl column
        scaling, pose jacobi scaling (the stage1 of the SC/PoBA solvers
        and of the einsum layout); under a mesh diag2 and the failure
        count are all-reduced."""
        from rootba_tpu_torch.solver.linearization import (
            POSE_SIZE,
            csr_cam_reduce,
            jp_diag2,
            linearize_bucket,
            scale_jl_cols,
            scale_jp_cols,
        )

        lins = []
        diag2 = torch.zeros((self.num_cameras, POSE_SIZE), dtype=self.dtype,
                            device=self.device)
        diag2_rows = []
        failures = torch.zeros((), dtype=torch.int64, device=self.device)
        for lm_p, bucket in zip(lm_ps, buckets):
            lin, nfail = linearize_bucket(
                cams, lm_p, bucket, self.robust_norm, self.huber,
                self.options.use_projection_validity_check())
            lin = scale_jl_cols(lin, self.jacobi_eps)
            if csr is not None:
                diag2_rows.append(torch.sum(lin.Jp * lin.Jp, dim=-2)
                                  .reshape(-1, POSE_SIZE))
            else:
                diag2 = diag2 + jp_diag2(lin, bucket.cam_idx,
                                         self.num_cameras)
            failures = failures + nfail
            lins.append(lin)
        if csr is not None:
            diag2 = csr_cam_reduce(diag2_rows, csr, self.num_cameras)
        diag2 = all_reduce_sum(diag2, self.mesh)
        failures = all_reduce_sum(failures, self.mesh)
        if self.options.jacobi_scaling:
            pose_scale = 1.0 / (self.jacobi_eps + torch.sqrt(diag2))
        else:
            pose_scale = torch.ones_like(diag2)
        lins = tuple(scale_jp_cols(lin, bucket.cam_idx, pose_scale)
                     for lin, bucket in zip(lins, buckets))
        return lins, pose_scale, failures

    def attempt_at(self, cams: CamState, lm_ps, lins, pose_scale,
                   lam: float, clock: _StageClock) -> Attempt:
        """One LM attempt at a linearization: stage2(lam), the linear
        solve, apply of the increment (as it is: a caller discards the
        state of an increment that is not finite) and the cost at the
        new state, with one host read of their scalars. `clock` gets a
        lap at each stage boundary."""
        lam_t = torch.full((), lam, dtype=self.dtype, device=self.device)
        aux = self.stage2(lins, lam_t)
        clock.lap("stage2")
        inc, stage2, cg_iters, cg_term = self.lsolve(lins, aux)
        del aux  # the assembled system is not kept past its solve
        inc_finite = torch.all(torch.isfinite(inc))
        clock.lap("lsolve")
        cams2, lm_ps2, l_diff = self.apply(cams, lm_ps, lins, stage2,
                                           pose_scale, inc)
        clock.lap("bsub")
        info2 = self.error(cams2, lm_ps2)
        clock.lap("err")
        # the attempt's one sync: cost, l_diff, finiteness, the CG count
        # and termination
        *v, l_diff, inc_finite, cg_iters, cg_term = torch.cat([
            residual_info_vector(info2), torch.stack([
                torch.as_tensor(x, device=self.device).to(torch.float64)
                for x in (l_diff, inc_finite, cg_iters, cg_term)])
        ]).tolist()
        return Attempt(cams=cams2, lm_ps=lm_ps2, l_diff=l_diff,
                       ri2=residual_info_from_values(v),
                       inc_finite=bool(inc_finite), cg_iters=int(cg_iters),
                       cg_term=int(cg_term))

    # -- the host driver's calls ---------------------------------------
    def set_state(self, state: BAState):
        self.state = state

    def start_iteration(self, it_summary: IterationSummary):
        self.it_summary = it_summary

    def finish_iteration(self):
        pass

    def compute_error(self) -> ResidualInfoHost:
        clock = _StageClock(self.device)
        info = self.error(self.state.cams, self.state.lm_ps)
        clock.lap("err")
        ri = residual_info_to_host(info)
        if self.it_summary is not None:
            self.it_summary.residual_evaluation_time_in_seconds += (
                clock.spans()["err"])
        if self.summary is not None:
            self.summary.num_residual_evaluations += 1
        return ri

    def linearize(self):
        """stage1 at the current state; raises FloatingPointError when
        it counts numerical failures."""
        clock = _StageClock(self.device)
        lins, pose_scale, failures = self.stage1(self.state.cams,
                                                 self.state.lm_ps)
        clock.lap("stage1")
        n = int(failures)
        if n > 0:
            raise FloatingPointError(f"numerical failure during "
                                     f"linearization ({n} observations)")
        its = self.it_summary
        if its is not None:
            its.stage1_time_in_seconds = clock.spans()["stage1"]
            # the reference reports jacobian evaluation as the stage1
            # body (linearizor_qr.cpp)
            its.jacobian_evaluation_time_in_seconds = (
                its.stage1_time_in_seconds)
        self._lins = lins
        self._pose_scale = pose_scale
        if self.summary is not None:
            self.summary.num_jacobian_evaluations += 1

    def attempt(self, lam: float) -> Attempt:
        """attempt_at the current state and linearization, counted and
        timed into the iteration; the caller decides whether to
        set_state the attempt's state."""
        clock = _StageClock(self.device)
        a = self.attempt_at(self.state.cams, self.state.lm_ps, self._lins,
                            self._pose_scale, lam, clock)
        spans = clock.spans()
        its = self.it_summary
        if its is not None:
            setattr(its, self.prepare_field, spans["stage2"])
            its.solve_reduced_system_time_in_seconds = spans["lsolve"]
            its.back_substitution_time_in_seconds = spans["bsub"]
            its.residual_evaluation_time_in_seconds += spans["err"]
            its.linear_solver_iterations = a.cg_iters
            its.linear_solver_message = (f"cg_term={a.cg_term} "
                                         f"iters={a.cg_iters}")
            its.linear_solver_type = self.linear_solver_type
        if self.summary is not None:
            self.summary.num_linear_solves += 1
            self.summary.num_residual_evaluations += 1
        return a


class SqrtLinearizer(LinearizerBase):
    """SQUARE_ROOT solver in the einsum (bucket) layout (reference
    solver/linearizor_qr.cpp; the JAX package's SqrtLinearizer): stage1
    is `_stage1_common`, stage2 / the matvec / back substitution are
    solver/sqrt_qr.py, the linear solve pcg under the JACOBI,
    SCHUR_JACOBI or DIAGONAL block preconditioner. The layout of every
    mesh."""

    linear_solver_type = "bal_qr"

    def _build(self):
        opts = self.options
        if opts.preconditioner_type not in (
                PreconditionerType.JACOBI, PreconditionerType.SCHUR_JACOBI,
                PreconditionerType.DIAGONAL):
            raise ValueError(
                f"preconditioner {opts.preconditioner_type} not implemented "
                f"for the SQUARE_ROOT solver")
        self.precond_jacobi = (opts.preconditioner_type
                               == PreconditionerType.JACOBI)
        self.precond_diag = (opts.preconditioner_type
                             == PreconditionerType.DIAGONAL)

    def error(self, cams, lm_ps):
        return compute_error_buckets(cams, lm_ps, self.buckets,
                                     self.robust_norm, self.huber,
                                     mesh=self.mesh)

    def stage1(self, cams, lm_ps):
        return self._stage1_common(self.buckets, cams, lm_ps,
                                   csr=self.cam_csr)

    def stage2(self, lins, lam):
        return sqrt_qr.sqrt_stage2(
            lins, self.buckets, lam, self.num_cameras,
            precond_jacobi=self.precond_jacobi,
            precond_diagonal=self.precond_diag, mesh=self.mesh)

    def lsolve(self, lins, stage2):
        opts = self.options
        csr = self.cam_csr

        def matvec(x):
            return sqrt_qr.sqrt_matvec(lins, self.buckets, stage2,
                                       self.num_cameras, x, csr=csr,
                                       mesh=self.mesh)

        # explicit per-block inverse once per solve (ops/block9)
        pinv = chol9_inv(stage2.precond_chol)
        res = pcg(matvec, lambda r: inv9_apply(pinv, r), stage2.b,
                  min_num_iterations=opts.min_linear_solver_iterations,
                  max_num_iterations=opts.max_linear_solver_iterations,
                  q_tolerance=opts.eta, r_tolerance=-1.0,
                  compensated=self.compensated)
        # we solve H(-x) = b -> negate (linearizor_base.cpp:99-101)
        return -res.x, stage2, res.num_iterations, res.termination_type

    def apply(self, cams: CamState, lm_ps, lins, stage2, pose_scale, inc):
        new_lm_ps, l_diff = sqrt_qr.sqrt_back_substitute(
            lins, self.buckets, stage2, lm_ps, inc,
            compensated=self.compensated, mesh=self.mesh)
        inc_scaled = inc * pose_scale
        q, t = lie.apply_inc_pose(cams.q, cams.t, inc_scaled[:, :6])
        intr = cams.intr + inc_scaled[:, 6:9]
        return CamState(q=q, t=t, intr=intr), new_lm_ps, l_diff


def create_linearizer(bp: BucketedProblem, options: SolverOptions,
                      dtype: torch.dtype, device: torch.device,
                      mesh: Optional[LandmarkMesh] = None):
    """The linearizer of options.solver_type (the JAX package's
    dispatch): SQUARE_ROOT on the flat layout without a mesh, else in
    the einsum layout; SC and PoBA in the bucket layout."""
    if options.solver_type == SolverType.SQUARE_ROOT:
        if options.kernel_layout not in ("flat", "einsum"):
            raise ValueError(
                f"unknown kernel_layout {options.kernel_layout!r} "
                f"(choose 'flat' or 'einsum'; the round-1 experimental "
                f"'cm'/'planar' layouts were retired)")
        if options.kernel_layout == "flat" and mesh is None:
            from rootba_tpu_torch.solver.sqrt_flat import FlatSqrtLinearizer

            return FlatSqrtLinearizer(bp, options, dtype, device)
        return SqrtLinearizer(bp, options, dtype, device, mesh)
    if options.solver_type == SolverType.SCHUR_COMPLEMENT:
        from rootba_tpu_torch.solver.explicit_sc import SCLinearizer

        return SCLinearizer(bp, options, dtype, device, mesh)
    if options.solver_type == SolverType.POWER_SCHUR_COMPLEMENT:
        from rootba_tpu_torch.solver.explicit_sc import PowerSCLinearizer

        return PowerSCLinearizer(bp, options, dtype, device, mesh)
    # CERES is bundle_adjust's host baseline, not a linearizer
    raise ValueError(f"unknown solver type {options.solver_type}")


def _function_tolerance_reached(it: IterationSummary,
                                options: SolverOptions):
    """Reference bal_bundle_adjustment.cpp:174-201."""
    if options.optimized_cost == OptimizedCost.ERROR:
        cost = it.cost.all.error
        change = abs(it.cost_change.all.error)
    else:
        cost = it.cost.valid.error
        change = abs(it.cost_change.valid.error)
    if change <= options.function_tolerance * cost:
        return True, (f"Function tolerance reached. |cost_change|/cost: "
                      f"{change / cost if cost else 0.0} <= "
                      f"{options.function_tolerance}")
    return False, ""


def optimize_lm(bp: BucketedProblem, options: SolverOptions,
                summary: Optional[SolverSummary] = None, *,
                device: torch.device, linearizer=None,
                iteration_callback=None) -> Tuple[BAState, SolverSummary]:
    """The host LM minimizer (reference optimize_lm_ours,
    bal_bundle_adjustment.cpp:249-544) on `device`, sharded over the
    mesh of options.num_devices (parallel.mesh.make_mesh: none without a
    process group) with `bp`'s rows padded to it.

    Pass `linearizer` to reuse one already built (with its mesh; the
    solve starts from the problem's initial state, or from
    options.checkpoint_path when that file exists).
    `iteration_callback(it, state, summary)` fires after every LM
    iteration; an exception in it aborts the solve.
    With checkpoint_interval > 0 the state is written to
    checkpoint_path after the callback of every checkpoint_interval-th
    iteration."""
    if summary is None:
        summary = SolverSummary()
    verbose = options.verbosity_level >= 2
    timer_total = time.monotonic()
    dtype = torch.float64 if options.use_double else torch.float32

    min_lambda = 1.0 / options.max_trust_region_radius
    max_lambda = 1.0 / options.min_trust_region_radius
    vee_factor = options.vee_factor
    initial_vee = options.initial_vee
    max_lm_iter = options.max_num_iterations

    lam = 1.0 / options.initial_trust_region_radius
    lambda_vee = initial_vee

    summary.num_linear_solves = 0
    summary.num_residual_evaluations = 0
    summary.num_jacobian_evaluations = 0

    if linearizer is None:
        mesh = make_mesh(options.num_devices, device)
        if verbose and mesh is not None:
            print(f"Sharding landmark blocks over {mesh.size} ranks")
        linearizer = create_linearizer(bp, options, dtype, device, mesh)
    mesh = linearizer.mesh
    linearizer.summary = summary
    linearizer.set_state(initial_state(bp, dtype, device, mesh))

    # checkpoint/resume (the JAX package's addition; the reference has
    # no mid-solve checkpointing): the state in the solver's dtype on
    # `device`, the damping state, the iteration counter and the log.
    # Under a mesh the save gathers the landmark shards (every rank
    # calls it, rank 0 writes) and a resume re-shards the file's state,
    # so a file written by 1, 2, 4 or 8 ranks (one bucket layout)
    # resumes on any of them
    resume_it = None
    ckpt_path = options.checkpoint_path
    ckpt_interval = options.checkpoint_interval
    if ckpt_path and mesh is not None and mesh.size > 1:
        _agree_checkpoint_exists(ckpt_path, mesh)
    if ckpt_path:
        loaded = checkpoint.load_checkpoint(ckpt_path)
        if loaded is not None:
            cq, ct, ci, lm_ps_np, lam, lambda_vee, resume_it, its = loaded
            linearizer.set_state(shard_state(state_from_numpy(
                {"q": cq, "t": ct, "intr": ci, "lm_ps": lm_ps_np}, dtype,
                device), mesh))
            summary.iterations = [checkpoint.iteration_from_dict(d)
                                  for d in its]
            if verbose:
                print(f"Resumed from checkpoint '{ckpt_path}' at "
                      f"iteration {resume_it} (lambda {lam:.2e})")

    def iteration_done():
        """After every LM iteration: the callback, then the checkpoint
        every checkpoint_interval iterations."""
        if iteration_callback is not None:
            iteration_callback(it, linearizer.state, summary)
        if ckpt_path and ckpt_interval > 0 and it % ckpt_interval == 0:
            checkpoint.save_checkpoint(
                ckpt_path, linearizer.state, lam, lambda_vee, it,
                [checkpoint.iteration_to_dict(s)
                 for s in summary.iterations], mesh=mesh)

    def close_iteration(its, timer_iteration, cum=None):
        linearizer.finish_iteration()
        its.trust_region_radius = 1.0 / lam
        its.iteration_time_in_seconds = time.monotonic() - timer_iteration
        its.cumulative_time_in_seconds = (
            time.monotonic() - timer_total if cum is None else cum)
        finish_iteration(summary, its)

    summary.preprocessor_time_in_seconds = time.monotonic() - timer_total
    timer_minimizer = time.monotonic()

    validity_check = options.use_projection_validity_check()
    # the top-of-loop error is the previous attempt's evaluation of the
    # same state
    ri_cache: Optional[ResidualInfoHost] = None
    terminated = False
    it = resume_it if resume_it is not None else 0
    while it <= max_lm_iter and not terminated:
        it_summary = IterationSummary(iteration=it)
        linearizer.start_iteration(it_summary)
        timer_iteration = time.monotonic()

        if ri_cache is not None:
            ri = ri_cache
        else:
            ri = linearizer.compute_error()
            ri_cache = ri
        if verbose:
            print(f"Iteration {it}, "
                  f"{error_summary_oneline(ri, validity_check)}")
        if not ri.is_numerically_valid:
            raise FloatingPointError(
                "did not expect numerical failure during linearization")

        if it == 0:
            it_summary.cost = ri
            it_summary.step_is_successful = True
            it_summary.step_is_valid = True
            close_iteration(it_summary, timer_iteration)
            it += 1
            iteration_done()
            continue

        linearizer.linearize()

        j = 0
        while it <= max_lm_iter and not terminated:
            if j > 0:
                if verbose:
                    print(f"Iteration {it}, backtracking")
                it_summary = IterationSummary(iteration=it)
                linearizer.start_iteration(it_summary)
                timer_iteration = time.monotonic()
            j += 1

            backup_state = linearizer.state
            a = linearizer.attempt(lam)
            l_diff, ri2 = a.l_diff, a.ri2

            if not a.inc_finite:
                it_summary.step_is_valid = False
                it_summary.step_is_successful = False
                if verbose:
                    print(f"\t[Invalid] Numeric issues when computing "
                          f"increment (contains NaNs), lambda: {lam:.1e}")
                lam = lambda_vee * lam
                lambda_vee *= vee_factor
                close_iteration(it_summary, timer_iteration)
                it += 1
                iteration_done()
                if lam > max_lambda:
                    terminated = True
                    summary.termination_type = NO_CONVERGENCE
                    summary.message = (
                        f"Solver did not converge and reached maximum "
                        f"damping lambda of {max_lambda}")
                continue

            linearizer.set_state(BAState(cams=a.cams, lm_ps=a.lm_ps))
            it_summary.cost = ri2

            if not math.isfinite(l_diff):
                it_summary.step_is_valid = False
                it_summary.step_is_successful = False
                if verbose:
                    print(f"\t[EVAL] failed to apply update: "
                          f"l_diff {l_diff}")
            elif not ri2.is_numerically_valid:
                it_summary.step_is_valid = False
                it_summary.step_is_successful = False
                if verbose:
                    print(f"\t[EVAL] failed to evaluate cost: "
                          f"{error_summary_oneline(ri2, validity_check)}")
            else:
                # bal_bundle_adjustment.cpp:158-172
                f_diff = (_cost_scalar(ri, options.optimized_cost)
                          - _cost_scalar(ri2, options.optimized_cost))
                if options.optimized_cost == OptimizedCost.ERROR_VALID_AVG:
                    l_diff = l_diff / ri.valid.num_obs
                step_quality = f_diff / l_diff if l_diff != 0 else math.inf
                if verbose:
                    print(f"\t[EVAL] f_diff {f_diff:.4e} l_diff "
                          f"{l_diff:.4e} step_quality {step_quality:.4e} "
                          f"ri1 {ri.valid.error:.4e} ri2 "
                          f"{ri2.valid.error:.4e}")
                it_summary.relative_decrease = step_quality
                it_summary.step_is_valid = l_diff > 0
                it_summary.step_is_successful = (
                    it_summary.step_is_valid
                    and step_quality > options.min_relative_decrease)

            cum = time.monotonic() - timer_total
            if it_summary.step_is_successful:
                ri_cache = ri2
                if verbose:
                    print(f"\t[Success] lambda: {lam:.1e}, cg_iter: "
                          f"{it_summary.linear_solver_iterations}, "
                          f"total_time: {cum:.3f}s")
                # the cube by multiplication (float ** raises on overflow)
                t3 = 2.0 * it_summary.relative_decrease - 1.0
                lam *= max(1.0 / 3, 1.0 - t3 * t3 * t3)
                lam = max(min_lambda, lam)
                lambda_vee = initial_vee
                close_iteration(it_summary, timer_iteration, cum)
                it += 1
                iteration_done()
                reached, msg = _function_tolerance_reached(
                    summary.iterations[-1], options)
                if reached:
                    terminated = True
                    summary.termination_type = CONVERGENCE
                    summary.message = msg
                break

            reason = "Reject" if it_summary.step_is_valid else "Invalid"
            if verbose:
                print(f"\t[{reason}] lambda: {lam:.1e}, cg_iter: "
                      f"{it_summary.linear_solver_iterations}, "
                      f"total_time: {cum:.3f}s")
            lam = lambda_vee * lam
            lambda_vee *= vee_factor
            close_iteration(it_summary, timer_iteration, cum)
            linearizer.set_state(backup_state)
            ri_cache = ri
            it += 1
            iteration_done()
            if lam > max_lambda:
                terminated = True
                summary.termination_type = NO_CONVERGENCE
                summary.message = (
                    f"Solver did not converge and reached maximum "
                    f"damping lambda of {max_lambda}")

    if not terminated:
        summary.termination_type = NO_CONVERGENCE
        summary.message = (f"Solver did not converge after maximum number "
                           f"of {max_lm_iter} iterations")

    summary.minimizer_time_in_seconds = time.monotonic() - timer_minimizer
    summary.postprocessor_time_in_seconds = 0.0
    summary.total_time_in_seconds = time.monotonic() - timer_total
    summary.num_threads_given = options.num_threads
    summary.num_threads_used = 1
    finish_solve(summary, linearizer.linear_solver_type)
    if verbose:
        print(f"Final Cost: "
              f"{error_summary_oneline(summary.final_cost, validity_check)}")
        print(f"{summary.termination_type}: {summary.message}")
    return linearizer.state, summary


def _agree_checkpoint_exists(path: str, mesh: LandmarkMesh) -> None:
    """Every rank must see the checkpoint as rank 0 does: a file visible
    on some ranks only would send them down different paths and hang
    the collectives. The ranks' flags meet in one all-reduce, so every
    rank learns rank 0's (the JAX package broadcasts it) and all of them
    raise, with the JAX package's text, when any rank disagrees."""
    flags = np.zeros(mesh.size)
    flags[mesh.rank] = float(os.path.exists(path))
    flags = host_all_reduce(flags, mesh) > 0
    bad = [r for r in range(mesh.size) if flags[r] != flags[0]]
    if bad:
        r = mesh.rank if mesh.rank in bad else bad[0]
        raise FileNotFoundError(
            f"checkpoint '{path}' is visible on process 0: "
            f"{bool(flags[0])} but on process {r}: {bool(flags[r])}; the "
            f"checkpoint path must resolve identically on every host "
            f"(shared filesystem or per-host copy)")


def bundle_adjust(problem: BalProblem,
                  options: Optional[SolverOptions] = None,
                  summary: Optional[SolverSummary] = None,
                  timing: Optional[PipelineTimingSummary] = None,
                  device: str | torch.device = "cuda") -> SolverSummary:
    """Solve a BalProblem in place (reference bundle_adjust_manual,
    bal_bundle_adjustment.cpp:549-...) on `device` (the card unless the
    caller asks for the CPU; under a process group "cuda" is this
    rank's card). Under a process group and options.num_devices 0 or
    the world size, the landmark rows are sharded over the ranks and
    every rank ends with the whole solution. solver_type CERES runs the
    host baselines (numpy / scipy) and touches no device."""
    from rootba_tpu_torch.solver.fused_lm import optimize_lm_fused
    from rootba_tpu_torch.utils.device import resolve_device

    if options is None:
        options = SolverOptions()
    if summary is None:
        summary = SolverSummary()
    if options.solver_type == SolverType.CERES:
        # external-baseline path (the role of the reference's Ceres
        # module, src/rootba/ceres/): 'trf' = scipy least_squares,
        # 'lm' = plain-numpy LM with the reference's exact
        # trust-region protocol (step-comparable trajectories). Host
        # numpy/scipy: no device is resolved, none is needed
        if options.baseline_method == "lm":
            from rootba_tpu_torch.solver.numpy_lm import (
                bundle_adjust_numpy_lm,
            )

            summary = bundle_adjust_numpy_lm(problem, options, summary)
        else:
            from rootba_tpu_torch.solver.scipy_baseline import (
                bundle_adjust_scipy,
            )

            summary = bundle_adjust_scipy(problem, options, summary)
        if timing is not None:
            timing.optimize_time = summary.total_time_in_seconds
        return summary
    device = resolve_device(str(device))
    options.warn_inert_knobs()
    mesh = make_mesh(options.num_devices, device)
    bp = bucketize(problem, pow2_from=options.bucket_pow2_from,
                   row_align=pad_rows_for_mesh(
                       1 if mesh is None else mesh.size))
    # routing as in the JAX package: the attempt loop up to
    # fused_obs_threshold observations, the host driver above it and
    # whenever every stage is to be timed on its own
    lm_loop = options.lm_loop
    if lm_loop == "auto":
        lm_loop = ("fused" if problem.num_observations
                   <= options.fused_obs_threshold else "host")
    if options.timing_mode == "measured":
        lm_loop = "host"
    if lm_loop == "fused":
        state, summary = optimize_lm_fused(bp, options, summary,
                                           device=device)
    else:
        state, summary = optimize_lm(bp, options, summary, device=device)
    # the landmark shards gathered to every rank (cameras are
    # replicated)
    problem.lm_p[:] = scatter_landmarks(
        bp, [gather_to_host(p, mesh).astype(np.float64)
             for p in state.lm_ps])
    problem.cam_q[:] = state.cams.q.cpu().double().numpy()
    problem.cam_t[:] = state.cams.t.cpu().double().numpy()
    problem.cam_intr[:] = state.cams.intr.cpu().double().numpy()
    if timing is not None:
        timing.optimize_time = summary.total_time_in_seconds
    return summary
