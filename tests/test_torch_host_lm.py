"""The host LM driver (`lm_loop="host"`) and the fused-W stream factors
of the port against the JAX package on the CPU, on the conftest problem.

(a) The port's host loop against the JAX host loop, in float32 and
    float64, dense and BSR, iteration by iteration: accept/valid flags,
    CG counts, costs (rel 1e-9 in float64, 1e-4 in float32), the
    termination type and message, and the solver's linear-solve,
    residual- and Jacobian-evaluation counts. float32 stops after 3
    iterations: later its costs sit at rounding level, where accept and
    reject are noise in any two implementations.
(b) The port's host loop against the port's attempt loop (fused_lm).
(c) Every iteration's stage times are measured (timing_attributed is
    False, the stage fields are set); timing_mode="measured" routes to
    the host loop.
(d) A run with rejected steps and a run with an increment that is not
    finite give the JAX package's run and counts; a NaN landmark raises
    in both packages; stage1's failure check.
(e) Fused-W (StreamFactors, forced with _FUSED_W_MIN_BYTES = 0 in both
    packages) against the JAX package's fused-W and the port's
    materialized W: the assembled table, the diagonal blocks and one LM
    step in dense mode and both BSR regimes, at the JAX package's own
    fused-W tolerances (5e-4 float32, 1e-9 float64).
(f) Routing: above fused_obs_threshold, and through the CLI.

Each JAX solve costs seconds of compile, so each is made once in a
module-scoped fixture and several port runs are held against it.
"""

import copy
import json
import os
import re

import numpy as np
import pytest
import torch

from rootba_tpu.bal.bucketing import bucketize as j_bucketize
from rootba_tpu.config.options import SolverOptions as JOptions
from rootba_tpu.solver import sqrt_flat as jsf
from rootba_tpu.solver.linearization import StreamFactors as JStreamFactors
from rootba_tpu.solver.lm import bundle_adjust as j_bundle_adjust
from rootba_tpu.solver.lm import create_linearizer as j_create
from rootba_tpu.solver.lm import initial_state as j_initial
from rootba_tpu_torch.bal.bucketing import bucketize as t_bucketize
from rootba_tpu_torch.config.options import SolverOptions as TOptions
from rootba_tpu_torch.solver import lm as tlm
from rootba_tpu_torch.solver import sqrt_flat as tsf
from rootba_tpu_torch.solver.linearization import StreamFactors
from rootba_tpu_torch.solver.lm import create_linearizer as t_create
from rootba_tpu_torch.solver.lm import state_from_numpy

torch.set_num_threads(1)

CPU = torch.device("cpu")
HOST = dict(verbosity_level=0, lm_loop="host", function_tolerance=1e-5)


def _opts(use_double: bool, mode: str, **extra) -> dict:
    return {**HOST, "use_double": use_double, "sqrt_rcs_mode": mode,
            "max_num_iterations": 8 if use_double else 3, **extra}


def _port_solve(problem, opts: dict):
    return tlm.bundle_adjust(copy.deepcopy(problem), TOptions(**opts),
                             device="cpu")


def _message_parts(msg: str):
    """The message with its numbers taken out, and the numbers."""
    num = r"[-+]?\d+(?:\.\d+)?(?:e[-+]?\d+)?"
    return re.sub(num, "#", msg), [float(x) for x in re.findall(num, msg)]


def _same_run(t, j, use_double: bool, costs: bool = True):
    """Iteration by iteration: flags, CG counts, costs; termination and
    its message (numbers in it to rel 1e-6: the tolerance ratio divides
    by a cost difference); the three counts."""
    ti, ji = t.iterations, j.iterations
    assert len(ti) == len(ji)
    assert ([i.step_is_successful for i in ti]
            == [i.step_is_successful for i in ji])
    assert [i.step_is_valid for i in ti] == [i.step_is_valid for i in ji]
    assert ([i.linear_solver_iterations for i in ti]
            == [i.linear_solver_iterations for i in ji])
    if costs:
        rtol = 1e-9 if use_double else 1e-4
        for a, b in zip(ti, ji):
            assert a.cost.all.num_obs == b.cost.all.num_obs
            np.testing.assert_allclose(a.cost.all.error, b.cost.all.error,
                                       rtol=rtol)
            np.testing.assert_allclose(a.cost.valid.error,
                                       b.cost.valid.error, rtol=rtol)
    assert t.termination_type == j.termination_type
    (ttext, tnums), (jtext, jnums) = (_message_parts(t.message),
                                      _message_parts(j.message))
    assert ttext == jtext
    np.testing.assert_allclose(tnums, jnums, rtol=1e-6)
    assert (t.num_linear_solves, t.num_residual_evaluations,
            t.num_jacobian_evaluations) == (
        j.num_linear_solves, j.num_residual_evaluations,
        j.num_jacobian_evaluations)


@pytest.fixture(scope="module", params=[
    ("float32", "dense"), ("float32", "bsr"), ("float64", "dense"),
    ("float64", "bsr")], ids=lambda p: "-".join(p))
def jax_host(request, synthetic_problem):
    """One JAX host-loop solve: (use_double, options, summary)."""
    name, mode = request.param
    use_double = name == "float64"
    opts = _opts(use_double, mode)
    s = j_bundle_adjust(copy.deepcopy(synthetic_problem), JOptions(**opts))
    return use_double, opts, s


def test_host_loop_matches_jax(jax_host, synthetic_problem):
    use_double, opts, j = jax_host
    t = _port_solve(synthetic_problem, opts)
    _same_run(t, j, use_double)
    assert t.iterations[-1].cost.all.error < 0.7 * (
        t.iterations[0].cost.all.error)


def test_host_loop_matches_attempt_loop(jax_host, synthetic_problem):
    """The port's two LM drivers give the same run (the JAX package's
    tests/test_lm_end2end.py holds its two drivers alike)."""
    use_double, opts, _ = jax_host
    host = _port_solve(synthetic_problem, opts)
    fused = _port_solve(synthetic_problem, dict(opts, lm_loop="fused"))
    assert len(host.iterations) == len(fused.iterations)
    for a, b in zip(host.iterations, fused.iterations):
        assert a.step_is_successful == b.step_is_successful
        assert a.linear_solver_iterations == b.linear_solver_iterations
        np.testing.assert_allclose(a.cost.all.error, b.cost.all.error,
                                   rtol=1e-9)
    assert host.termination_type == fused.termination_type


def _timed_by_stage(t):
    """No time attributed; every attempt's stage fields set, stage1's on
    the iterations that linearized."""
    assert not any(it.timing_attributed for it in t.iterations)
    linearized = {1} | {i + 1 for i, it in enumerate(t.iterations)
                        if i > 0 and it.step_is_successful}
    for i, it in enumerate(t.iterations[1:], start=1):
        assert it.stage2_time_in_seconds > 0
        assert it.solve_reduced_system_time_in_seconds > 0
        assert it.back_substitution_time_in_seconds > 0
        assert it.residual_evaluation_time_in_seconds > 0
        assert it.iteration_time_in_seconds > 0
        assert (it.stage1_time_in_seconds > 0) == (i in linearized)
        assert it.jacobian_evaluation_time_in_seconds == (
            it.stage1_time_in_seconds)


def test_every_iteration_timed_by_stage(jax_host, synthetic_problem):
    """The JAX driver attributes the time of its one-dispatch attempts
    by calibration fractions; the port times every stage by events."""
    use_double, opts, j = jax_host
    assert any(it.timing_attributed for it in j.iterations)
    _timed_by_stage(_port_solve(synthetic_problem, opts))


def test_measured_timing_routes_to_the_host_loop(synthetic_problem,
                                                 monkeypatch):
    loops = []
    real = tlm.optimize_lm

    def spy(*a, **kw):
        loops.append("host")
        return real(*a, **kw)

    monkeypatch.setattr(tlm, "optimize_lm", spy)
    t = _port_solve(synthetic_problem, dict(
        _opts(True, "dense"), lm_loop="fused", timing_mode="measured"))
    assert loops == ["host"]
    _timed_by_stage(t)


# the rejects run: rho sits within 1e-4 of 1 on this problem, so this
# threshold rejects the first steps (each restores the state and
# backtracks with a larger lambda) before one is accepted
@pytest.fixture(scope="module", params=[
    dict(min_relative_decrease=1.00005)], ids=["rejects"])
def jax_variant(request, synthetic_problem):
    opts = _opts(True, "dense", **request.param)
    return opts, j_bundle_adjust(copy.deepcopy(synthetic_problem),
                                 JOptions(**opts))


def test_driver_variants_match_jax(jax_variant, synthetic_problem):
    opts, j = jax_variant
    t = _port_solve(synthetic_problem, opts)
    _same_run(t, j, True)
    flags = [i.step_is_successful for i in t.iterations]
    assert flags[1:4] == [False] * 3 and any(flags[4:])


def test_nan_landmark_raises_in_both_packages(synthetic_problem):
    p = copy.deepcopy(synthetic_problem)
    p.lm_p[0] = np.nan
    opts = _opts(True, "dense")
    with pytest.raises(FloatingPointError):
        j_bundle_adjust(copy.deepcopy(p), JOptions(**opts))
    with pytest.raises(FloatingPointError):
        _port_solve(p, opts)


def test_stage1_failures_raise(synthetic_problem):
    """stage1's failure count raises FloatingPointError at linearize,
    before the Jacobian evaluation is counted, as in the JAX driver."""
    bp = t_bucketize(synthetic_problem, pow2_from=9)
    lin = t_create(bp, TOptions(**_opts(True, "dense")), torch.float64,
                   CPU)
    lin.summary = tlm.SolverSummary()
    lin.start_iteration(tlm.IterationSummary(iteration=1))
    lin.set_state(tlm.initial_state(bp, torch.float64, CPU))
    real = lin.stage1

    def failing(cams, lm_ps):
        lins, ps, _ = real(cams, lm_ps)
        return lins, ps, torch.tensor(3)

    lin.stage1 = failing
    with pytest.raises(FloatingPointError, match="3 observations"):
        lin.linearize()
    assert lin.summary.num_jacobian_evaluations == 0


def test_non_finite_increment(synthetic_problem, monkeypatch):
    """The first attempt's increment made NaN in both packages: an
    invalid step with lambda *= vee and no state change, then a
    successful one; the port's run and counts equal the JAX driver's
    (its one-dispatch attempts: no calibration attempt)."""
    import jax.numpy as jnp

    from rootba_tpu.solver.lm import optimize_lm as j_optimize_lm

    opts = _opts(True, "dense", max_num_iterations=3, function_tolerance=0.0)
    jopts = JOptions(**opts, timing_calibration_interval=0)
    jbp = j_bucketize(synthetic_problem, pow2_from=jopts.bucket_pow2_from)
    jlin = j_create(jbp, jopts, np.float64)
    lam0 = 1.0 / jopts.initial_trust_region_radius
    solve = jlin.solve_pure

    def nan_at_first_lambda(consts, lins, lam):
        inc, s2, it, term = solve(consts, lins, lam)
        return (jnp.where(lam == jnp.asarray(lam0, lam.dtype), jnp.nan,
                          inc), s2, it, term)

    jlin.solve_pure = nan_at_first_lambda
    _, j = j_optimize_lm(jbp, jopts, linearizer=jlin)

    real = tsf.FlatSqrtLinearizer.lsolve
    calls = []

    def nan_first(self, lins, aux):
        inc, s2, it, term = real(self, lins, aux)
        calls.append(1)
        return (inc * np.nan if len(calls) == 1 else inc), s2, it, term

    monkeypatch.setattr(tsf.FlatSqrtLinearizer, "lsolve", nan_first)
    t = _port_solve(synthetic_problem, opts)
    it1 = t.iterations[1]
    assert not it1.step_is_valid and not it1.step_is_successful
    assert t.iterations[2].step_is_successful
    np.testing.assert_allclose(1.0 / it1.trust_region_radius,
                               lam0 * TOptions().initial_vee)
    _same_run(t, j, True)
    assert (t.num_linear_solves, t.num_residual_evaluations,
            t.num_jacobian_evaluations) == (3, 4, 2)


# ---------------------------------------------------------------------------
# fused-W stream factors

LAM = 1e-3
REGIMES = {"dense": dict(sqrt_rcs_mode="dense", pallas_cg="off"),
           "bsr": dict(sqrt_rcs_mode="bsr"),
           "bsr_sym": dict(sqrt_rcs_mode="bsr", bsr_pack_max_gb=0.0)}


def _t_step(bp, tdtype, regime, state_np):
    """One stage1 / stage2 / solve / apply of the port: the factors
    stage2 built, its table and diagonal factors, and the step."""
    lin = t_create(bp, TOptions(use_double=tdtype == torch.float64,
                                pair_gather="stream", **REGIMES[regime]),
                   tdtype, CPU)
    st = state_from_numpy(state_np, tdtype, CPU)
    factors = []
    real = tsf._rcs_factors

    def spy(*a):
        factors.append(real(*a))
        return factors[-1]

    tsf._rcs_factors = spy
    try:
        lins, ps, _ = lin.stage1(st.cams, st.lm_ps)
        aux = lin.stage2(lins, torch.tensor(LAM, dtype=tdtype))
        s2, H = aux
        table = H[0] if regime != "dense" else H
        inc, s2, it, _ = lin.lsolve(lins, aux)
        cams, lm_ps, l_diff = lin.apply(st.cams, st.lm_ps, lins, s2, ps,
                                        inc)
    finally:
        tsf._rcs_factors = real
    return factors, dict(table=table, chol=s2.precond_chol, b=s2.b,
                         inc=inc, l_diff=l_diff, q=cams.q, t=cams.t,
                         lm=torch.cat([p.reshape(-1) for p in lm_ps]),
                         cg=int(it))


@pytest.fixture(scope="module", params=[
    (d, r) for d in ("float32", "float64") for r in REGIMES],
    ids=lambda p: "-".join(p))
def fused_w(request, synthetic_problem):
    """The JAX package's step with fused-W, and the port's with fused-W
    and with materialized W, from the same state."""
    name, regime = request.param
    dtype = np.dtype(name)
    tdtype = torch.float32 if dtype == np.float32 else torch.float64
    jfactors = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jsf, "_FUSED_W_MIN_BYTES", 0)
        real = jsf._rcs_factors

        def spy(*a):
            jfactors.append(real(*a))
            return jfactors[-1]

        mp.setattr(jsf, "_rcs_factors", spy)
        jbp = j_bucketize(synthetic_problem, pow2_from=9)
        jlin = j_create(jbp, JOptions(use_double=dtype == np.float64,
                                      pair_gather="stream",
                                      **REGIMES[regime]), dtype.type)
        js = j_initial(jbp, dtype.type)
        jl, jps, _ = jlin._stage1_fn(jlin.consts, js.cams, js.lm_ps)
        jaux = jlin._stage2_fn(jlin.consts, jl, np.asarray(LAM, dtype))
        jinc, js2, jit, _ = jlin._lsolve_fn(jlin.consts, jl, jaux)
        jcams, jlm, jld = jlin._apply_fn(jlin.consts, js.cams, js.lm_ps,
                                         jl, js2, jps, jinc)
    H = jaux[1]
    jax_step = dict(table=H[0] if regime != "dense" else H,
                    chol=js2.precond_chol, b=js2.b, inc=jinc, l_diff=jld,
                    q=jcams.q, t=jcams.t,
                    lm=np.concatenate([np.asarray(p).reshape(-1)
                                       for p in jlm]), cg=int(jit))
    state_np = {"q": js.cams.q, "t": js.cams.t, "intr": js.cams.intr,
                "lm_ps": js.lm_ps}
    tbp = t_bucketize(synthetic_problem, pow2_from=9)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tsf, "_FUSED_W_MIN_BYTES", 0)
        tfactors, fused = _t_step(tbp, tdtype, regime, state_np)
    mfactors, materialized = _t_step(tbp, tdtype, regime, state_np)
    return dict(dtype=dtype, jfactors=jfactors, jax=jax_step,
                tfactors=tfactors, fused=fused, mfactors=mfactors,
                materialized=materialized)


def _close_steps(got, ref, tol):
    assert got["cg"] == ref["cg"]
    for k in ("table", "chol", "b", "inc", "l_diff", "q", "t", "lm"):
        g = np.asarray(got[k].numpy() if torch.is_tensor(got[k])
                       else got[k])
        r = np.asarray(ref[k].numpy() if torch.is_tensor(ref[k])
                       else ref[k])
        assert g.shape == r.shape, k
        np.testing.assert_allclose(g, r, rtol=tol, atol=tol, err_msg=k)


def test_fused_w_matches_jax(fused_w):
    """Both packages took fused-W (one StreamFactors per stage2), and
    the port's table, diagonal factors and step equal the JAX
    package's."""
    assert len(fused_w["jfactors"]) == 1 and len(fused_w["tfactors"]) == 1
    assert isinstance(fused_w["jfactors"][0][0], JStreamFactors)
    assert isinstance(fused_w["tfactors"][0], StreamFactors)
    tol = 5e-4 if fused_w["dtype"] == np.float32 else 1e-9
    _close_steps(fused_w["fused"], fused_w["jax"], tol)


def test_fused_w_matches_materialized_w(fused_w):
    """The same step with the W tables materialized by K2's twin: W rows
    built after the gather are the same rows."""
    assert isinstance(fused_w["mfactors"][0], tuple)
    assert not isinstance(fused_w["mfactors"][0], StreamFactors)
    tol = 1e-6 if fused_w["dtype"] == np.float32 else 1e-12
    _close_steps(fused_w["fused"], fused_w["materialized"], tol)


# ---------------------------------------------------------------------------
# routing


def test_auto_routes_above_fused_obs_threshold(synthetic_problem,
                                               monkeypatch):
    loops = []
    real = tlm.optimize_lm

    def spy(*a, **kw):
        loops.append("host")
        return real(*a, **kw)

    monkeypatch.setattr(tlm, "optimize_lm", spy)
    n = synthetic_problem.num_observations
    opts = _opts(True, "dense", lm_loop="auto")
    _port_solve(synthetic_problem, dict(opts, fused_obs_threshold=n))
    assert loops == []
    _port_solve(synthetic_problem, dict(opts, fused_obs_threshold=n - 1))
    assert loops == ["host"]


def test_iteration_callback_and_linearizer_reuse(synthetic_problem):
    """optimize_lm calls iteration_callback after every iteration, and a
    linearizer passed in again solves from the initial state alike."""
    bp = t_bucketize(synthetic_problem, pow2_from=9)
    opts = TOptions(**_opts(True, "dense"))
    lin = t_create(bp, opts, torch.float64, CPU)
    seen = []
    _, first = tlm.optimize_lm(
        bp, opts, device=CPU, linearizer=lin,
        iteration_callback=lambda it, state, s: seen.append(
            (it, len(s.iterations), state.cams.q.shape)))
    assert seen == [(i + 1, i + 1, (bp.num_cameras, 4))
                    for i in range(len(first.iterations))]
    _, again = tlm.optimize_lm(bp, opts, device=CPU, linearizer=lin)
    assert ([i.cost.all.error for i in again.iterations]
            == [i.cost.all.error for i in first.iterations])


@pytest.mark.parametrize("argv", [["--lm-loop", "host"],
                                  ["--timing-mode", "measured"]])
def test_cli_cpu_runs_the_host_loop(tmp_path, monkeypatch, argv):
    from rootba_tpu_torch.bal.synthetic import (
        generate_synthetic_bal,
        write_bal_file,
    )
    from rootba_tpu_torch.cli.bal import run_app

    loops = []
    real = tlm.optimize_lm

    def spy(*a, **kw):
        loops.append("host")
        return real(*a, **kw)

    monkeypatch.setattr(tlm, "optimize_lm", spy)
    bal = tmp_path / "problem.txt"
    write_bal_file(generate_synthetic_bal(num_cams=8, num_lms=120, seed=11),
                   str(bal))
    cwd = os.getcwd()
    try:
        rc = run_app("test", ["-C", str(tmp_path), "--input", str(bal),
                              "--device", "cpu", "--max-num-iterations",
                              "3", "--init-depth-threshold", "0.1",
                              "--quiet", *argv])
    finally:
        os.chdir(cwd)
    assert rc == 0 and loops == ["host"]
    log = json.loads((tmp_path / "ba_log.json").read_text())
    assert len(log["cost"]) == 4 and log["cost"][-1] < log["cost"][0]
