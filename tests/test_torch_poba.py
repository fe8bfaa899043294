"""The port's POWER_SCHUR_COMPLEMENT (PoBA) solver against the JAX
package's on the conftest problem (12 cameras, 200 landmarks), in
float32 and float64 (SC: tests/test_torch_sc.py, whose layout this file
follows).

(a) One attempt from the same state: the port's dense E0, BSR E0
    (dense_rcs_max_cameras=1, packed and half table) and implicit sweep
    (=0) against the JAX package's dense-E0 attempt, as its
    test_poba_bsr_vs_dense_e0 and test_poba_dense_vs_implicit_e0 hold
    its own: float64 1e-8, float32 1e-4 (2e-4 on the increment), the
    same number of power-series terms.
(b) Stage functions on the same linearization: e0_assemble_dense and
    jp_gram_blockdiag against the JAX attempt's stage2, e0_assemble_bsr,
    e0_matvec (camera CSR and segment sum) and power_series_solve
    (zeta-terminated and fixed-order) against the JAX package's;
    float64 1e-10, float32 1e-4 of each array's largest magnitude.
(c) Whole solves through both LM drivers against the JAX host loop on
    the reference attempt's linearizer (float64 6 LM iterations, float32
    3): the same flags and term counts, costs within rel 1e-8 / 2e-3;
    the `bal_power_sc` CLI's log against the JAX log.
"""

import copy
import json
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from rootba_tpu.bal.bucketing import bucketize as j_bucketize
from rootba_tpu.config.options import SolverOptions as JOptions
from rootba_tpu.config.options import SolverType as JSolver
from rootba_tpu.log.ba_log import build_log_dict as j_build_log
from rootba_tpu.solver import explicit_sc as jsc
from rootba_tpu.solver.lm import create_linearizer as j_create
from rootba_tpu.solver.lm import initial_state as j_initial
from rootba_tpu.solver.lm import optimize_lm as j_optimize_lm
from rootba_tpu_torch.bal.bucketing import bucketize as t_bucketize
from rootba_tpu_torch.config.options import SolverOptions as TOptions
from rootba_tpu_torch.config.options import SolverType as TSolver
from rootba_tpu_torch.solver import explicit_sc as tsc
from rootba_tpu_torch.solver import linearization as tlz
from rootba_tpu_torch.solver import lm as tlm
from rootba_tpu_torch.solver.lm import create_linearizer as t_create
from rootba_tpu_torch.solver.lm import state_from_numpy

torch.set_num_threads(1)

CPU = torch.device("cpu")
LAM = 1e-3
VARIANTS = {"dense": {}, "bsr": dict(dense_rcs_max_cameras=1),
            "bsr_sym": dict(dense_rcs_max_cameras=1, bsr_pack_max_gb=0.0),
            "implicit": dict(dense_rcs_max_cameras=0)}


def _np(x):
    return np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)


def _close(got, ref, tol, what):
    got, ref = _np(got), _np(ref)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    scale = max(float(np.abs(ref).max()), 1e-30) if ref.size else 1.0
    np.testing.assert_allclose(got, ref, rtol=tol, atol=tol * scale,
                               err_msg=what)


def _tdtype(dtype):
    return torch.float32 if dtype == np.float32 else torch.float64


def _t(x, dtype):
    return torch.tensor(np.asarray(x), dtype=_tdtype(dtype))


def _state(js, dtype):
    return state_from_numpy({"q": js.cams.q, "t": js.cams.t,
                             "intr": js.cams.intr, "lm_ps": js.lm_ps},
                            _tdtype(dtype), CPU)


def _solve_opts(use_double: bool) -> dict:
    return dict(verbosity_level=0, lm_loop="host", function_tolerance=1e-5,
                use_double=use_double, num_threads=3,
                max_num_iterations=6 if use_double else 3)


# one JAX linearizer and attempt per precision, made once per module
_JAX = {}


def _jax_ref(problem, dtype):
    if dtype in _JAX:
        return _JAX[dtype]
    bp = j_bucketize(problem, pow2_from=9)
    opts = JOptions(solver_type=JSolver.POWER_SCHUR_COMPLEMENT,
                    host_fused_attempt=False, num_devices=1,
                    **_solve_opts(dtype == np.float64))
    lin = j_create(bp, opts, dtype.type)
    s = j_initial(bp, dtype.type)
    lins, ps, _ = lin._stage1_fn(lin.consts, s.cams, s.lm_ps)
    aux = lin._stage2_fn(lin.consts, lins, np.asarray(LAM, dtype))
    inc, s2, it, _ = lin._lsolve_fn(lin.consts, lins, aux)
    cams, lm, ld = lin._apply_fn(lin.consts, s.cams, s.lm_ps, lins, s2, ps,
                                 inc)
    ref = dict(ps=ps, b=s2.b, inc=inc, it=int(it), ld=float(ld), q=cams.q,
               t=cams.t, lm=np.concatenate([np.asarray(p).ravel()
                                            for p in lm]))
    _JAX[dtype] = (lin, opts, s, lins, aux, ref)
    return _JAX[dtype]


@pytest.fixture(scope="module", params=["float32", "float64"])
def jax_attempt(request, synthetic_problem):
    dtype = np.dtype(request.param)
    return (dtype,) + _jax_ref(synthetic_problem, dtype)


def test_attempt_matches_jax(jax_attempt, synthetic_problem):
    dtype, jlin, _, js, _, _, ref = jax_attempt
    f32 = dtype == np.float32
    tol = 1e-4 if f32 else 1e-8
    tol_inc = 2e-4 if f32 else tol
    tdtype = _tdtype(dtype)
    for variant, extra in VARIANTS.items():
        tlin = t_create(t_bucketize(synthetic_problem, pow2_from=9),
                        TOptions(use_double=not f32,
                                 solver_type=TSolver.POWER_SCHUR_COMPLEMENT,
                                 **extra), tdtype, CPU)
        s = _state(js, dtype)
        lins, ps, _ = tlin.stage1(s.cams, s.lm_ps)
        aux = tlin.stage2(lins, torch.tensor(LAM, dtype=tdtype))
        inc, s2, it, _ = tlin.lsolve(lins, aux)
        cams, lm, ld = tlin.apply(s.cams, s.lm_ps, lins, s2, ps, inc)
        got = dict(ps=ps, b=s2.b, q=cams.q, t=cams.t,
                   lm=np.concatenate([p.numpy().ravel() for p in lm]))
        assert tlin.linear_solver_type == jlin.linear_solver_type == (
            "bal_power_sc")
        assert tlin.prepare_field == jlin.prepare_field
        assert it == ref["it"], variant
        for k in got:
            _close(got[k], ref[k], tol, f"{variant}: {k}")
        _close(inc, ref["inc"], tol_inc, f"{variant}: inc")
        np.testing.assert_allclose(float(ld), ref["ld"], rtol=tol_inc,
                                   err_msg=f"{variant}: l_diff")


# ---------------------------------------------------------------------------
# (b) stage functions on the same linearization


@pytest.fixture(scope="module", params=["float32", "float64"])
def lin_pair(request, synthetic_problem):
    """The JAX PoBA attempt's stage1 output and stage2 (the Jp gram's
    factors, E0), the port's copy of the linearization with its
    damped Hll^-1, and both packages' dense and BSR structures."""
    dtype = np.dtype(request.param)
    jd, _, _, jlins, jaux, _ = _jax_ref(synthetic_problem, dtype)
    jb = j_create(jd.bp, JOptions(use_double=dtype == np.float64,
                                  solver_type=JSolver.POWER_SCHUR_COMPLEMENT,
                                  dense_rcs_max_cameras=1), dtype.type)
    tbp = t_bucketize(synthetic_problem, pow2_from=9)
    topts = dict(use_double=dtype == np.float64,
                 solver_type=TSolver.POWER_SCHUR_COMPLEMENT)
    td, tb = (t_create(tbp, TOptions(**topts, **kw), _tdtype(dtype), CPU)
              for kw in ({}, dict(dense_rcs_max_cameras=1)))
    tlins = tuple(tlz.LinBucket(Jp=_t(l.Jp, dtype), Jl=_t(l.Jl, dtype),
                                r=_t(l.r, dtype),
                                Jl_scale=_t(l.Jl_scale, dtype))
                  for l in jlins)
    tlam = torch.tensor(LAM, dtype=_tdtype(dtype))
    th = tuple(tsc.damped_hll_inv(l, b, tlam)
               for l, b in zip(tlins, td.buckets))
    return dict(dtype=dtype, jd=jd, jb=jb, td=td, tb=tb, jlins=jlins,
                tlins=tlins, th=th, N=td.num_cameras, jaux=jaux, tlam=tlam,
                tol=1e-4 if dtype == np.float32 else 1e-10)


def test_e0_assembly_and_jacobi(lin_pair):
    """e0_assemble_dense and jp_gram_blockdiag against the JAX PoBA
    attempt's stage2, e0_assemble_bsr (half table, negated) against the
    JAX package's; the damped Hll^-1 against the attempt's."""
    from rootba_tpu_torch.ops.block9 import chol9

    lp, tol, N = lin_pair, lin_pair["tol"], lin_pair["N"]
    js2, jchol, jE0 = lp["jaux"]
    for g, r in zip(lp["th"], js2.Hll_inv):
        _close(g, r, tol, "Hll_inv")
    td, tb = lp["td"], lp["tb"]
    _close(tsc.e0_assemble_dense(lp["tlins"], td.buckets, lp["th"],
                                 td.pair_index, td.cam_stream, N), jE0,
           tol, "E0 dense")
    jac = tsc.jp_gram_blockdiag(lp["tlins"], td.buckets, lp["tlam"], N)
    _close(chol9(jac), jchol, tol, "chol of jp_gram_blockdiag")
    # the undamped per-bucket Gram blocks (add_Jp_T_Jp_blockdiag) sum to
    # the same blocks
    eye = torch.eye(9, dtype=jac.dtype)
    _close(sum(tlz.jp_t_jp_blockdiag(l, b.cam_idx, N)
               for l, b in zip(lp["tlins"], td.buckets)) + lp["tlam"] * eye,
           jac, tol, "jp_t_jp_blockdiag")
    (buckets, csr, pair_csr, cam_flat, cstrips, _) = lp["jb"].consts
    jE, jEd = jax.jit(lambda l, b, h, pc, cf, c, cs: jsc.e0_assemble_bsr(
        l, b, h, pc, cf, c, N, cam_strips=cs, symmetric=True))(
        lp["jlins"], buckets, js2.Hll_inv, pair_csr, cam_flat, csr, cstrips)
    tE, tEd = tsc.e0_assemble_bsr(lp["tlins"], tb.buckets, lp["th"],
                                  tb.pair_index, tb.cam_stream, N,
                                  symmetric=True)
    _close(tE, jE, tol, "neg E0 half table")
    _close(tEd, jEd, tol, "neg E0 diag")


def test_e0_matvec_and_power_series(lin_pair):
    lp, tol, N, dtype = (lin_pair, lin_pair["tol"], lin_pair["N"],
                         lin_pair["dtype"])
    js2, jchol, _ = lp["jaux"]
    jbk, tbk = lp["jd"].buckets, lp["td"].buckets
    x = np.random.default_rng(2).normal(size=(N, 9))
    b = np.random.default_rng(3).normal(size=(N, 9))

    from rootba_tpu.ops.block9 import chol9_inv as j_inv
    from rootba_tpu.ops.block9 import inv9_apply as j_apply
    from rootba_tpu_torch.ops.block9 import chol9_inv, inv9_apply

    series = ((10, 0.1), (4, -1.0))

    def jax_side(l, bk, h, v, c, hpp_chol, rhs):
        hinv = j_inv(hpp_chol)
        outs = [jsc.e0_matvec(l, bk, h, N, v, csr=c)]
        for order, q_tol in series:
            outs.append(jsc.power_series_solve(
                lambda u: j_apply(hinv, u),
                lambda u: jsc.e0_matvec(l, bk, h, N, u, csr=c), rhs, order,
                q_tol))
        return outs

    jy, *jser = jax.jit(jax_side)(
        lp["jlins"], jbk, js2.Hll_inv, jnp.asarray(x, dtype),
        lp["jd"].consts[1], jchol, jnp.asarray(b, dtype))
    for csr in (lp["td"].cam_csr, None):
        _close(tsc.e0_matvec(lp["tlins"], tbk, lp["th"], N, _t(x, dtype),
                             csr=csr), jy, tol, "e0_matvec")
    tinv = chol9_inv(_t(jchol, dtype))
    for (order, q_tol), (jx, jit) in zip(series, jser):
        tx, tit = tsc.power_series_solve(
            lambda v: inv9_apply(tinv, v),
            lambda v: tsc.e0_matvec(lp["tlins"], tbk, lp["th"], N, v),
            _t(b, dtype), order, q_tol)
        assert tit == int(jit)
        _close(tx, jx, 10 * tol, f"power series order {order}")


# ---------------------------------------------------------------------------
# (c) whole solves and the CLI


def _jax_solve(problem, dtype):
    lin, opts, *_ = _jax_ref(problem, dtype)
    _, summary = j_optimize_lm(lin.bp, opts, linearizer=lin)
    return summary


@pytest.fixture(scope="module", params=["float32", "float64"])
def jax_solve(request, synthetic_problem):
    dtype = np.dtype(request.param)
    return dtype == np.float64, _jax_solve(synthetic_problem, dtype)


@pytest.mark.parametrize("lm_loop", ["fused", "host"])
def test_solve_matches_jax(jax_solve, synthetic_problem, lm_loop):
    use_double, j = jax_solve
    t = tlm.bundle_adjust(
        copy.deepcopy(synthetic_problem),
        TOptions(solver_type=TSolver.POWER_SCHUR_COMPLEMENT,
                 **dict(_solve_opts(use_double), lm_loop=lm_loop)),
        device="cpu")
    ti, ji = t.iterations, j.iterations
    assert len(ti) == len(ji)
    assert ([i.step_is_successful for i in ti]
            == [i.step_is_successful for i in ji])
    assert [i.step_is_valid for i in ti] == [i.step_is_valid for i in ji]
    assert ([i.linear_solver_iterations for i in ti]
            == [i.linear_solver_iterations for i in ji])
    np.testing.assert_allclose([i.cost.all.error for i in ti],
                               [i.cost.all.error for i in ji],
                               rtol=1e-8 if use_double else 2e-3)
    assert t.termination_type == j.termination_type
    assert t.solver_type == j.solver_type == "bal_power_sc"
    assert t.num_threads_given == j.num_threads_given == 3
    assert ti[-1].cost.all.error < ti[0].cost.all.error
    for run in (ti, ji):
        assert all(a.prepare_time_in_seconds > 0 for a in run[1:])
        assert not any(a.stage2_time_in_seconds for a in run)


@pytest.mark.parametrize("extra", [[], ["--dense-rcs-max-cameras", "4"],
                                   ["--dense-rcs-max-cameras", "0"]],
                         ids=["dense", "bsr", "implicit"])
def test_cli_cpu_writes_the_reference_log(tmp_path, synthetic_problem,
                                          extra):
    """`bal_power_sc` with --device cpu with dense E0, BSR E0 and the
    implicit sweep: the JAX package's solver name and num_threads_given,
    prepare_time in place of stage2_time."""
    from rootba_tpu_torch.bal.synthetic import (
        generate_synthetic_bal,
        write_bal_file,
    )
    from rootba_tpu_torch.cli import bal_power_sc

    ref = j_build_log(_jax_solve(synthetic_problem, np.dtype("float64")))
    bal = tmp_path / "problem.txt"
    write_bal_file(generate_synthetic_bal(num_cams=8, num_lms=120, seed=11),
                   str(bal))
    cwd, argv = os.getcwd(), sys.argv
    sys.argv = ["bal_power_sc", "-C", str(tmp_path), "--input", str(bal),
                "--device", "cpu", "--max-num-iterations", "3",
                "--num-threads", "3", "--init-depth-threshold", "0.1",
                "--quiet", *extra]
    try:
        assert bal_power_sc.main() == 0
    finally:
        os.chdir(cwd)
        sys.argv = argv
    log = json.loads((tmp_path / "ba_log.json").read_text())
    for k in ("solver_type", "num_threads_given"):
        assert log["_static"]["solver"][k] == ref["_static"]["solver"][k]
    assert ref["_static"]["solver"]["num_threads_given"] == 3
    for d in (log, ref):
        assert all(t > 0 for t in d["prepare_time"][1:])
        assert not any(d["stage2_time"])
    assert len(log["cost"]) == 4 and log["cost"][-1] < log["cost"][0]
