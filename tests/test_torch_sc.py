"""The port's SCHUR_COMPLEMENT solver against the JAX package's on the
conftest problem (12 cameras, 200 landmarks), in float32 and float64,
and the fixed-order reductions it shares with the SQUARE_ROOT path.
(PoBA: tests/test_torch_poba.py.)

(a) One attempt (stage1, stage2, solve, apply) from the same state,
    compared on pose scale, b, increment, l_diff, cameras and landmarks,
    under the SCHUR_JACOBI, DIAGONAL and POWER_SCHUR_COMPLEMENT
    preconditioners. Each JAX reference is made once per module, and
    the port's dense, BSR (dense_rcs_max_cameras=1, packed and half
    table) and scatter (=0) modes are held against the dense one, as
    the JAX package's test_sc_bsr_vs_dense_rcs holds its own. Its
    tolerances: float64 1e-9 (1e-8 under the power-series
    preconditioner), float32 1e-4, 2e-4 on the CG-amplified increment.
(b) Stage functions on the same linearization (the JAX attempt's stage1
    output, copied): sc_rhs_and_hll (camera stream, camera CSR, segment
    sum), sc_assemble_dense (against the JAX attempt's stage2),
    sc_assemble (scatter) with sc_diag_blocks and sc_matvec,
    sc_assemble_bsr and sc_back_substitute; float64 1e-10, float32
    1e-4 of each array's largest magnitude.
(c) Whole solves through both of the port's LM drivers (the attempt loop
    and lm_loop="host") against the JAX host loop, which runs on one
    device on the reference attempt's linearizer (separate stage
    dispatches, so no second compile): float64 6 LM iterations, float32
    3 (later float32 iterations sit at rounding level); the same flags
    and CG counts, costs within rel 1e-8 / 2e-3; prepare_time logged in
    place of stage2_time; the `bal_sc` CLI's log against the JAX log.
(d) The camera-CSR reduce and the stream reducers' run tree: equal to a
    segment sum on the CPU; reduction_alg 0 and 1 give the same
    SQUARE_ROOT attempt. That the card's sums repeat bit for bit is
    checked by chip_smoke.py (a CPU test that permutes nothing cannot
    show it).
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
from rootba_tpu.config.options import PreconditionerType as JPrec
from rootba_tpu.config.options import SolverOptions as JOptions
from rootba_tpu.config.options import SolverType as JSolver
from rootba_tpu.log.ba_log import build_log_dict as j_build_log
from rootba_tpu.solver import explicit_sc as jsc
from rootba_tpu.solver.lm import create_linearizer as j_create
from rootba_tpu.solver.lm import initial_state as j_initial
from rootba_tpu.solver.lm import optimize_lm as j_optimize_lm
from rootba_tpu_torch.bal.bucketing import bucketize as t_bucketize
from rootba_tpu_torch.bal.bucketing import build_run_tree
from rootba_tpu_torch.config.options import PreconditionerType as TPrec
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
SOLVER = JSolver.SCHUR_COMPLEMENT

# the JAX references (preconditioners) and the port's variants held
# against each: extra options
VARIANTS = {
    JPrec.SCHUR_JACOBI: {
        "dense": {}, "bsr": dict(dense_rcs_max_cameras=1),
        "bsr_sym": dict(dense_rcs_max_cameras=1, bsr_pack_max_gb=0.0),
        "scatter": dict(dense_rcs_max_cameras=0),
        "csr_off": dict(reduction_alg=0)},
    JPrec.DIAGONAL: {"dense": {}, "scatter": dict(dense_rcs_max_cameras=0)},
    JPrec.POWER_SCHUR_COMPLEMENT: {
        "dense": {}, "bsr": dict(dense_rcs_max_cameras=1),
        "scatter": dict(dense_rcs_max_cameras=0)},
}


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


def _jx(fn, *args):
    """fn(*args) as one jitted JAX program (un-jitted, the stream
    reducers' op-by-op dispatch costs ten times the compile)."""
    return jax.jit(fn)(*args)


def _state(js, dtype):
    return state_from_numpy({"q": js.cams.q, "t": js.cams.t,
                             "intr": js.cams.intr, "lm_ps": js.lm_ps},
                            _tdtype(dtype), CPU)


def _solve_opts(use_double: bool) -> dict:
    """Options of the whole solves (also the JAX linearizer's: its stage
    programs do not read the loop options)."""
    return dict(verbosity_level=0, lm_loop="host", function_tolerance=1e-5,
                use_double=use_double, num_threads=3,
                max_num_iterations=6 if use_double else 3)


# one JAX linearizer and attempt per (preconditioner, precision), made
# once per module: the attempt tests, the stage tests (which read the
# attempt's stage outputs) and the whole solves (on its warm stage
# programs) share them
_JAX = {}


def _jax_ref(problem, prec, dtype):
    if (prec, dtype) in _JAX:
        return _JAX[prec, dtype]
    bp = j_bucketize(problem, pow2_from=9)
    opts = JOptions(solver_type=SOLVER, preconditioner_type=prec,
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
    _JAX[prec, dtype] = (lin, opts, s, lins, aux, ref)
    return _JAX[prec, dtype]


def _one_attempt_port(problem, js, dtype, prec, **extra):
    tbp = t_bucketize(problem, pow2_from=9)
    lin = t_create(tbp, TOptions(use_double=dtype == np.float64,
                                 solver_type=TSolver(SOLVER.value),
                                 preconditioner_type=TPrec(prec.value),
                                 **extra), _tdtype(dtype), CPU)
    s = _state(js, dtype)
    lins, ps, fail = lin.stage1(s.cams, s.lm_ps)
    aux = lin.stage2(lins, torch.tensor(LAM, dtype=_tdtype(dtype)))
    inc, s2, it, _ = lin.lsolve(lins, aux)
    cams, lm, ld = lin.apply(s.cams, s.lm_ps, lins, s2, ps, inc)
    assert int(fail) == 0
    return lin, dict(ps=ps, b=s2.b, inc=inc, it=int(it), ld=float(ld),
                     q=cams.q, t=cams.t,
                     lm=np.concatenate([p.numpy().ravel() for p in lm]))


@pytest.fixture(scope="module",
                params=[(p, d) for p in VARIANTS
                        for d in ("float32", "float64")],
                ids=lambda p: f"{p[0].value.lower()}-{p[1]}")
def jax_attempt(request, synthetic_problem):
    prec, dname = request.param
    dtype = np.dtype(dname)
    return (prec, dtype) + _jax_ref(synthetic_problem, prec, dtype)


def test_attempt_matches_jax(jax_attempt, synthetic_problem):
    prec, dtype, jlin, _, js, _, _, ref = jax_attempt
    f32 = dtype == np.float32
    tol = 1e-4 if f32 else (1e-8 if prec == JPrec.POWER_SCHUR_COMPLEMENT
                            else 1e-9)
    tol_inc = 2e-4 if f32 else tol
    for variant, extra in VARIANTS[prec].items():
        tlin, got = _one_attempt_port(synthetic_problem, js, dtype, prec,
                                      **extra)
        what = f"{prec.value} {variant}"
        assert tlin.linear_solver_type == jlin.linear_solver_type == "bal_sc"
        assert tlin.prepare_field == jlin.prepare_field
        assert got["it"] == ref["it"], what
        for k in ("ps", "b", "q", "t", "lm"):
            _close(got[k], ref[k], tol, f"{what}: {k}")
        _close(got["inc"], ref["inc"], tol_inc, f"{what}: inc")
        np.testing.assert_allclose(got["ld"], ref["ld"], rtol=tol_inc,
                                   err_msg=f"{what}: l_diff")


def test_routes(synthetic_problem):
    """Dense RCS up to dense_rcs_max_cameras, BSR above it (the half
    table past bsr_pack_max_gb), the scatter assembly / implicit sweep
    at 0; the stream and obs pair gathers build their indices
    (tests/test_torch_pair_gathers.py holds them to the JAX package)."""
    tbp = t_bucketize(synthetic_problem, pow2_from=9)
    for solver in (TSolver.SCHUR_COMPLEMENT,
                   TSolver.POWER_SCHUR_COMPLEMENT):
        for kw, dense, bsr, sym in (({}, True, False, False),
                                    (dict(dense_rcs_max_cameras=1), False,
                                     True, False),
                                    (dict(dense_rcs_max_cameras=1,
                                          bsr_pack_max_gb=0.0), False, True,
                                     True),
                                    (dict(dense_rcs_max_cameras=0), False,
                                     False, False)):
            lin = t_create(tbp, TOptions(solver_type=solver, **kw),
                           torch.float64, CPU)
            assert (lin.dense_rcs, lin.bsr_rcs, lin.bsr_sym) == (
                dense, bsr, sym), (solver, kw)
        for gather, index in (("stream", tlz.PairStreamIndex),
                              ("obs", tlz.PairCsrIndex)):
            lin = t_create(tbp, TOptions(solver_type=solver,
                                         pair_gather=gather),
                           torch.float64, CPU)
            assert lin.dense_rcs and isinstance(lin.pair_index, index)
    with pytest.raises(ValueError, match="not implemented"):
        t_create(tbp, TOptions(solver_type=TSolver.SCHUR_COMPLEMENT,
                               preconditioner_type=TPrec.JACOBI),
                 torch.float64, CPU)


# ---------------------------------------------------------------------------
# (b) stage functions on the same linearization


@pytest.fixture(scope="module", params=["float32", "float64"])
def lin_pair(request, synthetic_problem):
    """The JAX SC attempt's stage1 output and stage2 (dense H, the
    factors of its diagonal blocks, b, Hll^-1), the port's copy of the
    linearization, and both packages' dense, BSR and scatter
    structures."""
    dtype = np.dtype(request.param)
    jd, _, js, jlins, jaux, _ = _jax_ref(synthetic_problem,
                                         JPrec.SCHUR_JACOBI, dtype)
    jb = j_create(jd.bp, JOptions(use_double=dtype == np.float64,
                                  solver_type=SOLVER,
                                  dense_rcs_max_cameras=1), dtype.type)
    tbp = t_bucketize(synthetic_problem, pow2_from=9)
    topts = dict(use_double=dtype == np.float64,
                 solver_type=TSolver.SCHUR_COMPLEMENT)
    td, tb, tsd = (t_create(tbp, TOptions(**topts, **kw), _tdtype(dtype),
                            CPU)
                   for kw in ({}, dict(dense_rcs_max_cameras=1),
                              dict(dense_rcs_max_cameras=0)))
    tlins = tuple(tlz.LinBucket(Jp=_t(l.Jp, dtype), Jl=_t(l.Jl, dtype),
                                r=_t(l.r, dtype),
                                Jl_scale=_t(l.Jl_scale, dtype))
                  for l in jlins)
    tlam = torch.tensor(LAM, dtype=_tdtype(dtype))
    th = tuple(tsc.damped_hll_inv(l, b, tlam)
               for l, b in zip(tlins, td.buckets))
    return dict(dtype=dtype, jd=jd, jb=jb, js=js, td=td, tb=tb, tsd=tsd,
                jlins=jlins, tlins=tlins, th=th, N=td.num_cameras,
                jaux=jaux, jlam=jnp.asarray(LAM, dtype), tlam=tlam,
                tol=1e-4 if dtype == np.float32 else 1e-10)


def test_sc_rhs_hll_and_dense_assembly(lin_pair):
    """sc_rhs_and_hll through the camera stream, the camera CSR and a
    segment sum, and sc_assemble_dense, against the JAX SC attempt's
    stage2 on the same linearization."""
    from rootba_tpu_torch.ops.block9 import chol9

    lp, tol = lin_pair, lin_pair["tol"]
    js2, jH, jchol = lp["jaux"][:3]
    td = lp["td"]
    for kw in (dict(cam_csr=td.cam_csr), dict(cam_stream=td.cam_stream),
               {}):
        tb, th = tsc.sc_rhs_and_hll(lp["tlins"], td.buckets, lp["tlam"],
                                    lp["N"], **kw)
        _close(tb, js2.b, tol, f"b {list(kw)}")
        for g, r in zip(th, js2.Hll_inv):
            _close(g, r, tol, "Hll_inv")
    tH, tdiag, tb, _ = tsc.sc_assemble_dense(
        lp["tlins"], td.buckets, td.pair_index, td.cam_stream, lp["tlam"],
        lp["N"], cam_csr=td.cam_csr)
    _close(tH, jH, tol, "dense H")
    _close(chol9(tdiag), jchol, tol, "chol of the diagonal blocks")
    _close(tb, js2.b, tol, "b")


def test_sc_assemble_scatter(lin_pair):
    lp, tol, N = lin_pair, lin_pair["tol"], lin_pair["N"]
    jpairs = jsc.build_pair_structure(lp["jd"].bp, N)
    x = np.random.default_rng(1).normal(size=(N, 9))

    def jax_side(l, b, p, lam, c, v):
        st = jsc.sc_assemble(l, b, p, lam, N, cam_csr=c)
        return (st.H, st.b, jsc.sc_diag_blocks(st, p, N),
                jsc.sc_matvec(st, p, N, v))

    jH, jb, jdiag, jy = _jx(jax_side, lp["jlins"], lp["jd"].buckets, jpairs,
                            lp["jlam"], lp["jd"].consts[2],
                            jnp.asarray(x, lp["dtype"]))
    tsd = lp["tsd"]
    got = tsc.sc_assemble(lp["tlins"], tsd.buckets, tsd.pairs, lp["tlam"],
                          N, cam_csr=tsd.cam_csr)
    _close(got.H, jH, tol, "H")
    _close(got.b, jb, tol, "b")
    _close(tsc.sc_diag_blocks(got, tsd.pairs, N), jdiag, tol, "diag")
    _close(tsc.sc_matvec(got, tsd.pairs, N, _t(x, lp["dtype"])), jy,
           10 * tol, "sc_matvec")


def test_sc_assemble_bsr(lin_pair):
    lp, tol, N = lin_pair, lin_pair["tol"], lin_pair["N"]
    (buckets, _, csr, pair_csr, cam_flat, cstrips, _) = lp["jb"].consts
    jH, jdiag, jb, _ = _jx(
        lambda l, b, pc, cf, c, lam, cs: jsc.sc_assemble_bsr(
            l, b, pc, cf, c, lam, N, cam_strips=cs, symmetric=True),
        lp["jlins"], buckets, pair_csr, cam_flat, csr, lp["jlam"], cstrips)
    t = lp["tb"]
    tH, tdiag, tb, _ = tsc.sc_assemble_bsr(
        lp["tlins"], t.buckets, t.pair_index, t.cam_stream, lp["tlam"], N,
        cam_csr=t.cam_csr, symmetric=True)
    _close(tH, jH, tol, "bsr half table")
    _close(tdiag, jdiag, tol, "bsr diag")
    _close(tb, jb, tol, "bsr b")


def test_sc_back_substitute(lin_pair):
    lp, tol, N, dtype = (lin_pair, lin_pair["tol"], lin_pair["N"],
                         lin_pair["dtype"])
    js = lp["js"]
    inc = np.random.default_rng(4).normal(size=(N, 9)) * 1e-3

    def jax_side(l, b, h, lm, v):
        return [jsc.sc_back_substitute(l, b, h, lm, v, compensated=c)
                for c in (False, True)]

    jout = _jx(jax_side, lp["jlins"], lp["jd"].buckets,
               lp["jaux"][0].Hll_inv, js.lm_ps, jnp.asarray(inc, dtype))
    for compensated, (jlm, jld) in zip((False, True), jout):
        tlm_, tld = tsc.sc_back_substitute(
            lp["tlins"], lp["td"].buckets, lp["th"], _state(js, dtype).lm_ps,
            _t(inc, dtype), compensated=compensated)
        np.testing.assert_allclose(float(tld), float(jld), rtol=10 * tol)
        for g, r in zip(tlm_, jlm):
            _close(g, r, tol, "lm_ps")


# ---------------------------------------------------------------------------
# (c) whole solves and the CLI


def _jax_solve(problem, dtype):
    """The JAX host loop on the reference attempt's linearizer (a new
    solve from the initial state; the linearizer is stateless between
    solves)."""
    lin, opts, *_ = _jax_ref(problem, JPrec.SCHUR_JACOBI, dtype)
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
        TOptions(solver_type=TSolver.SCHUR_COMPLEMENT,
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
    assert t.solver_type == j.solver_type == "bal_sc"
    assert t.num_threads_given == j.num_threads_given == 3
    assert ti[-1].cost.all.error < ti[0].cost.all.error
    # the assembly is logged as prepare_time, as the JAX host loop logs
    # it (its attempt loop logs no stage times)
    for run in (ti, ji):
        assert all(a.prepare_time_in_seconds > 0 for a in run[1:])
        assert not any(a.stage2_time_in_seconds for a in run)


def _write_problem(path):
    from rootba_tpu_torch.bal.synthetic import (
        generate_synthetic_bal,
        write_bal_file,
    )

    p = generate_synthetic_bal(num_cams=8, num_lms=120, seed=11)
    write_bal_file(p, str(path))
    return path


@pytest.mark.parametrize("extra", [[], ["--dense-rcs-max-cameras", "4"],
                                   ["--dense-rcs-max-cameras", "0"]],
                         ids=["dense", "bsr", "scatter"])
def test_cli_cpu_writes_the_reference_log(tmp_path, synthetic_problem,
                                          extra):
    """`bal_sc` with --device cpu in dense, BSR and scatter mode: a
    ba_log.json with the JAX package's solver name and num_threads_given
    (from --num-threads), and prepare_time in place of stage2_time, as
    the JAX log of the same solver has them."""
    from rootba_tpu_torch.cli import bal_sc

    ref = j_build_log(_jax_solve(synthetic_problem, np.dtype("float64")))
    bal = _write_problem(tmp_path / "problem.txt")
    cwd, argv = os.getcwd(), sys.argv
    sys.argv = ["bal_sc", "-C", str(tmp_path), "--input", str(bal),
                "--device", "cpu", "--max-num-iterations", "3",
                "--num-threads", "3", "--init-depth-threshold", "0.1",
                "--quiet", *extra]
    try:
        assert bal_sc.main() == 0
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


# ---------------------------------------------------------------------------
# (d) the fixed-order reductions


def test_csr_cam_reduce_equals_segment_sum(synthetic_problem, monkeypatch):
    tbp = t_bucketize(synthetic_problem, pow2_from=9)
    lin = t_create(tbp, TOptions(sqrt_rcs_mode="implicit"), torch.float64,
                   CPU)
    rng = np.random.default_rng(5)
    rows = [torch.as_tensor(rng.normal(size=(b.cam_idx.numel(), 7)))
            for b in lin.buckets]
    seg = torch.cat([b.cam_idx.reshape(-1) for b in lin.buckets])
    # masked slots contribute nothing through the CSR (it lists real
    # slots only); zero them for the segment sum
    mask = torch.cat([b.mask.reshape(-1) for b in lin.buckets])
    ref = tlz.segment_sum(torch.cat(rows) * mask[:, None], seg,
                          lin.num_cameras)
    monkeypatch.setattr(tlz, "_CSR_CHUNK_SLOTS", 64)  # several chunks
    got = tlz.csr_cam_reduce(rows, lin.cam_csr, lin.num_cameras)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-12,
                               atol=1e-12)


def test_run_tree_sums_each_target():
    rng = np.random.default_rng(6)
    counts = rng.integers(1, 20, size=40)
    target = np.repeat(np.arange(40), counts)
    target = np.concatenate([target, np.full(5, 40)])  # pad runs
    tree = build_run_tree(target, 40)
    rows = rng.normal(size=(target.size, 3))
    acc = rows.copy()
    for d, s in tree.passes:
        assert np.unique(d).size == d.size and not np.isin(d, s).any()
        acc[d] += acc[s]
    np.testing.assert_array_equal(target[tree.head], np.arange(40))
    ref = np.zeros((41, 3))
    np.add.at(ref, target, rows)
    np.testing.assert_allclose(acc[tree.head], ref[:40], rtol=1e-12)
    assert build_run_tree(np.arange(5), 9).passes == ()


def test_stream_reducers_equal_segment_sums(synthetic_problem):
    """The stream reducers (K1's twin, the run trees) against segment
    sums of per-slot products on the CPU: pair blocks of two distinct
    K = 3 tables, signed camera grams and camera row sums."""
    tbp = t_bucketize(synthetic_problem, pow2_from=9)
    lin = t_create(tbp, TOptions(solver_type=TSolver.SCHUR_COMPLEMENT),
                   torch.float64, CPU)
    assert any(tr is not None for st in lin.cam_stream.run_tree
               for tr in st), "no camera with two runs: no tree to test"
    rng = np.random.default_rng(7)
    A = tuple(torch.as_tensor(rng.normal(size=(b.cam_idx.shape[0],
                                               b.cam_idx.shape[1] * 27)))
              for b in lin.buckets)
    B = tuple(torch.as_tensor(rng.normal(size=a.shape)) for a in A)
    N = lin.num_cameras
    ps = lin.pair_index
    gram = tlz.cam_gram_stream([(A, A, 1.0), (A, B, -1.0)], lin.buckets,
                               lin.cam_stream)
    rows = tlz.cam_reduce_stream(A, lin.buckets, lin.cam_stream)
    pairs = tlz.pair_outer_stream(A, B, lin.buckets, ps)
    g_ref = torch.zeros((N, 81), dtype=torch.float64)
    r_ref = torch.zeros((N, 27), dtype=torch.float64)
    p_ref = torch.zeros((ps.num_pairs, 81), dtype=torch.float64)
    code = ps.pair_row * N + ps.pair_col
    for a, b_, bk in zip(A, B, lin.buckets):
        L, n = bk.cam_idx.shape
        a3, b3 = a.reshape(L, n, 3, 9), b_.reshape(L, n, 3, 9)
        m = bk.mask
        g = (torch.einsum("lnki,lnkj->lnij", a3, a3)
             - torch.einsum("lnki,lnkj->lnij", a3, b3))
        g_ref.index_add_(0, bk.cam_idx[m], g[m].reshape(-1, 81))
        r_ref.index_add_(0, bk.cam_idx[m], a.reshape(L, n, 27)[m])
        rows_l = torch.arange(L)
        for i in range(n):
            for j in range(i + 1, n):
                ok = m[:, i] & m[:, j]
                ci, cj = bk.cam_idx[ok, i], bk.cam_idx[ok, j]
                # the first side is the observation of the lower camera
                lo = torch.where(ci <= cj, i, j)
                hi = torch.where(ci <= cj, j, i)
                r = rows_l[ok]
                prod = torch.einsum("lki,lkj->lij", a3[r, lo],
                                    b3[r, hi]).reshape(-1, 81)
                pid = torch.searchsorted(code, torch.minimum(ci, cj) * N
                                         + torch.maximum(ci, cj))
                p_ref.index_add_(0, pid, prod)
    for got, ref, what in ((gram, g_ref, "gram"), (rows, r_ref, "rows"),
                           (pairs, p_ref, "pairs")):
        np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-12,
                                   atol=1e-12, err_msg=what)


def test_reduction_alg_gives_the_same_sqrt_attempt(synthetic_problem):
    """The implicit SQUARE_ROOT operator with the camera CSR (default)
    and with segment sums (reduction_alg=0): the same attempt."""
    js = j_initial(j_bucketize(synthetic_problem, pow2_from=9), np.float64)
    out = []
    for alg in (1, 0):
        tbp = t_bucketize(synthetic_problem, pow2_from=9)
        lin = t_create(tbp, TOptions(sqrt_rcs_mode="implicit",
                                     reduction_alg=alg), torch.float64, CPU)
        assert (lin.cam_csr is None) == (alg == 0)
        s = _state(js, np.float64)
        lins, ps, _ = lin.stage1(s.cams, s.lm_ps)
        aux = lin.stage2(lins, torch.tensor(LAM, dtype=torch.float64))
        inc, s2, it, _ = lin.lsolve(lins, aux)
        cams, lm, ld = lin.apply(s.cams, s.lm_ps, lins, s2, ps, inc)
        out.append((ps, s2.b, inc, it, ld, cams.q))
    (a, b) = out
    assert a[3] == b[3]
    for x, y in zip(a[:3] + a[4:], b[:3] + b[4:]):
        _close(x, y, 1e-10, "reduction_alg 1 vs 0")
