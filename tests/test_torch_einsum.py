"""The port's einsum layout of the SQUARE_ROOT solver (solver/sqrt_qr.py,
solver/lm.SqrtLinearizer) against the JAX package's SqrtLinearizer on
the conftest problem (12 cameras, 200 landmarks), in float32 and
float64.

(a) One attempt (stage1, stage2, solve, apply) from the same state under
    the JACOBI, SCHUR_JACOBI and DIAGONAL preconditioners: pose scale,
    b, increment, CG count, l_diff, cameras and landmarks; the port with
    the camera-CSR matvec (default) and with segment sums
    (reduction_alg=0). float64 1e-9, float32 1e-4 and 2e-3 on the
    CG-amplified increment and l_diff.
(b) The stages on the same linearization (the JAX attempt's stage1
    output, copied): sqrt_stage2 (b, preconditioner factors, R, Q1h),
    sqrt_matvec (segment sum and camera CSR) on a seeded x, and
    sqrt_back_substitute (landmarks, l_diff) at the JAX increment;
    float64 1e-10, float32 1e-4 of each array's largest magnitude.
(c) Whole solves through both of the port's LM drivers against the JAX
    host loop (on the reference attempt's linearizer, one device):
    float64 6 LM iterations, float32 3; the same flags and CG counts,
    costs within rel 1e-8 / 2e-3.
(d) The einsum layout against the port's flat layout in implicit mode
    (the same operator): one attempt and a whole solve, the same CG
    counts, float64 1e-10 (1e-8 over a solve), float32 1e-4.
(e) linearization.segment_sum, the per-camera sum of the einsum stage2
    (and of every rank of a mesh), against a plain index_add_.

Each JAX reference is jitted once per module.
"""

import copy

import numpy as np
import pytest
import torch

import jax
from rootba_tpu.bal.bucketing import bucketize as j_bucketize
from rootba_tpu.config.options import PreconditionerType as JPrec
from rootba_tpu.config.options import SolverOptions as JOptions
from rootba_tpu.solver import sqrt_qr as jsq
from rootba_tpu.solver.lm import create_linearizer as j_create
from rootba_tpu.solver.lm import initial_state as j_initial
from rootba_tpu.solver.lm import optimize_lm as j_optimize_lm
from rootba_tpu_torch.bal.bucketing import bucketize as t_bucketize
from rootba_tpu_torch.config.options import PreconditionerType as TPrec
from rootba_tpu_torch.config.options import SolverOptions as TOptions
from rootba_tpu_torch.solver import lm as tlm
from rootba_tpu_torch.solver import sqrt_qr as tsq
from rootba_tpu_torch.solver.linearization import LinBucket
from rootba_tpu_torch.solver.lm import create_linearizer as t_create
from rootba_tpu_torch.solver.lm import state_from_numpy

torch.set_num_threads(1)

CPU = torch.device("cpu")
LAM = 1e-3
PRECS = (JPrec.SCHUR_JACOBI, JPrec.JACOBI, JPrec.DIAGONAL)


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
                use_double=use_double,
                max_num_iterations=6 if use_double else 3)


_JAX = {}


def _jax_ref(problem, prec, dtype):
    """The JAX einsum linearizer and one attempt at LAM, once per
    (preconditioner, precision)."""
    if (prec, dtype) in _JAX:
        return _JAX[prec, dtype]
    bp = j_bucketize(problem, pow2_from=9)
    opts = JOptions(kernel_layout="einsum", preconditioner_type=prec,
                    host_fused_attempt=False, num_devices=1,
                    **_solve_opts(dtype == np.float64))
    lin = j_create(bp, opts, dtype.type)
    assert type(lin).__name__ == "SqrtLinearizer"
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


def _port_attempt(problem, js, dtype, **opts):
    tbp = t_bucketize(problem, pow2_from=9)
    lin = t_create(tbp, TOptions(use_double=dtype == np.float64, **opts),
                   _tdtype(dtype), CPU)
    s = _state(js, dtype)
    lins, ps, fail = lin.stage1(s.cams, s.lm_ps)
    aux = lin.stage2(lins, torch.tensor(LAM, dtype=_tdtype(dtype)))
    inc, s2, it, _ = lin.lsolve(lins, aux)
    cams, lm, ld = lin.apply(s.cams, s.lm_ps, lins, s2, ps, inc)
    assert int(fail) == 0
    return lin, dict(ps=ps, b=s2.b, inc=inc, it=int(it), ld=float(ld),
                     q=cams.q, t=cams.t,
                     lm=np.concatenate([p.numpy().ravel() for p in lm]))


def _held(got, ref, dtype, what, tol=None):
    f32 = dtype == np.float32
    tol = tol or (1e-4 if f32 else 1e-9)
    tol_inc = 2e-3 if f32 else tol
    assert got["it"] == ref["it"], what
    for k in ("ps", "b", "q", "t", "lm"):
        _close(got[k], ref[k], tol, f"{what}: {k}")
    _close(got["inc"], ref["inc"], tol_inc, f"{what}: inc")
    np.testing.assert_allclose(got["ld"], ref["ld"], rtol=tol_inc,
                               err_msg=f"{what}: l_diff")


@pytest.fixture(scope="module",
                params=[(p, d) for p in PRECS
                        for d in ("float32", "float64")],
                ids=lambda p: f"{p[0].value.lower()}-{p[1]}")
def jax_attempt(request, synthetic_problem):
    prec, dname = request.param
    dtype = np.dtype(dname)
    return (prec, dtype) + _jax_ref(synthetic_problem, prec, dtype)


def test_attempt_matches_jax(jax_attempt, synthetic_problem):
    prec, dtype, jlin, _, js, _, _, ref = jax_attempt
    for variant, extra in (("csr", {}), ("segment_sum",
                                          dict(reduction_alg=0))):
        tlin, got = _port_attempt(
            synthetic_problem, js, dtype, kernel_layout="einsum",
            preconditioner_type=TPrec(prec.value), **extra)
        assert isinstance(tlin, tlm.SqrtLinearizer)
        assert (tlin.cam_csr is None) == (variant == "segment_sum")
        assert tlin.linear_solver_type == jlin.linear_solver_type
        _held(got, ref, dtype, f"{prec.value} {variant}")


def _port_lins(jlins, dtype):
    return tuple(LinBucket(Jp=_t(l.Jp, dtype), Jl=_t(l.Jl, dtype),
                           r=_t(l.r, dtype), Jl_scale=_t(l.Jl_scale, dtype))
                 for l in jlins)


@pytest.mark.parametrize("dname", ["float32", "float64"])
def test_stages_match_jax(dname, synthetic_problem):
    """sqrt_stage2, sqrt_matvec and sqrt_back_substitute on the JAX
    attempt's own linearization (SCHUR_JACOBI; the JACOBI and DIAGONAL
    factors against those references' stage2)."""
    dtype = np.dtype(dname)
    tol = 1e-4 if dtype == np.float32 else 1e-10
    jlin, _, js, jlins, jaux, ref = _jax_ref(synthetic_problem,
                                             JPrec.SCHUR_JACOBI, dtype)
    tlin = t_create(t_bucketize(synthetic_problem, pow2_from=9),
                    TOptions(kernel_layout="einsum"), _tdtype(dtype), CPU)
    lins = _port_lins(jlins, dtype)
    lam = torch.tensor(LAM, dtype=_tdtype(dtype))
    N = tlin.num_cameras
    s2 = tsq.sqrt_stage2(lins, tlin.buckets, lam, N)
    _close(s2.b, jaux.b, tol, "b")
    _close(s2.precond_chol, jaux.precond_chol, tol, "precond_chol")
    for k in ("R", "Q1h"):
        for i, (a, b) in enumerate(zip(getattr(s2, k), getattr(jaux, k))):
            _close(a, b, tol, f"{k}[{i}]")
    # the JACOBI and DIAGONAL references' stage2 (their stage1 is this
    # one: the preconditioner does not enter it)
    for prec, kw in ((JPrec.JACOBI, dict(precond_jacobi=True)),
                     (JPrec.DIAGONAL, dict(precond_diagonal=True))):
        got = tsq.sqrt_stage2(lins, tlin.buckets, lam, N, **kw)
        want = _jax_ref(synthetic_problem, prec, dtype)[4]
        _close(got.precond_chol, want.precond_chol, tol, prec.value)
    jbuckets, jcsr = jlin.consts

    x = np.random.default_rng(7).standard_normal((N, 9)).astype(dtype)
    want = jax.jit(lambda l, a, v: jsq.sqrt_matvec(
        l, jbuckets, a, N, v, csr=jcsr))(jlins, jaux, x)
    for csr in (None, tlin.cam_csr):
        got = tsq.sqrt_matvec(lins, tlin.buckets, s2, N, _t(x, dtype),
                              csr=csr)
        _close(got, want, tol, f"matvec csr={csr is not None}")

    lm_ps, ld = tsq.sqrt_back_substitute(
        lins, tlin.buckets, s2, _state(js, dtype).lm_ps,
        _t(ref["inc"], dtype), compensated=dtype == np.float32)
    _close(np.concatenate([p.numpy().ravel() for p in lm_ps]), ref["lm"],
           tol, "landmarks")
    np.testing.assert_allclose(float(ld), ref["ld"], rtol=tol,
                               err_msg="l_diff")


def _jax_solve(problem, dtype):
    lin, opts, *_ = _jax_ref(problem, JPrec.SCHUR_JACOBI, dtype)
    _, summary = j_optimize_lm(lin.bp, opts, linearizer=lin)
    return summary


@pytest.fixture(scope="module", params=["float32", "float64"])
def jax_solve(request, synthetic_problem):
    dtype = np.dtype(request.param)
    return dtype == np.float64, _jax_solve(synthetic_problem, dtype)


def _same_solve(t, j, tol):
    ti, ji = t.iterations, j.iterations
    assert len(ti) == len(ji)
    assert ([i.step_is_successful for i in ti]
            == [i.step_is_successful for i in ji])
    assert ([i.linear_solver_iterations for i in ti]
            == [i.linear_solver_iterations for i in ji])
    np.testing.assert_allclose([i.cost.all.error for i in ti],
                               [i.cost.all.error for i in ji], rtol=tol)
    assert t.termination_type == j.termination_type


@pytest.mark.parametrize("lm_loop", ["fused", "host"])
def test_solve_matches_jax(jax_solve, synthetic_problem, lm_loop):
    use_double, j = jax_solve
    t = tlm.bundle_adjust(
        copy.deepcopy(synthetic_problem),
        TOptions(kernel_layout="einsum",
                 **dict(_solve_opts(use_double), lm_loop=lm_loop)),
        device="cpu")
    _same_solve(t, j, 1e-8 if use_double else 2e-3)
    assert t.solver_type == j.solver_type == "bal_qr"
    assert t.iterations[-1].cost.all.error < t.iterations[0].cost.all.error
    assert all(i.stage2_time_in_seconds > 0 for i in t.iterations[1:])


@pytest.mark.parametrize("dname", ["float32", "float64"])
def test_einsum_equals_flat_implicit(dname, synthetic_problem):
    """The einsum layout and the flat layout's implicit mode apply the
    same operator: one attempt from the JAX initial state, then whole
    solves of both."""
    dtype = np.dtype(dname)
    f32 = dtype == np.float32
    _, _, js, _, _, _ = _jax_ref(synthetic_problem, JPrec.SCHUR_JACOBI,
                                 dtype)
    _, einsum = _port_attempt(synthetic_problem, js, dtype,
                              kernel_layout="einsum")
    flat_lin, flat = _port_attempt(synthetic_problem, js, dtype,
                                   sqrt_rcs_mode="implicit")
    assert not (flat_lin.explicit_rcs or flat_lin.bsr_rcs)
    _held(einsum, flat, dtype, "einsum vs flat implicit",
          tol=1e-4 if f32 else 1e-10)
    runs = [tlm.bundle_adjust(copy.deepcopy(synthetic_problem), TOptions(
        **dict(_solve_opts(not f32), lm_loop="fused"), **kw), device="cpu")
        for kw in (dict(kernel_layout="einsum"),
                   dict(sqrt_rcs_mode="implicit"))]
    _same_solve(*runs, 1e-4 if f32 else 1e-8)


@pytest.mark.parametrize("shape", [(7,), (9, 9)])
def test_segment_sum_matches_index_add(shape):
    """linearization.segment_sum (two levels of 64-row blocks, then the
    block sums, each a sorted accumulate) equals a plain index_add_ in
    float64, on skewed ids (one target holds 20,000 of the rows, so
    every level has blocks of it), on one row and on none."""
    from rootba_tpu_torch.solver.linearization import segment_sum

    rng = np.random.default_rng(11)
    for n, N in ((30_000, 40), (1, 3), (0, 3)):
        seg = torch.as_tensor(np.where(rng.random(n) < 2 / 3, N // 2,
                                       rng.integers(0, N, n)))
        data = torch.as_tensor(rng.standard_normal((n,) + shape))
        want = torch.zeros((N,) + shape, dtype=torch.float64).index_add_(
            0, seg, data)
        got = segment_sum(data, seg, N)
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-12,
                                   atol=1e-12 * max(n, 1))
