"""The port's two pair gathers, "stream" and "obs", against the JAX
package and against each other on the conftest problem (12 cameras, 200
landmarks), in float32 and float64.

(a) The host builder of the obs index (build_pair_csr) gives arrays
    equal to the JAX package's.
(b) The reducers on the same seeded numpy inputs, within rel 1e-12 in
    float64 and 1e-5 in float32 of each output's largest magnitude:
    csr_pair_outer with the default chunk budget and with one run per
    chunk (the byte-budget knob _PAIR_CHUNK_BYTES set to 1), and the
    stream reducers pair_outer_stream, cam_gram_stream and
    cam_reduce_stream over the default stream index and over one built
    with a slot cap of 96 (several sub-streams per bucket, run trees of
    two passes), the JAX package's scan and scatter-add against the
    port's slot gathers and run trees.
(c) One LM attempt and one short solve (the JAX host loop at
    num_devices=1 on the reference attempt's linearizer): each JAX
    reference is made once per module with the options of its first
    port variant (the obs gather, dense mode), and the port's other
    routes are held against it: SQUARE_ROOT and SC dense and BSR with
    obs (without the camera CSR too: reduction_alg=0), PoBA dense and
    BSR with obs. Tolerances: float64 1e-8; float32 1e-4 on the pose
    scale and b, 2e-3 on the CG-amplified components and the costs
    (tests/test_solver_equivalence.py's split).
(d) One attempt of the obs gather against the stream gather, port only,
    for every solver, dense and BSR: the same CG count, increments,
    model cost decrease and cost, at rel 1e-12 in float64 and the
    tolerances of (c) in float32.
(e) Which indices each route builds.
"""

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from rootba_tpu.bal import bucketing as jbk
from rootba_tpu.config.options import SolverOptions as JOptions
from rootba_tpu.config.options import SolverType as JSolver
from rootba_tpu.solver import linearization as jlz
from rootba_tpu.solver.lm import create_linearizer as j_create
from rootba_tpu.solver.lm import initial_state as j_initial
from rootba_tpu.solver.lm import optimize_lm as j_optimize_lm
from rootba_tpu_torch.bal import bucketing as tbk
from rootba_tpu_torch.config.options import SolverOptions as TOptions
from rootba_tpu_torch.config.options import SolverType as TSolver
from rootba_tpu_torch.solver import linearization as tlz
from rootba_tpu_torch.solver import lm as tlm
from rootba_tpu_torch.solver import pair_stream as tps
from rootba_tpu_torch.solver.lm import create_linearizer as t_create
from rootba_tpu_torch.solver.lm import state_from_numpy

torch.set_num_threads(1)

CPU = torch.device("cpu")
LAM = 1e-3
# a slot cap at which the conftest problem's buckets split into several
# sub-streams and both stream indices have run trees (two passes for the
# pairs): the default build has one sub-stream per bucket
SMALL_CAP = 96


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


@pytest.fixture(scope="module")
def host(synthetic_problem):
    """Both packages' bucketings of the problem (equal arrays)."""
    return (jbk.bucketize(synthetic_problem, pow2_from=9),
            tbk.bucketize(synthetic_problem, pow2_from=9))


# ---------------------------------------------------------------------------
# (a) the host builders


def _assert_same(got, ref, what):
    assert type(got).__name__ == type(ref).__name__
    for name in ref._fields:
        a, b = getattr(got, name), getattr(ref, name)
        if isinstance(b, tuple):
            assert len(a) == len(b), (what, name)
            for x, y in zip(a, b):
                np.testing.assert_array_equal(np.asarray(x), np.asarray(y),
                                              err_msg=f"{what}: {name}")
        else:
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                          err_msg=f"{what}: {name}")
            assert np.asarray(a).dtype == np.asarray(b).dtype, (what, name)


@pytest.mark.parametrize("kw", [{}, dict(grid_n=16, dense_grid=True),
                                dict(dense_grid=False)])
def test_builders_match_jax(host, kw):
    jbp, tbp = host
    N = jbp.num_cameras
    ref = jbk.build_pair_csr(jbp.buckets, N, **kw)
    got = tbk.build_pair_csr(tbp.buckets, N, **kw)
    _assert_same(got, ref, f"build_pair_csr {kw}")


# ---------------------------------------------------------------------------
# (b) the reducers on seeded inputs


def _jbuckets(bp):
    return [jlz.BucketIndex(obs_uv=jnp.asarray(b.obs_uv),
                            cam_idx=jnp.asarray(b.cam_idx),
                            mask=jnp.asarray(b.mask),
                            lm_mask=jnp.asarray(b.lm_mask))
            for b in bp.buckets]


def _inputs(bp, dtype, seed=7):
    """Seeded per-bucket factor tables: W and T [L, n*27], HT (T's
    partner), Jp [L, n*18] and contribution rows [L, n*9]."""
    rng = np.random.default_rng(seed)
    out = {k: [] for k in ("W", "HT", "T", "Jp", "C")}
    widths = dict(W=27, HT=27, T=27, Jp=18, C=9)
    for b in bp.buckets:
        L, n = b.cam_idx.shape
        for k, w in widths.items():
            out[k].append(rng.normal(size=(L, n * w)).astype(dtype))
    return out


def _as(tabs, kind, K, pkg, dtype):
    """Per-bucket numpy tables as a reducer's input in `pkg`: per-bucket
    tables ("parts") or the flat per-obs [O, K, 9] array ("flat")."""
    if pkg == "jax":
        conv = jnp.asarray
    else:
        def conv(a):
            return torch.as_tensor(a, dtype=_tdtype(dtype))
    if kind == "parts":
        return tuple(conv(t) for t in tabs)
    return conv(np.concatenate([t.reshape(-1, K, 9) for t in tabs]))


_JREF = {}


def _jref(key, fn):
    """A JAX reducer output made once per module (the port's variants
    of one input share it)."""
    if key not in _JREF:
        _JREF[key] = np.asarray(fn())
    return _JREF[key]


@pytest.fixture(params=["default", "tiny"])
def chunks(request, monkeypatch):
    """The port's gather-and-fold chunk budget: the default, or one run
    of 64 slots per chunk."""
    if request.param == "tiny":
        monkeypatch.setattr(tlz, "_PAIR_CHUNK_BYTES", 1)
    return request.param


def _tol(dtype):
    return 1e-5 if dtype == np.float32 else 1e-12


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_csr_pair_outer_matches_jax(host, dtype, chunks):
    jbp, tbp = host
    N = jbp.num_cameras
    x = _inputs(jbp, dtype)
    jidx = jlz.PairCsrIndex.from_host(jbk.build_pair_csr(jbp.buckets, N))
    tidx = tlz.PairCsrIndex.from_host(tbk.build_pair_csr(tbp.buckets, N),
                                      CPU)
    for a, b in (("W", "W"), ("HT", "T")):
        def jax_side(a=a, b=b):
            fa = _as(x[a], "flat", 3, "jax", dtype)
            fb = fa if a == b else _as(x[b], "flat", 3, "jax", dtype)
            return jax.jit(lambda u, v, p: jlz.csr_pair_outer(
                u, u if a == b else v, p))(fa, fb, jidx)

        ref = _jref(("csr_pair_outer", a, b, dtype), jax_side)
        fa = _as(x[a], "flat", 3, "torch", dtype)
        fb = fa if a == b else _as(x[b], "flat", 3, "torch", dtype)
        got = tlz.csr_pair_outer(fa, fb, tidx)
        _close(got, ref, _tol(dtype), f"csr_pair_outer {a} {b} {chunks}")


def _stream_indices(jbp, tbp, cap):
    """Both packages' pair and camera stream indices, the default builds
    (the port's pair index built on the device, as the solvers do) or
    with the slot cap `cap`."""
    N = jbp.num_cameras
    kw = {} if cap is None else dict(slot_cap=cap)
    jp = jlz.PairStreamIndex.from_host(jbk.build_pair_stream(
        jbp.buckets, N, **kw))
    jc = jlz.CamStreamIndex.from_host(jbk.build_cam_stream(
        jbp.buckets, N, **kw))
    tp, _ = tps.build_pair_stream_index(tbp.buckets, N, CPU, **kw)
    tc = tlz.CamStreamIndex.from_host(tbk.build_cam_stream(
        tbp.buckets, N, **kw), tbp.buckets, CPU)
    return jp, jc, tp, tc


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("reducer", ["pair_outer_stream", "cam_gram_stream",
                                     "cam_reduce_stream"])
@pytest.mark.parametrize("index", ["default", "small_cap"])
def test_stream_reducers_match_jax(host, dtype, reducer, index):
    """The stream reducers on per-bucket tables: pair products of one
    table with itself and of two tables, signed camera grams over a
    table shared by both sides of one term and two tables of another,
    and camera sums of 9-wide rows."""
    jbp, tbp = host
    cap = SMALL_CAP if index == "small_cap" else None
    jp, jc, tp, tc = _stream_indices(jbp, tbp, cap)
    subs = sum(len(t) for t in tp.run_tree)
    assert (subs > len(tp.stream_bucket)) == (index == "small_cap")
    assert any(tr is not None for t in tc.run_tree for tr in t)
    jb = _jbuckets(jbp)
    tb = tlm.make_bucket_indices(tbp, _tdtype(dtype), CPU)
    N = jbp.num_cameras
    x = _inputs(jbp, dtype)

    def j(k):
        return _as(x[k], "parts", None, "jax", dtype)

    def t(k):
        return _as(x[k], "parts", None, "torch", dtype)

    def ref(key, fn, *args):
        return _jref((reducer, index, dtype) + key,
                     lambda: jax.jit(fn)(*args))

    what = f"{reducer} {index}"
    if reducer == "pair_outer_stream":
        for a, b in (("W", "W"), ("HT", "T")):
            want = ref((a, b), lambda u, v, bk, s, same=a == b:
                       jlz.pair_outer_stream(u, u if same else v, bk, s),
                       j(a), j(b), jb, jp)
            ta = t(a)
            got = tlz.pair_outer_stream(ta, ta if a == b else t(b), tb, tp)
            _close(got, want, _tol(dtype), f"{what} {a} {b}")
    elif reducer == "cam_gram_stream":
        want = ref((), lambda p, h, tt, bk, s: jlz.cam_gram_stream(
            [(p, p, 1.0), (h, tt, -1.0)], bk, s, N),
            j("Jp"), j("HT"), j("T"), jb, jc)
        jpt = t("Jp")
        got = tlz.cam_gram_stream([(jpt, jpt, 1.0), (t("HT"), t("T"), -1.0)],
                                  tb, tc)
        _close(got, want, _tol(dtype), what)
    else:
        want = ref((), lambda c, bk, s: jlz.cam_reduce_stream(c, bk, s, N),
                   j("C"), jb, jc)
        _close(tlz.cam_reduce_stream(t("C"), tb, tc), want, _tol(dtype),
               what)


# ---------------------------------------------------------------------------
# (c) attempts and solves against the JAX package

SQRT, SC, POBA = "SQUARE_ROOT", "SCHUR_COMPLEMENT", "POWER_SCHUR_COMPLEMENT"
BSR = dict(dense_rcs_max_cameras=4)
OBS = dict(pair_gather="obs")
STREAM = dict(pair_gather="stream")
# family: (solver, dtypes, the port's variants; the first variant's
# options make the JAX reference)
FAMILIES = {
    "sqrt": (SQRT, ("float32", "float64"), {
        "dense-obs": OBS, "bsr-obs": dict(OBS, **BSR),
        # the camera CSR off: the obs route's diagonal blocks by
        # per-observation products and a segment sum
        "bsr-obs-segsum": dict(OBS, reduction_alg=0, **BSR)}),
    "sc": (SC, ("float32", "float64"), {
        "dense-obs": OBS, "bsr-obs": dict(OBS, **BSR),
        "dense-obs-segsum": dict(OBS, reduction_alg=0)}),
    "poba": (POBA, ("float32", "float64"), {
        "dense-obs": OBS, "bsr-obs": dict(OBS, **BSR)}),
}


def _solve_opts(use_double: bool) -> dict:
    return dict(verbosity_level=0, function_tolerance=1e-5,
                use_double=use_double,
                max_num_iterations=6 if use_double else 3)


def _tols(f32: bool):
    """(tolerance on the pose scale and b, tolerance on the CG-amplified
    components and the costs)."""
    return (1e-4, 2e-3) if f32 else (1e-8, 1e-8)


@pytest.fixture(scope="module",
                params=[(f, d) for f, v in FAMILIES.items() for d in v[1]],
                ids=lambda p: f"{p[0]}-{p[1]}")
def jax_family(request, synthetic_problem):
    """The JAX attempt and host-loop solve of a family's first variant
    (one device, separate stage programs; the solve reuses them)."""
    family, dname = request.param
    solver, _, variants = FAMILIES[family]
    dtype = np.dtype(dname)
    extra = next(iter(variants.values()))
    bp = jbk.bucketize(synthetic_problem, pow2_from=9)
    opts = JOptions(solver_type=JSolver(solver), host_fused_attempt=False,
                    num_devices=1, lm_loop="host",
                    **_solve_opts(dtype == np.float64), **extra)
    lin = j_create(bp, opts, dtype.type)
    s = j_initial(bp, dtype.type)
    lins, ps, _ = lin._stage1_fn(lin.consts, s.cams, s.lm_ps)
    aux = lin._stage2_fn(lin.consts, lins, np.asarray(LAM, dtype))
    inc, s2, it, _ = lin._lsolve_fn(lin.consts, lins, aux)
    cams, lm, ld = lin._apply_fn(lin.consts, s.cams, s.lm_ps, lins, s2, ps,
                                 inc)
    _, summary = j_optimize_lm(lin.bp, opts, linearizer=lin)
    ref = dict(ps=ps, b=s2.b, inc=inc, it=int(it), ld=float(ld), q=cams.q,
               t=cams.t, lm=np.concatenate([np.asarray(p).ravel()
                                            for p in lm]))
    state = {"q": s.cams.q, "t": s.cams.t, "intr": s.cams.intr,
             "lm_ps": s.lm_ps}
    return family, dtype, ref, state, summary


def _port_attempt(tbp, solver, extra, state, tdtype):
    """One stage1 / stage2 / solve / apply of the port from `state`."""
    lin = t_create(tbp, TOptions(solver_type=TSolver(solver),
                                 use_double=tdtype == torch.float64,
                                 **extra), tdtype, CPU)
    s = state_from_numpy(state, tdtype, CPU)
    lins, ps, fail = lin.stage1(s.cams, s.lm_ps)
    aux = lin.stage2(lins, torch.tensor(LAM, dtype=tdtype))
    inc, s2, it, _ = lin.lsolve(lins, aux)
    cams, lm, ld = lin.apply(s.cams, s.lm_ps, lins, s2, ps, inc)
    return lin, dict(fail=int(fail), it=int(it), ps=ps, b=s2.b, inc=inc,
                     ld=float(ld), q=cams.q, t=cams.t,
                     lm=torch.cat([p.reshape(-1) for p in lm]),
                     cost=float(lin.error(cams, lm).all.error))


def test_attempt_matches_jax(jax_family, synthetic_problem):
    family, dtype, ref, state, _ = jax_family
    solver, _, variants = FAMILIES[family]
    f32 = dtype == np.float32
    tol, tol_cg = _tols(f32)
    tbp = tbk.bucketize(synthetic_problem, pow2_from=9)
    for name, extra in variants.items():
        _, got = _port_attempt(tbp, solver, extra, state, _tdtype(dtype))
        what = f"{family} {name} {dtype}"
        assert got["fail"] == 0 and got["it"] == ref["it"], what
        for k in ("ps", "b"):
            _close(got[k], ref[k], tol, f"{what}: {k}")
        for k in ("inc", "q", "t", "lm"):
            _close(got[k], ref[k], tol_cg, f"{what}: {k}")
        np.testing.assert_allclose(got["ld"], ref["ld"], rtol=tol_cg,
                                   err_msg=f"{what}: l_diff")


def test_solve_matches_jax(jax_family, synthetic_problem):
    family, dtype, _, _, j = jax_family
    solver, _, variants = FAMILIES[family]
    use_double = dtype == np.float64
    ji = j.iterations
    for name, extra in variants.items():
        t = tlm.bundle_adjust(
            copy.deepcopy(synthetic_problem),
            TOptions(solver_type=TSolver(solver),
                     **_solve_opts(use_double), **extra), device="cpu")
        ti = t.iterations
        what = f"{family} {name} {dtype}"
        assert len(ti) == len(ji), what
        assert ([i.step_is_successful for i in ti]
                == [i.step_is_successful for i in ji]), what
        assert ([i.linear_solver_iterations for i in ti]
                == [i.linear_solver_iterations for i in ji]), what
        np.testing.assert_allclose([i.cost.all.error for i in ti],
                                   [i.cost.all.error for i in ji],
                                   rtol=1e-8 if use_double else 2e-3,
                                   err_msg=what)
        assert ti[-1].cost.all.error < ti[0].cost.all.error


# ---------------------------------------------------------------------------
# (d) the obs gather against the stream gather


@pytest.fixture(scope="module")
def start_state(synthetic_problem):
    """The initial state of the conftest problem, as numpy arrays."""
    tbp = tbk.bucketize(synthetic_problem, pow2_from=9)
    s = tlm.initial_state(tbp, torch.float64, CPU)
    return tbp, {"q": s.cams.q.numpy(), "t": s.cams.t.numpy(),
                 "intr": s.cams.intr.numpy(),
                 "lm_ps": [p.numpy() for p in s.lm_ps]}


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["float32", "float64"])
@pytest.mark.parametrize("mode", ["dense", "bsr"])
@pytest.mark.parametrize("solver", [SQRT, SC, POBA])
def test_obs_route_equals_stream_route(start_state, solver, mode, dtype):
    tbp, state = start_state
    f32 = dtype == torch.float32
    tol, tol_cg = _tols(f32) if f32 else (1e-12, 1e-12)
    extra = BSR if mode == "bsr" else {}
    slin, want = _port_attempt(tbp, solver, dict(STREAM, **extra), state,
                               dtype)
    olin, got = _port_attempt(tbp, solver, dict(OBS, **extra), state,
                              dtype)
    pair_of = "pairs" if solver == SQRT else "pair_index"
    assert isinstance(getattr(slin, pair_of), tlz.PairStreamIndex)
    assert isinstance(getattr(olin, pair_of), tlz.PairCsrIndex)
    assert (slin.bsr is not None) == (olin.bsr is not None) == (mode == "bsr")
    what = f"{solver} {mode} {dtype}"
    assert got["fail"] == want["fail"] == 0, what
    assert got["it"] == want["it"], what
    for k in ("ps", "b"):
        _close(got[k], want[k], tol, f"{what}: {k}")
    for k in ("inc", "q", "t", "lm"):
        _close(got[k], want[k], tol_cg, f"{what}: {k}")
    for k in ("ld", "cost"):
        np.testing.assert_allclose(got[k], want[k], rtol=tol_cg,
                                   err_msg=f"{what}: {k}")


# ---------------------------------------------------------------------------
# (e) the routes


@pytest.mark.parametrize("solver", [SQRT, SC, POBA])
def test_routes_build_their_indices(host, solver):
    """Each pair gather builds its pair and camera indices (obs: the
    camera CSR for the per-camera sums); the stream drops the camera CSR
    in SQUARE_ROOT BSR mode; the einsum layout builds no pair index."""
    _, tbp = host

    def make(**kw):
        return t_create(tbp, TOptions(solver_type=TSolver(solver), **kw),
                        torch.float64, CPU)

    pair_of = "pairs" if solver == SQRT else "pair_index"
    for kw, pair_t, cam_t in (
            (OBS, tlz.PairCsrIndex, type(None)),
            (STREAM, tlz.PairStreamIndex, tlz.CamStreamIndex)):
        for mode in ({}, BSR):
            lin = make(**kw, **mode)
            assert isinstance(getattr(lin, pair_of), pair_t), (kw, mode)
            assert isinstance(lin.cam_stream, cam_t), (kw, mode)
            assert (lin.bsr is not None) == bool(mode), (kw, mode)
            if solver == SQRT:
                assert lin.pair_slots == tlz.pair_slots(lin.pairs) > 0
                if mode:
                    # BSR mode drops the camera CSR that nothing reads
                    assert (lin.cam_csr is None) == (cam_t is not type(None))
    if solver == SQRT:
        lin = make(kernel_layout="einsum")
        assert isinstance(lin, tlm.SqrtLinearizer)
        assert getattr(lin, "pairs", None) is None
