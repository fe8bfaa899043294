"""The port's "strips" and "obs" pair gathers and the W-free sandwich
against the JAX package on the conftest problem (12 cameras, 200
landmarks), in float32 and float64.

(a) The host builders (build_pair_csr, build_pair_strips with
    min_group 1, 20 -- groups and a leftover stream -- 16384 and 0,
    also on a twin with buckets up to 32 wide, build_cam_strips) give
    arrays equal to the JAX package's.
(b) The reducers on the same seeded numpy inputs: csr_pair_outer,
    csr_pair_outer_strips (flat, with and without a leftover stream,
    and per-bucket), cam_reduce_strips, cam_gram_strips,
    sqrt_ww_pair_strips and sqrt_ww_diag_strips, within rel 1e-12 in
    float64 and 1e-5 in float32 of each output's largest magnitude. The
    port collapses each bucket's groups into one slot list; that its
    run rows keep the JAX package's order (so the same idx2 sums) is
    checked with the default chunk budget and with one run per chunk
    (the byte-budget knob _PAIR_CHUNK_BYTES set to 1).
(c) One LM attempt and one short solve (the JAX host loop at
    num_devices=1 on the reference attempt's linearizer): each JAX
    reference is made once per module with the options of its first
    port variant, and the port's other routes are held against it (the
    JAX package's routes agree to rounding): SQUARE_ROOT dense and BSR
    with strips (auto, i.e. a leftover stream here, and 0) and obs (in
    BSR mode also with reduction_alg=0: no camera CSR); the sandwich
    forced in both packages (_SANDWICH_MIN_SLOTS = 1) in dense and BSR
    mode; SC dense and BSR with strips and obs (dense also without the
    camera CSR); PoBA with strips in dense and BSR mode. Tolerances:
    float64 1e-8; float32 1e-4 on the pose scale and b, 2e-3 on the
    CG-amplified components and the costs
    (tests/test_solver_equivalence.py's split).
(d) Which indices each route builds.
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
from rootba_tpu.solver import sqrt_flat as jsf
from rootba_tpu.solver.lm import create_linearizer as j_create
from rootba_tpu.solver.lm import initial_state as j_initial
from rootba_tpu.solver.lm import optimize_lm as j_optimize_lm
from rootba_tpu_torch.bal import bucketing as tbk
from rootba_tpu_torch.config.options import SolverOptions as TOptions
from rootba_tpu_torch.config.options import SolverType as TSolver
from rootba_tpu_torch.solver import linearization as tlz
from rootba_tpu_torch.solver import lm as tlm
from rootba_tpu_torch.solver import sqrt_flat as tsf
from rootba_tpu_torch.solver.lm import create_linearizer as t_create
from rootba_tpu_torch.solver.lm import state_from_numpy

torch.set_num_threads(1)

CPU = torch.device("cpu")
LAM = 1e-3
MIXED = 20  # a min_group with both strip groups and a leftover stream here


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


@pytest.mark.parametrize("builder,kw", [
    ("build_pair_csr", {}),
    ("build_pair_csr", dict(grid_n=16, dense_grid=True)),
    ("build_pair_csr", dict(dense_grid=False)),
    ("build_pair_strips", dict(min_group=1)),
    ("build_pair_strips", dict(min_group=MIXED, grid_n=16)),
    ("build_pair_strips", dict(min_group=16384)),
    ("build_pair_strips", dict(min_group=0, dense_grid=False)),
    ("build_cam_strips", dict(min_group=1)),
    ("build_cam_strips", dict(min_group=MIXED)),
    ("build_cam_strips", dict(min_group=16384)),
    ("build_cam_strips", dict(min_group=0))])
def test_builders_match_jax(host, builder, kw):
    jbp, tbp = host
    N = jbp.num_cameras
    ref = getattr(jbk, builder)(jbp.buckets, N, **kw)
    got = getattr(tbk, builder)(tbp.buckets, N, **kw)
    _assert_same(got, ref, f"{builder} {kw}")


@pytest.mark.parametrize("min_group", [0, 7, 64, 16384])
def test_pair_strips_match_jax_on_wide_buckets(min_group):
    """build_pair_strips, which sorts and pads every pattern of a bucket
    at once where the JAX package loops over them, on a clustered twin
    with buckets up to 32 observations per landmark (496 patterns):
    groups only, groups and a leftover stream, the leftover only."""
    from rootba_tpu.bal.synthetic import generate_synthetic_bal

    p = generate_synthetic_bal(num_cams=30, num_lms=500,
                               mean_obs_per_lm=24.0, pixel_noise=1.0, seed=3,
                               structure="clustered", track_sigma=1.0,
                               window_stretch=2.0, p_far=0.02,
                               max_window_frac=0.5)
    p.normalize(100.0)
    p.filter_obs(0.1)
    jbp = jbk.bucketize(p, pow2_from=9)
    tbp = tbk.bucketize(p, pow2_from=9)
    assert max(b.cam_idx.shape[1] for b in tbp.buckets) >= 32
    ref = jbk.build_pair_strips(jbp.buckets, jbp.num_cameras,
                                min_group=min_group, grid_n=64)
    got = tbk.build_pair_strips(tbp.buckets, tbp.num_cameras,
                                min_group=min_group, grid_n=64)
    _assert_same(got, ref, f"wide buckets, min_group {min_group}")


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
    partner), Jp [L, n*18], Q1h [L, n*6] and contribution rows
    [L, n*9]."""
    rng = np.random.default_rng(seed)
    out = {k: [] for k in ("W", "HT", "T", "Jp", "Q", "C")}
    widths = dict(W=27, HT=27, T=27, Jp=18, Q=6, C=9)
    for b in bp.buckets:
        L, n = b.cam_idx.shape
        for k, w in widths.items():
            out[k].append(rng.normal(size=(L, n * w)).astype(dtype))
    return out


def _as(tabs, kind, K, pkg, dtype):
    """Per-bucket numpy tables as a reducer's input in `pkg`: per-bucket
    tables ("parts") or the flat per-obs array ("flat": [O, K, 9], or
    [O, 9] for K None)."""
    if pkg == "jax":
        conv = jnp.asarray
    else:
        def conv(a):
            return torch.as_tensor(a, dtype=_tdtype(dtype))
    if kind == "parts":
        return tuple(conv(t) for t in tabs)
    flat = np.concatenate([t.reshape(-1, 9 * (K or 1)) for t in tabs])
    return conv(flat.reshape(-1, K, 9) if K else flat)


# (index, its min_group, the input forms it takes)
STRIP_INDICES = {"mixed": (MIXED, ("flat",)),
                 "leftover": (16384, ("flat",)),
                 "groups": (0, ("flat", "parts"))}

_JREF = {}


def _jref(key, fn):
    """A JAX reducer output made once per module (the chunk-budget
    variants of the port share it)."""
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


def _strip_indices(jbp, tbp, name):
    mg, forms = STRIP_INDICES[name]
    N = jbp.num_cameras
    jp = jlz.PairStripsIndex.from_host(
        jbk.build_pair_strips(jbp.buckets, N, min_group=mg))
    jc = jlz.CamStripsIndex.from_host(
        jbk.build_cam_strips(jbp.buckets, N, min_group=mg))
    tp = tlz.PairStripsIndex.from_host(
        tbk.build_pair_strips(tbp.buckets, N, min_group=mg), tbp.buckets,
        CPU)
    tc = tlz.CamStripsIndex.from_host(
        tbk.build_cam_strips(tbp.buckets, N, min_group=mg), tbp.buckets,
        CPU)
    return forms, jp, jc, tp, tc


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("index", list(STRIP_INDICES))
def test_strips_reducers_match_jax(host, dtype, index, chunks):
    """csr_pair_outer_strips, cam_reduce_strips and cam_gram_strips in
    every input form the index takes."""
    jbp, tbp = host
    forms, jp, jc, tp, tc = _strip_indices(jbp, tbp, index)
    jb = _jbuckets(jbp)
    tb = tlm.make_bucket_indices(tbp, _tdtype(dtype), CPU)
    x = _inputs(jbp, dtype)
    assert tp.has_leftover == (index != "groups")
    assert len(tp.bucket_ids) == len(set(tp.bucket_ids))
    for form in forms:
        def j(k, K):
            return _as(x[k], form, K, "jax", dtype)

        def t(k, K):
            return _as(x[k], form, K, "torch", dtype)

        what = f"{index} {form} {chunks}"
        # pair products, symmetric and two-table
        for a, b in (("W", "W"), ("HT", "T")):
            ref = _jref(("pairs", index, form, a, b, dtype), lambda: jax.jit(
                lambda u, v, bk, s: jlz.csr_pair_outer_strips(
                    u, u if a == b else v, bk, s))(j(a, 3), j(b, 3), jb, jp))
            ta = t(a, 3)
            got = tlz.csr_pair_outer_strips(
                ta, ta if a == b else t(b, 3), tb, tp)
            _close(got, ref, _tol(dtype), f"pair rows {a} {b} {what}")
        # per-camera sums of 9-wide rows
        ref = _jref(("reduce", index, form, dtype), lambda: jax.jit(
            lambda c, bk, s: jlz.cam_reduce_strips(c, bk, s))(
                j("C", None), jb, jc))
        got = tlz.cam_reduce_strips(t("C", None), tb, tc)
        _close(got, ref, _tol(dtype), f"cam_reduce_strips {what}")
        # per-camera grams: a table shared by both sides of one term
        # and two tables of another
        ref = _jref(("gram", index, form, dtype), lambda: jax.jit(
            lambda p, h, tt, bk, s: jlz.cam_gram_strips(
                [(p, p, 1.0), (h, tt, -1.0)], bk, s))(
                    j("Jp", 2), j("HT", 3), j("T", 3), jb, jc))
        jpt = t("Jp", 2)
        got = tlz.cam_gram_strips([(jpt, jpt, 1.0),
                                   (t("HT", 3), t("T", 3), -1.0)], tb, tc)
        _close(got, ref, _tol(dtype), f"cam_gram_strips {what}")


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_sandwich_reducers_match_jax(host, dtype, chunks):
    """sqrt_ww_pair_strips and sqrt_ww_diag_strips on the leftover-free
    index, and the sandwich against the W tables it replaces."""
    jbp, tbp = host
    _, jp, jc, tp, tc = _strip_indices(jbp, tbp, "groups")
    jb = _jbuckets(jbp)
    tb = tlm.make_bucket_indices(tbp, _tdtype(dtype), CPU)
    x = _inputs(jbp, dtype)
    jq, jj = (_as(x[k], "parts", None, "jax", dtype) for k in ("Q", "Jp"))
    tq, tj = (_as(x[k], "parts", None, "torch", dtype) for k in ("Q", "Jp"))
    got_p = tlz.sqrt_ww_pair_strips(tq, tj, tb, tp)
    _close(got_p, _jref(("sandwich_pairs", dtype), lambda: jax.jit(
        lambda q, p, bk, s: jlz.sqrt_ww_pair_strips(q, p, bk, s))(
            jq, jj, jb, jp)), _tol(dtype), f"sqrt_ww_pair_strips {chunks}")
    got_d = tlz.sqrt_ww_diag_strips(tq, tj, tb, tc)
    _close(got_d, _jref(("sandwich_diag", dtype), lambda: jax.jit(
        lambda q, p, bk, c: jlz.sqrt_ww_diag_strips(q, p, bk, c))(
            jq, jj, jb, jc)), _tol(dtype), f"sqrt_ww_diag_strips {chunks}")
    # the same rows from the W tables (K2's twin) and the Jp gram
    from rootba_tpu_torch.ops import fold

    W = tuple(fold.w_build(q, p, b.cam_idx.shape[1])
              for q, p, b in zip(tq, tj, tb))
    _close(got_p, tlz.csr_pair_outer_strips(W, W, tb, tp), 100 * _tol(dtype),
           "sandwich pairs vs W tables")
    _close(got_d, tlz.cam_gram_strips([(tj, tj, 1.0), (W, W, -1.0)], tb,
                                      tc), 100 * _tol(dtype),
           "sandwich diagonal vs W tables")


def test_leftover_needs_flat_tables(host):
    """Per-bucket tables cannot feed a leftover stream (the JAX
    package's error), and the sandwich needs a leftover-free index."""
    jbp, tbp = host
    _, _, _, tp, tc = _strip_indices(jbp, tbp, "mixed")
    tb = tlm.make_bucket_indices(tbp, torch.float64, CPU)
    x = _inputs(jbp, np.float64)
    W = _as(x["W"], "parts", 3, "torch", np.float64)
    with pytest.raises(ValueError, match="min_group=0"):
        tlz.csr_pair_outer_strips(W, W, tb, tp)
    with pytest.raises(ValueError, match="min_group=0"):
        tlz.cam_gram_strips([(W, W, 1.0)], tb, tc)
    with pytest.raises(ValueError, match="leftover-free"):
        tlz.sqrt_ww_pair_strips(W, W, tb, tp)


# ---------------------------------------------------------------------------
# (c) attempts and solves against the JAX package

SQRT, SC, POBA = "SQUARE_ROOT", "SCHUR_COMPLEMENT", "POWER_SCHUR_COMPLEMENT"
BSR = dict(dense_rcs_max_cameras=4)
STRIPS = dict(pair_gather="strips")
STRIPS0 = dict(pair_gather="strips", strip_min_group=0)
OBS = dict(pair_gather="obs")
# family: (solver, dtypes, sandwich forced, the port's variants; the
# first variant's options make the JAX reference)
FAMILIES = {
    "sqrt": (SQRT, ("float32", "float64"), False, {
        "dense-strips": STRIPS, "dense-strips0": STRIPS0,
        "dense-obs": OBS, "bsr-strips": dict(STRIPS, **BSR),
        "bsr-strips0": dict(STRIPS0, **BSR), "bsr-obs": dict(OBS, **BSR),
        # the camera CSR off: the obs route's diagonal blocks by
        # per-observation products and a segment sum
        "bsr-obs-segsum": dict(OBS, reduction_alg=0, **BSR)}),
    "sandwich": (SQRT, ("float64",), True, {
        "dense": STRIPS0, "bsr": dict(STRIPS0, **BSR),
        "bsr-half": dict(STRIPS0, bsr_pack_max_gb=0.0, **BSR)}),
    "sc": (SC, ("float32", "float64"), False, {
        "dense-strips": STRIPS, "dense-obs": OBS,
        "bsr-strips": dict(STRIPS, **BSR), "bsr-obs": dict(OBS, **BSR),
        "dense-obs-segsum": dict(OBS, reduction_alg=0)}),
    "poba": (POBA, ("float64",), False, {
        "dense-strips": STRIPS, "bsr-strips0": dict(STRIPS0, **BSR)}),
}


def _solve_opts(use_double: bool) -> dict:
    return dict(verbosity_level=0, function_tolerance=1e-5,
                use_double=use_double,
                max_num_iterations=6 if use_double else 3)


def _patched_sandwich(mp, forced: bool):
    if forced:
        mp.setattr(jsf, "_SANDWICH_MIN_SLOTS", 1)
        mp.setattr(tsf, "_SANDWICH_MIN_SLOTS", 1)


@pytest.fixture(scope="module",
                params=[(f, d) for f, v in FAMILIES.items() for d in v[1]],
                ids=lambda p: f"{p[0]}-{p[1]}")
def jax_family(request, synthetic_problem):
    """The JAX attempt and host-loop solve of a family's first variant
    (one device, separate stage programs; the solve reuses them)."""
    family, dname = request.param
    solver, _, sandwich, variants = FAMILIES[family]
    dtype = np.dtype(dname)
    extra = next(iter(variants.values()))
    with pytest.MonkeyPatch.context() as mp:
        _patched_sandwich(mp, sandwich)
        bp = jbk.bucketize(synthetic_problem, pow2_from=9)
        opts = JOptions(solver_type=JSolver(solver), host_fused_attempt=False,
                        num_devices=1, lm_loop="host",
                        **_solve_opts(dtype == np.float64), **extra)
        lin = j_create(bp, opts, dtype.type)
        s = j_initial(bp, dtype.type)
        lins, ps, _ = lin._stage1_fn(lin.consts, s.cams, s.lm_ps)
        aux = lin._stage2_fn(lin.consts, lins, np.asarray(LAM, dtype))
        inc, s2, it, _ = lin._lsolve_fn(lin.consts, lins, aux)
        cams, lm, ld = lin._apply_fn(lin.consts, s.cams, s.lm_ps, lins, s2,
                                     ps, inc)
        _, summary = j_optimize_lm(lin.bp, opts, linearizer=lin)
    ref = dict(ps=ps, b=s2.b, inc=inc, it=int(it), ld=float(ld), q=cams.q,
               t=cams.t, lm=np.concatenate([np.asarray(p).ravel()
                                            for p in lm]))
    state = {"q": s.cams.q, "t": s.cams.t, "intr": s.cams.intr,
             "lm_ps": s.lm_ps}
    return family, dtype, ref, state, summary


def test_attempt_matches_jax(jax_family, synthetic_problem, monkeypatch):
    family, dtype, ref, state, _ = jax_family
    solver, _, sandwich, variants = FAMILIES[family]
    _patched_sandwich(monkeypatch, sandwich)
    f32 = dtype == np.float32
    tol, tol_cg = (1e-4, 2e-3) if f32 else (1e-8, 1e-8)
    tdtype = _tdtype(dtype)
    tbp = tbk.bucketize(synthetic_problem, pow2_from=9)
    for name, extra in variants.items():
        lin = t_create(tbp, TOptions(solver_type=TSolver(solver),
                                     use_double=not f32, **extra), tdtype,
                       CPU)
        s = state_from_numpy(state, tdtype, CPU)
        lins, ps, fail = lin.stage1(s.cams, s.lm_ps)
        aux = lin.stage2(lins, torch.tensor(LAM, dtype=tdtype))
        inc, s2, it, _ = lin.lsolve(lins, aux)
        cams, lm, ld = lin.apply(s.cams, s.lm_ps, lins, s2, ps, inc)
        what = f"{family} {name} {dtype}"
        assert int(fail) == 0 and int(it) == ref["it"], what
        for k, v in (("ps", ps), ("b", s2.b)):
            _close(v, ref[k], tol, f"{what}: {k}")
        for k, v in (("inc", inc), ("q", cams.q), ("t", cams.t),
                     ("lm", torch.cat([p.reshape(-1) for p in lm]))):
            _close(v, ref[k], tol_cg, f"{what}: {k}")
        np.testing.assert_allclose(float(ld), ref["ld"], rtol=tol_cg,
                                   err_msg=f"{what}: l_diff")


def test_solve_matches_jax(jax_family, synthetic_problem, monkeypatch):
    family, dtype, _, _, j = jax_family
    solver, _, sandwich, variants = FAMILIES[family]
    _patched_sandwich(monkeypatch, sandwich)
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
# (d) the routes


@pytest.mark.parametrize("solver", [SQRT, SC, POBA])
def test_routes_build_their_indices(host, solver, monkeypatch):
    """Each pair gather builds its pair and camera indices (obs: the
    camera CSR); leftover-free strips and the stream drop the camera
    CSR in SQUARE_ROOT BSR mode; the sandwich skips stage1's Jp gram;
    the einsum layout still raises, naming ROADMAP."""
    _, tbp = host

    def make(**kw):
        return t_create(tbp, TOptions(solver_type=TSolver(solver), **kw),
                        torch.float64, CPU)

    pair_of = "pairs" if solver == SQRT else "pair_index"
    # (options, pair index, camera index, whether the camera index takes
    # every per-camera sum: no group here has fewer than 1 slot, so
    # min_group 1 leaves no leftover stream either)
    for kw, pair_t, cam_t, all_cams in (
            (STRIPS, tlz.PairStripsIndex, tlz.CamStripsIndex, False),
            (dict(STRIPS, strip_min_group=1), tlz.PairStripsIndex,
             tlz.CamStripsIndex, True),
            (STRIPS0, tlz.PairStripsIndex, tlz.CamStripsIndex, True),
            (OBS, tlz.PairCsrIndex, type(None), False),
            (dict(pair_gather="stream"), tlz.PairStreamIndex,
             tlz.CamStreamIndex, True)):
        for mode in ({}, BSR):
            lin = make(**kw, **mode)
            assert isinstance(getattr(lin, pair_of), pair_t), (kw, mode)
            assert isinstance(lin.cam_strips, cam_t), (kw, mode)
            assert (lin.bsr is not None) == bool(mode), (kw, mode)
            assert tlz.cam_parts_mode(lin.cam_strips) == all_cams, kw
            if solver == SQRT and mode:
                # BSR mode drops the camera CSR that nothing reads
                assert (lin.cam_csr is None) == all_cams, kw
    # strip_min_group=-1 resolves by the observation count
    lin = make(**STRIPS)
    assert lin.options.effective_strip_min_group(
        tbp.num_observations) == 16384
    assert getattr(lin, pair_of).has_leftover
    lin = make(**STRIPS, strip_auto_obs_threshold=10)
    assert not getattr(lin, pair_of).has_leftover
    if solver == SQRT:
        assert lin.with_gram and not lin.sandwich
        monkeypatch.setattr(tsf, "_SANDWICH_MIN_SLOTS", 1)
        lin = make(**STRIPS0)
        assert lin.sandwich and not lin.with_gram
        assert not make(**STRIPS).sandwich  # needs leftover-free strips
        # the einsum layout builds no pair index at all
        assert isinstance(make(kernel_layout="einsum"), tlm.SqrtLinearizer)
