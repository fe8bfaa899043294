"""BSR mode (sqrt_rcs_mode="bsr"): the port's block-sparse reduced camera
system against the JAX package's on the CPU, and against the port's own
dense mode.

Function by function, on seeded random pair lists: the host index
(build_bsr_matvec), the level-2 run reduce, the in-place scale and
negate, the packed table and both matvecs (also against a dense numpy
product). Stage by stage, as tests/test_torch_stages.py does, on the
conftest problem in float32 and float64 and in both regimes (the packed
run-major table, and the half table with bsr_pack_max_gb = 0). Then
whole solves: BSR equals dense in the port, also on a problem without
camera pairs, and sqrt_rcs_mode="auto" picks BSR above
dense_rcs_max_cameras.

Tolerances, relative to each array's largest magnitude: float64 1e-9
(sums reordered); float32 1e-4 for the linearization and the assembled
tables, 2e-3 for what the CG solve amplifies; a BSR solve against the
dense one 2e-4 (float32) and 1e-9 (float64), the JAX package's
test_sqrt_bsr_vs_dense_rcs. Index builders and the packed table are
data movement: equal.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rootba_tpu.bal import bucketing as jbk
from rootba_tpu.bal.bucketing import bucketize as j_bucketize
from rootba_tpu.config.options import SolverOptions as JOptions
from rootba_tpu.solver import linearization as jlz
from rootba_tpu.solver import sqrt_flat as jsf
from rootba_tpu.solver.lm import create_linearizer as j_create
from rootba_tpu.solver.lm import initial_state as j_initial
from rootba_tpu_torch.bal import bucketing as tbk
from rootba_tpu_torch.bal.bucketing import bucketize as t_bucketize
from rootba_tpu_torch.config.options import SolverOptions as TOptions
from rootba_tpu_torch.solver import linearization as tlz
from rootba_tpu_torch.solver import sqrt_flat as tsf
from rootba_tpu_torch.solver.fused_lm import optimize_lm_fused
from rootba_tpu_torch.solver.lm import create_linearizer as t_create
from rootba_tpu_torch.solver.lm import state_from_numpy

torch.set_num_threads(1)

CPU = torch.device("cpu")
LAM = 1e-3
SYM = dict(bsr_pack_max_gb=0.0)


def _np(x):
    return np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)


def _close(got, ref, tol, what):
    got, ref = _np(got), _np(ref)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    scale = max(float(np.abs(ref).max()), 1e-30) if ref.size else 1.0
    np.testing.assert_allclose(got, ref, rtol=tol, atol=tol * scale,
                               err_msg=what)


def _pairs(seed, N, P):
    """P distinct camera pairs (row <= col, sorted as build_pair_stream
    gives them), a few of them self-pairs (a landmark that one camera
    sees twice)."""
    rng = np.random.default_rng(seed)
    iu, ju = np.triu_indices(N)
    sel = np.sort(rng.choice(iu.size, P, replace=False))
    return iu[sel].astype(np.int32), ju[sel].astype(np.int32)


def _indices(pair_row, pair_col, N, width=0):
    host_t = tbk.build_bsr_matvec(pair_row, pair_col, N, width)
    host_j = jbk.build_bsr_matvec(pair_row, pair_col, N, width)
    return (host_t, tlz.BsrMatvecIndex.from_host(host_t, CPU),
            host_j, jlz.BsrMatvecIndex.from_host(host_j))


# (seed, cameras, pairs, width): adaptive widths at two densities, a
# fixed width, and no pairs at all
INDEX_CASES = [(1, 37, 150, 0), (2, 80, 2600, 0), (3, 37, 150, 16),
               (4, 9, 0, 0)]


@pytest.mark.parametrize("seed,N,P,width", INDEX_CASES)
def test_build_bsr_matvec_matches_jax(seed, N, P, width):
    pr, pc = _pairs(seed, N, P)
    host_t, idx, host_j, _ = _indices(pr, pc, N, width)
    for name in ("blk_idx", "col_idx", "idx2"):
        a, b = getattr(host_t, name), getattr(host_j, name)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    R, W = idx.shape2d
    assert W == host_j.blk_idx.shape[1]
    assert idx.blk_idx.shape == (R * W,) and idx.blk_idx.dtype == torch.int32
    # sentinels: blk 2P and col N together, every real entry once
    pad = idx.blk_idx == 2 * P
    assert torch.equal(pad, idx.col_idx == N)
    assert int((~pad).sum()) == 2 * P
    assert int(idx.idx2.max()) <= R


@pytest.mark.parametrize("seed,N,P,width", INDEX_CASES[:3])
def test_level2_reduce_chunked_matches_jax(seed, N, P, width, monkeypatch):
    pr, pc = _pairs(seed, N, P)
    _, idx, _, jidx = _indices(pr, pc, N, width)
    R = idx.shape2d[0]
    V = idx.idx2.shape[1]
    rows = np.random.default_rng(seed).normal(size=(R + 1, 9))
    rows[R] = 0.0  # the dump row idx2's pad reads
    # a few segments per chunk, so the chunk loop and its tail run
    monkeypatch.setattr(tlz, "_LEVEL2_CHUNK_BYTES", 3 * V * 9 * 4)
    monkeypatch.setattr(jlz, "_LEVEL2_CHUNK_BYTES", 5 * V * 9 * 4)
    got = tlz._level2_reduce(torch.from_numpy(rows), idx.idx2)
    ref = jlz._level2_reduce(jnp.asarray(rows), jidx.idx2)
    _close(got, ref, 1e-12, "level2 vs jax")
    want = rows[np.asarray(idx.idx2)].sum(axis=1)
    _close(got, want, 1e-12, "level2 vs numpy")


def test_scale_neg_chunked_in_place(monkeypatch):
    rng = np.random.default_rng(7)
    N, P = 23, 101
    pr, pc = _pairs(7, N, P)
    Hup = rng.normal(size=(P, 81))
    ps = rng.uniform(0.5, 2.0, size=(N, 9))
    monkeypatch.setattr(tlz, "_FILL_CHUNK_ROWS", 16)  # 7 chunks + tail
    t = torch.from_numpy(Hup.copy())
    out = tlz._scale_neg_chunked(t, torch.from_numpy(ps),
                                 torch.from_numpy(pr).long(),
                                 torch.from_numpy(pc).long())
    assert out.data_ptr() == t.data_ptr()
    ref = jlz._scale_neg_chunked(jnp.asarray(Hup), jnp.asarray(ps),
                                 jnp.asarray(pr), jnp.asarray(pc))
    _close(out, ref, 1e-15, "scale_neg")
    empty = torch.zeros((0, 81), dtype=torch.float64)
    assert tlz._scale_neg_chunked(
        empty, torch.from_numpy(ps), torch.zeros(0, dtype=torch.int64),
        torch.zeros(0, dtype=torch.int64)).shape == (0, 81)


def _dense_product(half, diag, pr, pc, x):
    """y = H x with H assembled densely from the half table: block (r, c)
    of pair p, its transpose at (c, r), the diagonal blocks."""
    N = x.shape[0]
    H = np.zeros((N, 9, N, 9))
    for p, (r, c) in enumerate(zip(pr, pc)):
        B = half[p].reshape(9, 9)
        H[r, :, c, :] += B
        H[c, :, r, :] += B.T
    for i in range(N):
        H[i, :, i, :] += diag[i]
    return (H.reshape(9 * N, 9 * N) @ x.reshape(-1)).reshape(N, 9)


@pytest.mark.parametrize("seed,N,P,width", INDEX_CASES)
def test_pack_and_matvecs_match_jax(seed, N, P, width, dtype, monkeypatch):
    """bsr_pack_from_half, bsr_matvec_packed and bsr_matvec_sym against
    the JAX package and a dense numpy product, chunked with a tail;
    without pairs against numpy only (the JAX package's take from the
    empty half table raises)."""
    pr, pc = _pairs(seed, N, P)
    _, idx, _, jidx = _indices(pr, pc, N, width)
    # some camera is the row of one pair and the column of another,
    # so both directions of the table are read
    if P:
        assert set(pr[pr != pc]) & set(pc[pr != pc])
    rng = np.random.default_rng(seed + 100)
    half = rng.normal(size=(P, 81)).astype(dtype)
    diag = rng.normal(size=(N, 9, 9)).astype(dtype)
    x = rng.normal(size=(N, 9)).astype(dtype)
    monkeypatch.setattr(tlz, "_FILL_CHUNK_ROWS", 37)
    monkeypatch.setattr(tlz, "_MATVEC_CHUNK_ENTRIES", 5 * idx.width)
    th, td, tx = (torch.from_numpy(a) for a in (half, diag, x))
    packed = tlz.bsr_pack_from_half(th, idx)
    assert packed.shape == (idx.blk_idx.shape[0], 81)
    assert not packed[idx.blk_idx == 2 * P].any()
    y_pack = tlz.bsr_matvec_packed(packed, td, idx, tx)
    y_sym = tlz.bsr_matvec_sym(th, td, idx, tx)
    tol = 1e-5 if dtype == np.float32 else 1e-12
    want = _dense_product(half.astype(np.float64), diag.astype(np.float64),
                          pr, pc, x.astype(np.float64))
    _close(y_pack, want, tol, "packed vs numpy")
    _close(y_sym, want, tol, "sym vs numpy")
    if P:
        jpacked = jlz.bsr_pack_from_half(jnp.asarray(half), jidx)
        np.testing.assert_array_equal(_np(packed), np.asarray(jpacked))
        _close(y_pack, jlz.bsr_matvec_packed(
            jpacked, jnp.asarray(diag), jidx, jnp.asarray(x)), tol,
            "packed vs jax")
        _close(y_sym, jlz.bsr_matvec_sym(
            jnp.asarray(half), jnp.asarray(diag), jidx, jnp.asarray(x)),
            tol, "sym vs jax")


# ---------------------------------------------------------------------------
# stage by stage, from the same state, both packages in BSR mode


@pytest.fixture(scope="module", params=[
    ("float32", "packed"), ("float32", "sym"), ("float64", "packed"),
    ("float64", "sym")], ids=lambda p: "-".join(p))
def bsr_stages(request, synthetic_problem):
    name, regime = request.param
    dtype = np.dtype(name)
    tdtype = torch.float32 if dtype == np.float32 else torch.float64
    use_double = dtype == np.float64
    extra = dict(sqrt_rcs_mode="bsr", **(SYM if regime == "sym" else {}))

    jbp = j_bucketize(synthetic_problem, pow2_from=9)
    jlin = j_create(jbp, JOptions(use_double=use_double, **extra),
                    dtype.type)
    js = j_initial(jbp, dtype.type)
    jl, jps, _ = jlin._stage1_fn(jlin.consts, js.cams, js.lm_ps)
    lam = np.asarray(LAM, dtype)
    jaux = jlin._stage2_fn(jlin.consts, jl, lam)
    jinc, js2, jit, jterm = jlin._lsolve_fn(jlin.consts, jl, jaux)
    jcams, jlm, jld = jlin._apply_fn(jlin.consts, js.cams, js.lm_ps, jl,
                                     js2, jps, jinc)

    tbp = t_bucketize(synthetic_problem, pow2_from=9)
    tlin = t_create(tbp, TOptions(use_double=use_double, **extra), tdtype,
                    CPU)
    ts = state_from_numpy(
        {"q": js.cams.q, "t": js.cams.t, "intr": js.cams.intr,
         "lm_ps": js.lm_ps}, tdtype, CPU)
    tl, tps, tfail = tlin.stage1(ts.cams, ts.lm_ps)
    taux = tlin.stage2(tl, torch.tensor(LAM, dtype=tdtype))
    tinc, ts2, tit, tterm = tlin.lsolve(tl, taux)
    tcams, tlm, tld = tlin.apply(ts.cams, ts.lm_ps, tl, ts2, tps, tinc)
    return dict(
        dtype=dtype, regime=regime, jlin=jlin, tlin=tlin,
        j=dict(lin=jl, aux=jaux, inc=jinc, it=jit, term=jterm, cams=jcams,
               lm=jlm, ld=jld),
        t=dict(lin=tl, aux=taux, fail=tfail, inc=tinc, it=tit, term=tterm,
               cams=tcams, lm=tlm, ld=tld))


def _tols(st):
    return (1e-4, 2e-3) if st["dtype"] == np.float32 else (1e-9, 1e-9)


def test_bsr_route_and_index(bsr_stages):
    """Both packages take BSR mode in the same regime, with the same
    index and no dense block maps."""
    jlin, tlin = bsr_stages["jlin"], bsr_stages["tlin"]
    sym = bsr_stages["regime"] == "sym"
    assert jlin.bsr_rcs and tlin.bsr_rcs and not tlin.explicit_rcs
    assert bool(jlin.bsr_sym) == tlin.bsr_sym == sym
    assert not tlin.use_cg_kernel
    assert tlin.pairs.up_idx.numel() == tlin.pairs.lo_idx.numel() == 0
    jbsr = jlin.consts[5]
    assert tlin.bsr.width == jbsr.width
    for name in ("blk_idx", "col_idx", "idx2"):
        np.testing.assert_array_equal(_np(getattr(tlin.bsr, name)),
                                      np.asarray(getattr(jbsr, name)))
    assert bsr_stages["t"]["fail"] == 0


def test_bsr_stage1_keeps_the_gram(bsr_stages):
    tol, _ = _tols(bsr_stages)
    jl, tl = bsr_stages["j"]["lin"], bsr_stages["t"]["lin"]
    assert tl.diag_jp81 is not None
    _close(tl.diag_jp81, jl.diag_jp81, tol, "diag_jp81")
    _close(tl.pose_scale, jl.pose_scale, tol, "pose_scale")
    for b, (g, r) in enumerate(zip(tl.Jp, jl.Jp)):
        _close(g, r, tol, f"Jp[{b}]")


def test_bsr_table_diag_and_precond(bsr_stages):
    """stage2's table (packed [E, 81] or half [P, 81]), the diagonal
    blocks, their block-Cholesky factors and the RHS."""
    tol, _ = _tols(bsr_stages)
    (js2, (jtab, jdiag)) = bsr_stages["j"]["aux"]
    (ts2, (ttab, tdiag)) = bsr_stages["t"]["aux"]
    tlin = bsr_stages["tlin"]
    if bsr_stages["regime"] == "sym":
        assert ttab.shape == (tlin.pairs.num_pairs, 81)
    else:
        assert ttab.shape == (tlin.bsr.blk_idx.shape[0], 81)
    _close(ttab, jtab, tol, "table")
    _close(tdiag, jdiag, tol, "diag")
    _close(ts2.precond_chol, js2.precond_chol, tol, "precond_chol")
    _close(ts2.b, js2.b, tol, "b")


def test_assemble_rcs_bsr_both_forms(bsr_stages):
    """assemble_rcs_bsr's [2P, 81] table [-H_up; -H_up'] (beside the
    packed regime) and its half table (beside the symmetric one), from
    each package's own stage data."""
    tol, _ = _tols(bsr_stages)
    symmetric = bsr_stages["regime"] == "sym"
    jlin, tlin = bsr_stages["jlin"], bsr_stages["tlin"]
    jl, (js2, _) = bsr_stages["j"]["lin"], bsr_stages["j"]["aux"]
    tl, (ts2, _) = bsr_stages["t"]["lin"], bsr_stages["t"]["aux"]
    buckets, csr, cam_flat, pairs, cstrips, _ = jlin.consts
    jtab, jdiag = jsf.flat_assemble_rcs_bsr(
        jl, js2, cam_flat, pairs, tlin.num_cameras, csr=csr,
        buckets=buckets, cam_strips=cstrips, symmetric=symmetric)
    ttab, tdiag = tsf.flat_assemble_rcs_bsr(
        tl, ts2, tlin.pairs, tlin.num_cameras, tlin.buckets,
        tlin.cam_stream, symmetric=symmetric)
    P = tlin.pairs.num_pairs
    assert ttab.shape == ((P if symmetric else 2 * P), 81)
    _close(ttab, jtab, tol, "blocks")
    _close(tdiag, jdiag, tol, "diag")
    if not symmetric:
        perm = tlz._block_transpose(CPU)
        assert torch.equal(ttab[P:], ttab[:P][:, perm])


def test_bsr_solve_and_back_substitution(bsr_stages):
    _, tol_cg = _tols(bsr_stages)
    j, t = bsr_stages["j"], bsr_stages["t"]
    assert int(t["it"]) == int(j["it"]) > 1
    assert int(t["term"]) == int(j["term"])
    _close(t["inc"], j["inc"], tol_cg, "inc")
    np.testing.assert_allclose(float(t["ld"]), float(j["ld"]), rtol=tol_cg)
    _close(t["cams"].q, j["cams"].q, tol_cg, "q")
    _close(t["cams"].t, j["cams"].t, tol_cg, "t")
    _close(t["cams"].intr, j["cams"].intr, tol_cg, "intr")
    for b, (g, r) in enumerate(zip(t["lm"], j["lm"])):
        _close(g, r, tol_cg, f"lm_ps[{b}]")


# ---------------------------------------------------------------------------
# whole solves in the port: BSR against dense


def _one_step(bp, dtype, **opts):
    """One stage1 / stage2 / solve / apply of the port from the initial
    state: the components test_sqrt_bsr_vs_dense_rcs compares."""
    from rootba_tpu_torch.solver.lm import initial_state

    lin = t_create(bp, TOptions(use_double=dtype == torch.float64, **opts),
                   dtype, CPU)
    st = initial_state(bp, dtype, CPU)
    lins, ps, _ = lin.stage1(st.cams, st.lm_ps)
    inc, s2, _, _ = lin.lsolve(lins, lin.stage2(
        lins, torch.tensor(LAM, dtype=dtype)))
    cams, lm_ps, l_diff = lin.apply(st.cams, st.lm_ps, lins, s2, ps, inc)
    return lin, (ps, s2.b, inc, l_diff, cams.q,
                 torch.cat([p.reshape(-1) for p in lm_ps]))


def _bsr_vs_dense(bp, dtype, regime):
    tdtype = torch.float32 if dtype == np.float32 else torch.float64
    _, ref = _one_step(bp, tdtype, sqrt_rcs_mode="dense", pallas_cg="off")
    lin, got = _one_step(bp, tdtype, sqrt_rcs_mode="bsr",
                         **(SYM if regime == "sym" else {}))
    assert lin.bsr_rcs and lin.bsr_sym == (regime == "sym")
    rtol = 2e-4 if dtype == np.float32 else 1e-9
    for i, (a, b) in enumerate(zip(ref, got)):
        np.testing.assert_allclose(
            _np(b), _np(a), rtol=rtol, atol=rtol,
            err_msg=f"component {i} (port bsr vs dense rcs)")
    return lin


@pytest.mark.parametrize("regime", ["packed", "sym"])
def test_bsr_step_equals_dense_step(synthetic_problem, dtype, regime):
    _bsr_vs_dense(t_bucketize(synthetic_problem, pow2_from=9), dtype,
                  regime)


def _moving_problem():
    """The problem of tests/test_torch_solve.py: the conftest one with a
    larger perturbation, solved with a small initial trust region and
    function_tolerance 1e-5, so that every iteration makes real
    progress (once a float32 cost stalls at rounding level, accept and
    reject are noise in any two implementations)."""
    from rootba_tpu_torch.bal.synthetic import generate_synthetic_bal

    p = generate_synthetic_bal(num_cams=12, num_lms=200,
                               mean_obs_per_lm=4.5, seed=3)
    p.normalize(100.0)
    p.perturb(0.001, 0.05, 0.05, 38401)
    p.filter_obs(0.1)
    return p


@pytest.mark.parametrize("regime", ["packed", "sym"])
def test_bsr_solve_equals_dense_solve(dtype, regime):
    """A short LM solve: identical accept/reject flags and CG counts,
    costs to rel 1e-8 (float64) and 1e-4 (float32)."""
    bp = t_bucketize(_moving_problem(), pow2_from=9)
    runs = []
    for extra in (dict(sqrt_rcs_mode="dense", pallas_cg="off"),
                  dict(sqrt_rcs_mode="bsr",
                       **(SYM if regime == "sym" else {}))):
        _, s = optimize_lm_fused(bp, TOptions(
            use_double=dtype == np.float64, verbosity_level=0,
            max_num_iterations=8, initial_trust_region_radius=10.0,
            function_tolerance=1e-5, **extra), device=CPU)
        runs.append(s.iterations)
    dense, bsr = runs
    assert ([i.step_is_successful for i in bsr]
            == [i.step_is_successful for i in dense])
    assert ([i.linear_solver_iterations for i in bsr]
            == [i.linear_solver_iterations for i in dense])
    rtol = 1e-8 if dtype == np.float64 else 1e-4
    for a, b in zip(bsr, dense):
        np.testing.assert_allclose(a.cost.all.error, b.cost.all.error,
                                   rtol=rtol)


def _pair_free(problem):
    """The conftest problem with every landmark's observations after its
    first masked out: no landmark links two observations, so the pair
    index is empty (P = 0)."""
    bp = t_bucketize(problem, pow2_from=9)
    buckets = []
    for b in bp.buckets:
        mask = b.mask.copy()
        mask[:, 1:] = False
        buckets.append(b._replace(mask=mask))
    return bp._replace(buckets=tuple(buckets),
                       num_observations=int(bp.num_landmarks))


@pytest.mark.parametrize("regime", ["packed", "sym"])
def test_pair_free_problem_bsr_equals_dense(synthetic_problem, dtype,
                                            regime):
    """Without camera pairs the half table is [0, 81], the packed table
    pad entries only, and a BSR step equals the dense one."""
    bp = _pair_free(synthetic_problem)
    lin = _bsr_vs_dense(bp, dtype, regime)
    assert lin.pairs.num_pairs == 0
    R, W = lin.bsr.shape2d
    assert (R, W) == (1, 8)
    assert torch.equal(lin.bsr.blk_idx, torch.zeros(8, dtype=torch.int32))
    half = torch.zeros((0, 81), dtype=torch.float64)
    assert tlz.bsr_build_table(half, lin.bsr, True).shape == (0, 81)
    packed = tlz.bsr_build_table(half, lin.bsr, False)
    assert packed.shape == (8, 81) and not packed.any()


def test_auto_picks_bsr_above_dense_rcs_max_cameras(synthetic_problem):
    from rootba_tpu_torch.config.options import PreconditionerType

    bp = t_bucketize(synthetic_problem, pow2_from=9)
    N = bp.num_cameras

    def mode(**kw):
        lin = t_create(bp, TOptions(**kw), torch.float64, CPU)
        return ("bsr" if lin.bsr_rcs else
                "dense" if lin.explicit_rcs else "implicit")

    assert mode() == "dense"
    assert mode(dense_rcs_max_cameras=N) == "dense"
    assert mode(dense_rcs_max_cameras=N - 1) == "bsr"
    assert mode(dense_rcs_max_cameras=N - 1, preconditioner_type=(
        PreconditionerType.JACOBI)) == "implicit"
    lin = t_create(bp, TOptions(dense_rcs_max_cameras=1), torch.float32,
                   CPU)
    assert lin.bsr_rcs and not lin.bsr_sym and not lin.use_cg_kernel
    # the obs pair gather runs BSR mode too
    # (tests/test_torch_pair_gathers.py holds it to the JAX package)
    lin = t_create(bp, TOptions(sqrt_rcs_mode="bsr", pair_gather="obs"),
                   torch.float64, CPU)
    assert lin.bsr_rcs and lin.bsr is not None
