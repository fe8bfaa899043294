"""The plain twins of the port's three kernels against the JAX package's
Pallas kernels (run in interpret mode on the CPU, as the JAX package's
own tests run them) and their XLA counterparts, and -- on a card only --
each CUDA kernel against its twin.

K1 fold_plain      vs outer81_fold_pallas / _outer81_fold
K2 w_build_plain   vs w_build_table (n <= 16) / the elementwise chain
K3 pcg_dense_plain vs pcg_dense_vmem / solver.cg.pcg, on padded and
   unpadded systems, and at a grid-sized system; k3_plan, the size
   switches between K3's three kernels; plain models of the half and
   grid kernels' deals and products

The card-only test runs on a machine without JAX too (JAX is imported
inside the tests that compare with it):

    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py
"""

import numpy as np
import pytest
import torch

from rootba_tpu_torch.ops import cg_dense, fold, kernels

torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.array(a))


def w_ref(q_tab, jp_tab, n):
    """The JAX package's elementwise W chain (sqrt_flat.w_chunk)."""
    import jax.numpy as jnp

    L = q_tab.shape[0]
    qf = q_tab.reshape(L * n, 6)
    jpf = jp_tab.reshape(L * n, 18)
    W27 = (jnp.repeat(qf[:, :3], 9, axis=1) * jnp.tile(jpf[:, :9], (1, 3))
           + jnp.repeat(qf[:, 3:], 9, axis=1)
           * jnp.tile(jpf[:, 9:], (1, 3)))
    return W27.reshape(L, n * 27)


@pytest.mark.parametrize("width,K", [(2, 2), (4, 3), (8, 2), (16, 3)])
def test_fold_plain_matches_pallas_and_xla(width, K, dtype):
    """K1's twin == the Pallas kernel (interpret mode, float32 only, as
    the kernel is) and == _outer81_fold, on slot counts ragged against
    the Pallas 512-slot block. Both orders of summation are float32
    exact to reassociation: rtol/atol 1e-5 (the JAX package's own
    kernel test); float64 to 1e-12."""
    import jax.numpy as jnp

    from rootba_tpu.ops.pallas_fold import outer81_fold_pallas
    from rootba_tpu.solver.linearization import _outer81_fold

    rng = np.random.default_rng(width * 10 + K)
    M = (3 * 512 + 5 * width) // width * width
    s1 = rng.standard_normal((M, K * 9)).astype(dtype)
    s2 = rng.standard_normal((M, K * 9)).astype(dtype)
    got = fold.outer81_fold(_t(s1), _t(s2), width).numpy()
    tol = 1e-5 if dtype == np.float32 else 1e-12
    np.testing.assert_allclose(got, np.asarray(_outer81_fold(s1, s2, width)),
                               rtol=tol, atol=tol)
    if dtype == np.float32:
        ref = outer81_fold_pallas(jnp.asarray(s1), jnp.asarray(s2), width,
                                  interpret=True)
        np.testing.assert_allclose(got, np.asarray(ref), rtol=1e-5,
                                   atol=1e-5)


def test_fold_plain_chunks_long_streams(monkeypatch):
    """Above _PLAIN_MAX_RUNS runs the CPU path folds in chunks; the
    result is the unchunked one."""
    rng = np.random.default_rng(0)
    s1 = _t(rng.standard_normal((4 * 37, 27)))
    s2 = _t(rng.standard_normal((4 * 37, 27)))
    whole = fold.outer81_fold(s1, s2, 4)
    monkeypatch.setattr(fold, "_PLAIN_MAX_RUNS", 5)
    np.testing.assert_allclose(fold.outer81_fold(s1, s2, 4).numpy(),
                               whole.numpy(), rtol=1e-14, atol=1e-14)


@pytest.mark.parametrize("n,L", [(2, 7), (3, 64), (5, 129), (8, 40),
                                 (16, 9), (32, 3), (64, 5)])
def test_w_build_plain_matches(n, L, dtype):
    """K2's twin == the Pallas kernel for n <= 16 (its VMEM gate) and ==
    the elementwise chain for every n. Same products and sum, so equal
    to float rounding (rtol/atol 1e-6 against Pallas's matmul-expanded
    form; exact against the elementwise chain)."""
    import jax.numpy as jnp

    from rootba_tpu.ops.pallas_fold import w_build_table

    rng = np.random.default_rng(n * 100 + L)
    q = rng.standard_normal((L, n * 6)).astype(dtype)
    jp = rng.standard_normal((L, n * 18)).astype(dtype)
    got = fold.w_build(_t(q), _t(jp), n).numpy()
    np.testing.assert_array_equal(got, np.asarray(w_ref(q, jp, n)))
    if dtype == np.float32 and n <= 16:
        ref = w_build_table(jnp.asarray(q), jnp.asarray(jp), n,
                            interpret=True)
        np.testing.assert_allclose(got, np.asarray(ref), rtol=1e-6,
                                   atol=1e-6)


def _cg_system(N, Nc, seed):
    """The system of tests/test_cg.py:113-156: a random SPD [9N, 9N]
    matrix, its z-space padding Hz[a*Nc+i, b*Nc+j] = A[i*9+a, j*9+b] and
    its 9x9 diagonal blocks."""
    rng = np.random.default_rng(seed)
    n = 9 * N
    A0 = (rng.normal(size=(n, n)) / np.sqrt(n)).astype(np.float32)
    A = (A0 @ A0.T + 2.0 * np.eye(n)).astype(np.float32)
    b = rng.normal(size=(N, 9)).astype(np.float32)
    blocks = np.stack([A[9 * i:9 * i + 9, 9 * i:9 * i + 9]
                       for i in range(N)]).astype(np.float32)
    Hz = np.zeros((9, Nc, 9, Nc), np.float32)
    Hz[:, :N, :, :N] = A.reshape(N, 9, N, 9).transpose(1, 0, 3, 2)
    return A, Hz.reshape(9 * Nc, 9 * Nc), blocks, b


def _k3_against_jax(**kw):
    """K3's twin (through its wrapper), the Pallas whole-loop kernel
    (interpret mode) and solver.cg.pcg on the system of _cg_system(11,
    128, 7) with the CG options `kw`: (twin, [pcg, Pallas])."""
    import jax.numpy as jnp

    from rootba_tpu.ops.pallas_cg import pcg_dense_vmem
    from rootba_tpu.solver.cg import pcg
    from rootba_tpu.solver.sqrt_qr import precond_apply

    N, Nc = 11, 128
    A, Hz, blocks, b = _cg_system(N, Nc, 7)
    chol = jnp.linalg.cholesky(jnp.asarray(blocks))

    def matvec(x):
        return (jnp.asarray(A) @ x.reshape(-1)).reshape(N, 9)

    ref = pcg(matvec, lambda r: precond_apply(chol, r), jnp.asarray(b), **kw)
    pal = pcg_dense_vmem(jnp.asarray(Hz), chol, jnp.asarray(b),
                         interpret=True, **kw)
    got = cg_dense.pcg_dense(_t(Hz), _t(np.asarray(chol)), _t(b), **kw)
    # float32 dots and GEMVs summed in another order: the tolerance of
    # the JAX package's own kernel test
    for other in (ref, pal):
        assert int(got.num_iterations) == int(other.num_iterations)
        assert int(got.termination_type) == int(other.termination_type)
        np.testing.assert_allclose(got.x.numpy(), np.asarray(other.x),
                                   rtol=2e-4, atol=2e-5)
    return got, pal


def test_pcg_dense_plain_matches_pallas_and_pcg():
    """K3's twin follows the Pallas whole-loop kernel (interpret mode)
    and solver.cg.pcg on the same system: equal iteration counts and
    termination, x to rtol 2e-4 / atol 2e-5."""
    for q_tol, max_it in ((1e-1, 100), (1e-8, 200)):
        got, pal = _k3_against_jax(max_num_iterations=max_it,
                                   q_tolerance=q_tol)
        np.testing.assert_allclose(float(got.final_norm_r),
                                   float(pal.final_norm_r), rtol=1e-2)


@pytest.mark.parametrize("reset_period,q_tol,max_it", [
    (3, 1e-8, 200),               # resets at 3, 6, 9 before the zeta test
    (10, float("-inf"), 25),      # a fixed 25 iterations: resets 10, 20
])
def test_pcg_dense_plain_crosses_residual_reset(reset_period, q_tol, max_it):
    """The exact residual reset r = b - Hx (every reset_period
    iterations) in K3's twin against the Pallas kernel and pcg, at the
    same tolerances."""
    got, _ = _k3_against_jax(max_num_iterations=max_it, q_tolerance=q_tol,
                             residual_reset_period=reset_period)
    assert int(got.num_iterations) > reset_period


def test_pcg_dense_zero_rhs_and_padding():
    """|b| = 0 gives x = 0 with success; identity-padded chol planes
    keep the padded lanes at zero."""
    N, Nc = 3, 128
    _, Hz, blocks, _ = _cg_system(N, Nc, 1)
    chol = np.linalg.cholesky(blocks.astype(np.float64)).astype(np.float32)
    Lp = cg_dense.chol_planes(_t(chol), Nc)
    assert torch.equal(Lp[[i * 10 for i in range(9)], N:],
                       torch.ones(9, Nc - N))
    res = cg_dense.pcg_dense(_t(Hz), _t(chol), torch.zeros(N, 9))
    assert int(res.termination_type) == 1 and int(res.num_iterations) == 1
    assert not res.x.any()


@pytest.mark.parametrize("N,Nc,kernel,rows", [
    (1, 128, "cluster", 1),
    (12, 128, "cluster", 7),
    (20, 128, "cluster", 12),
    (29, 128, "cluster", 17),
    (49, 128, "cluster", 28),    # ladybug-49: 441 real rows of 1152
    (49, 49, "cluster", 28),     # unpadded
    (92, 128, "cluster", 52),
    (93, 128, "cluster", 53),
    (96, 128, "cluster", 54),    # the largest slab a CTA holds
    (97, 128, "half", 64),
    (100, 128, "half", 64),
    (126, 128, "half", 72),      # trafalgar-126
    (128, 128, "half", 72),      # the K3 gate's largest system
    (129, 256, "grid", 9),
    (0, 128, "grid", 0),
    (300, 1024, "grid", 14),     # past the grid kernel's on-chip edge
    (1025, 1152, "grid", 3),     # above 1,024 lanes
    (2048, 2048, "grid", 0),     # dense mode's largest system
])
def test_k3_plan(N, Nc, kernel, rows):
    """K3's size switches: the full-row cluster kernel (16 CTAs) while a
    CTA's slab of ceil(9N / 16) real rows, its vectors and Lp fit in 227
    KB of shared memory; then the half kernel (16 CTAs, 2 pairs_per
    row slots of the upper triangle each) up to 128 cameras; else the
    grid kernel: one CTA per SM (132), each with ceil(N / 132) lanes and
    their 9 rows, `rows` of them resident and the rest streamed through
    its ring's stages. One camera more moves N = 0, 96 and 128 to another
    kernel.
    (The card test holds k3_plan equal to the kernels' own plans.)"""
    plan = cg_dense.k3_plan(N, Nc)
    assert (plan.kernel, plan.rows_per_cta) == (kernel, rows)
    assert plan.cluster == (0 if kernel == "grid" else cg_dense.CLUSTER)
    assert plan.smem_bytes <= cg_dense.SMEM_LIMIT
    full_fits = 1 <= N <= cg_dense.MAX_LANES and cg_dense.cluster_smem_bytes(
        N, -(-9 * N // 16)) <= cg_dense.SMEM_LIMIT
    if kernel == "cluster":
        assert rows == -(-9 * N // 16) <= cg_dense.MAX_ROWS_PER_CTA
        assert full_fits
        assert plan.smem_bytes == cg_dense.cluster_smem_bytes(N, rows)
    elif kernel == "half":
        assert not full_fits and cg_dense.half_fits(N)
        assert rows == 2 * cg_dense.half_pairs_per_cta(N)
        assert plan.smem_bytes == cg_dense.half_smem_bytes(N, rows // 2)
    else:
        assert not full_fits and not cg_dense.half_fits(N)
        # CTAs, streamed rows, ring stages and their rows (the largest
        # CTA)
        assert (plan.ctas, plan.streamed, plan.stages, plan.stage_rows) == {
            129: (129, 0, 0, 0), 0: (1, 0, 0, 0), 300: (132, 13, 2, 3),
            1025: (132, 69, 2, 1), 2048: (132, 144, 2, 1)}[N]
        assert rows + plan.streamed == 9 * -(-N // plan.ctas)
    if N + 1 <= Nc:
        nxt = cg_dense.k3_plan(N + 1, Nc)
        assert (nxt.kernel != kernel) == (N in (0, 96, 128))


def test_packed_factor_solves_like_planes():
    """The cluster kernels keep only the 45 lower planes of the factor,
    row a's entries after rows 0..a-1's (csrc/cg_dense.cu plane45 and
    copy_factor_b): a plain model of their substitution on those planes
    -- the twin's products and differences in the twin's order -- is the
    twin's on the 81 planes, bit for bit, and reads every packed plane."""
    rng = np.random.default_rng(4)
    N = 37
    A = rng.standard_normal((N, 9, 12)).astype(np.float32)
    chol = np.linalg.cholesky(A @ A.transpose(0, 2, 1)).astype(np.float32)
    Lp = cg_dense.chol_planes(_t(chol), 40)
    r = _t(rng.standard_normal((9, 40)).astype(np.float32))
    planes = [a * 9 + c for a in range(9) for c in range(a + 1)]
    packed = Lp[planes]
    read = set()

    def at(a, c):
        e = a * (a + 1) // 2 + c
        read.add(e)
        return packed[e]

    y = [None] * 9
    for i in range(9):
        s = r[i]
        for k in range(i):
            s = s - at(i, k) * y[k]
        y[i] = s / at(i, i)
    z = [None] * 9
    for i in reversed(range(9)):
        s = y[i]
        for k in range(i + 1, 9):
            s = s - at(k, i) * z[k]
        z[i] = s / at(i, i)
    assert torch.equal(torch.stack(z), cg_dense._solve_planar(Lp, r))
    assert read == set(range(45))


def _half_deal(N):
    """The half kernel's deal of the triangle (csrc/cg_dense.cu:
    half_row, the prologue's copy, half_plan): for each of the 16 CTAs
    its pair count and, per row (the low rows, then the high rows, each
    in column order), (row r, offset of column 0 in the CTA's share, its
    slot). Row r of the padded layout (ld = 9 Np rows, Np = N rounded up
    to 8) pairs with ld - 1 - r and keeps columns c >= r & ~3; pairs are
    stored one after another."""
    Np = cg_dense.half_lanes(N)
    ld = 9 * Np
    pp = cg_dense.half_pairs_per_cta(N)
    ctas = []
    for t in range(cg_dense.CLUSTER):
        pairs = max(0, min(pp, ld // 2 - t * pp))
        rows = []
        for ri in range(2 * pairs):
            hi = ri >= pairs
            l = 2 * pairs - 1 - ri if hi else ri
            lo = t * pp + l
            r = ld - 1 - lo if hi else lo
            base = l * (ld + 4) + ((ld - (lo & ~3)) if hi else 0) - (r & ~3)
            rows.append((r, base, 2 * pp - 2 * pairs + ri if hi else ri))
        ctas.append((pairs, rows))
    return ld, pp, ctas


@pytest.mark.parametrize("N", [12, 49, 93, 100, 117, 126, 128])
def test_half_deal_tiles_the_triangle(N):
    """Every row of the padded layout lands in exactly one CTA; a CTA's
    rows tile its share of pairs_per x (ld + 4) floats with no gap or
    overlap; the CTAs hold pairs_per pairs each (a multiple of 4), so the
    same entry count, until the pairs run out (at most one CTA holds
    fewer but not none; all 16 hold pairs_per at Np = 128: N = 121..128);
    each column's receiving (CTA, slot), as the kernel computes it, holds
    that row, and four columns from a multiple of 4 share a CTA and take
    four slots in a row from a multiple of 4 (one 16-byte store); and the
    plan's shared memory holds the share."""
    ld, pp, ctas = _half_deal(N)
    seen = []
    for t, (pairs, rows) in enumerate(ctas):
        used = np.zeros(pp * (ld + 4), dtype=int)
        for r, base, _ in rows:
            used[base + (r & ~3):base + ld] += 1
            seen.append(r)
        assert (used[:pairs * (ld + 4)] == 1).all()
        assert not used[pairs * (ld + 4):].any()
    assert sorted(seen) == list(range(ld))
    counts = [pairs for pairs, _ in ctas]
    assert sum(counts) == ld // 2
    assert len([c for c in counts if 0 < c < pp]) <= 1
    assert counts == sorted(counts, reverse=True)
    assert pp % 4 == 0 and ld % 8 == 0
    if cg_dense.half_lanes(N) == 128:
        assert counts == [pp] * cg_dense.CLUSTER
    P = ld // 2
    for c4 in range(0, ld, 4):
        k = c4 if c4 < P else ld - 1 - c4
        t = k // pp
        slot = c4 - t * pp if c4 < P else pp + c4 - (ld - (t + 1) * pp)
        assert slot % 4 == 0
        by_slot = {sl: r for r, _, sl in ctas[t][1]}
        for q in range(4):
            assert by_slot[slot + q] == c4 + q
    assert cg_dense.half_smem_bytes(N, pp) - 4 * pp * (ld + 4) > 0
    assert cg_dense.k3_plan(N, 128).smem_bytes <= cg_dense.SMEM_LIMIT


@pytest.mark.parametrize("N", [49, 93, 126, 128])
def test_half_product_model_matches_mv(N):
    """A plain model of the half kernel's product H p: each CTA's share
    filled from H as its prologue copies it; each row's sum over its
    stored entries; per CTA, the column sums over its rows; each row's 16
    column sums and its row sum added as the kernel adds them (lane l:
    column sum l, plus the row sum in lane 0, then an xor butterfly over
    16 lanes). In float64 this is
    H p to 1e-12 (the deal covers each entry once); in float32 it is
    torch.mv of the full system to 1e-5 of sum |H_rc p_c| (sums of up to
    1152 products in another order: about sqrt(1152) 2^-24 = 2e-6). The
    share keeps zeros left of the diagonal and the diagonal halved, and
    every stored entry goes into both sums, as in the kernel."""
    ld, pp, ctas = _half_deal(N)
    Np = ld // 9
    rng = np.random.default_rng(N)
    A = rng.standard_normal((ld, ld))
    H64 = torch.from_numpy(A + A.T)
    pad = [f * Np + j for f in range(9) for j in range(N, Np)]
    H64[pad, :] = 0.0
    H64[:, pad] = 0.0
    p64 = torch.from_numpy(rng.standard_normal(ld))
    p64[pad] = 0.0
    for dt, tol in ((torch.float64, 1e-12), (torch.float32, 1e-5)):
        H, p = H64.to(dt), p64.to(dt)
        col = torch.zeros(16, ld, dtype=dt)
        row = torch.zeros(ld, dtype=dt)
        for t, (pairs, rows) in enumerate(ctas):
            share = torch.full((pp * (ld + 4),), float("nan"), dtype=dt)
            for r, base, _ in rows:
                share[base + (r & ~3):base + ld] = H[r, r & ~3:]
                share[base + (r & ~3):base + r] = 0.0
                share[base + r] *= 0.5
            for r, base, _ in rows:
                h = torch.zeros(ld, dtype=dt)
                h[r & ~3:] = share[base + (r & ~3):base + ld]
                row[r] = torch.sum(h * p)
                col[t] += h * p[r]
        y = col.clone()
        y[0] += row
        for o in (8, 4, 2, 1):
            y = y + y[torch.arange(16) ^ o]
        want = H64 @ p64
        scale = (H64.abs() @ p64.abs()).clamp_min(1e-300)
        assert bool(((y[0].double() - want).abs() <= tol * scale).all())
        if dt == torch.float32:
            mv = torch.mv(H, p).double()
            assert bool(((y[0].double() - mv).abs() <= 2 * tol * scale).all())


def _grid_deal(N, sms=cg_dense.GRID_CTAS):
    """The grid kernel's deal (csrc/cg_dense.cu: pcg_dense_kernel's
    prologue, grid_copy_local, grid_fetch): per CTA t, its first lane
    lo = t N / G and lane count, its local rows rr = f nl + (j - lo) as
    (f, j), how many of them are resident (all where they fit the
    resident + stages * stage_rows row slots), and the stages S of its
    ring (at most one per group of stage_rows streamed rows)."""
    plan = cg_dense.grid_plan(N, sms)
    G = plan.ctas
    slots = plan.rows_per_cta + plan.stages * plan.stage_rows
    ctas = []
    for t in range(G):
        lo, hi = t * N // G, (t + 1) * N // G
        nl = hi - lo
        rows = [(rr // nl, lo + rr % nl) for rr in range(9 * nl)]
        res = len(rows) if len(rows) <= slots else plan.rows_per_cta
        groups = -(-(len(rows) - res) // plan.stage_rows) if res < len(
            rows) else 0
        ctas.append((lo, nl, rows, res, min(groups, plan.stages)))
    return plan, ctas


@pytest.mark.parametrize("N", [129, 200, 257, 264, 265, 300, 400, 1025,
                               2048])
def test_grid_deal_covers_rows_and_lanes(N):
    """Every camera lane belongs to exactly one CTA, in order, and every
    real row f Np + j (f < 9, j < N) to the CTA that owns lane j, exactly
    once; the CTAs' lane counts differ by at most one and stay within a
    warp; a CTA streams only where its rows overflow the row slots, then
    keeps the plan's resident rows and at most the plan's stages; the
    largest CTA streams the plan's rows; the shared memory holds the
    ring's mbarriers, v, the row slots, the warps' row sums, the rows'
    sums and 8 scalars; and
    the ring's fetches bring every streamed row once per product, in
    groups of at most stage_rows rows, one group per stage fill."""
    plan, ctas = _grid_deal(N)
    lanes, rows = [], []
    for lo, nl, rr, res, S in ctas:
        lanes += range(lo, lo + nl)
        rows += [f * N + j for f, j in rr]
        assert all(lo <= j < lo + nl for _, j in rr)
        if res < len(rr):
            assert res == plan.rows_per_cta and 1 <= S <= plan.stages
        else:
            assert S == 0 and res <= (plan.rows_per_cta
                                      + plan.stages * plan.stage_rows)
    assert lanes == list(range(N))
    assert sorted(rows) == list(range(9 * N))
    counts = {nl for _, nl, _, _, _ in ctas}
    assert max(counts) - min(counts) <= 1
    assert max(counts) <= cg_dense.GRID_MAX_LANES
    assert max(len(rr) - res for _, _, rr, res, _ in ctas) == plan.streamed
    ld = 9 * cg_dense.grid_lanes(N)
    R = 9 * max(counts)
    assert plan.smem_bytes == 4 * (
        2 * cg_dense.GRID_MAX_STAGES + ld + 9 * R + 8
        + (plan.rows_per_cta + plan.stages * plan.stage_rows) * ld)
    assert plan.smem_bytes <= cg_dense.SMEM_LIMIT
    sr = plan.stage_rows
    for _, _, rr, res, S in ctas:
        streamed = len(rr) - res
        if not streamed:
            continue
        # fetch k brings group k mod groups (rows res + g sr, ... of the
        # group) into stage k mod S, read by consumption k; fetch k + S
        # reuses that stage only after it: over three products every
        # streamed row comes three times, each stage holds <= sr rows
        groups = -(-streamed // sr)
        fetched = []
        for k in range(3 * groups):
            g = k % groups
            fetched += range(res + g * sr, min(res + (g + 1) * sr, len(rr)))
        assert sorted(fetched) == sorted(list(range(res, len(rr))) * 3)
        assert 1 <= sr <= cg_dense.GRID_MAX_STAGE_ROWS


def _grid_product(H, v, N, dtype):
    """A plain model of the grid kernel's product H v, from each CTA's
    rows in its order (resident, then streamed): row rr's 256 thread
    sums over the float4 columns t, t + 256, ... (each float4's four
    products in order), a butterfly over each warp's 32 sums, then the 8
    warps' sums in warp order (csrc/cg_dense.cu grid_rows,
    grid_product). Products and sums round on their own here, where
    the kernel's fmaf rounds once."""
    _, ctas = _grid_deal(N)
    Np = cg_dense.grid_lanes(N)
    ld = 9 * Np
    ld4 = ld // 4
    T = 256
    m = -(-ld4 // T)
    vv = torch.zeros(m * T * 4, dtype=dtype)
    vv[:ld] = v
    out = torch.zeros(ld, dtype=dtype)
    for _, _, rr, _, _ in ctas:
        for f, j in rr:
            h = torch.zeros(m * T * 4, dtype=dtype)
            h[:ld] = H[f * Np + j]
            prod = (h * vv).reshape(m, T, 4)
            s = torch.zeros(T, dtype=dtype)
            for k in range(m):
                for c in range(4):
                    s = s + prod[k, :, c]
            w = s.reshape(8, 32)
            for o in (16, 8, 4, 2, 1):
                w = w + w[:, torch.arange(32) ^ o]
            q = torch.zeros((), dtype=dtype)
            for k in range(8):
                q = q + w[k, 0]
            out[f * Np + j] = q
    return out


@pytest.mark.parametrize("N", [129, 265, 400])
def test_grid_product_model_matches_mv(N):
    """The grid kernel's product, as a plain model of its deal and its
    fixed order of sums (_grid_product), on a symmetric system in the Np
    layout with zero pad lanes: in float64 H v to 1e-12 (the deal covers
    each real row once, each row's columns once); in float32 torch.mv of
    the same system to 1e-5 of sum |H_rc v_c| (sums of up to 3600
    products in another order: about sqrt(3600) 2^-24 = 4e-6)."""
    Np = cg_dense.grid_lanes(N)
    ld = 9 * Np
    rng = np.random.default_rng(N)
    A = rng.standard_normal((ld, ld))
    H64 = torch.from_numpy(A + A.T)
    pad = [f * Np + j for f in range(9) for j in range(N, Np)]
    H64[pad, :] = 0.0
    H64[:, pad] = 0.0
    v64 = torch.from_numpy(rng.standard_normal(ld))
    v64[pad] = 0.0
    scale = (H64.abs() @ v64.abs()).clamp_min(1e-300)
    want = H64 @ v64
    got64 = _grid_product(H64, v64, N, torch.float64)
    assert bool(((got64 - want).abs() <= 1e-12 * scale).all())
    H, v = H64.float(), v64.float()
    got = _grid_product(H, v, N, torch.float32).double()
    assert bool(((got - torch.mv(H, v).double()).abs()
                 <= 1e-5 * scale).all())
    assert not got[pad].any()


@pytest.fixture(scope="module")
def grid_sized_k3():
    """pcg_dense (the twin, on the CPU) and the Pallas whole-loop kernel
    (interpret mode) on a grid-sized system, N = 129 on Nc = 256
    (_cg_system), under two CG option sets; computed once per module."""
    import jax.numpy as jnp

    from rootba_tpu.ops.pallas_cg import pcg_dense_vmem

    N, Nc = 129, 256
    _, Hz, blocks, b = _cg_system(N, Nc, 5)
    chol = np.linalg.cholesky(blocks.astype(np.float64)).astype(np.float32)
    out = {}
    for q_tol, max_it in ((1e-1, 100), (float("-inf"), 25)):
        kw = dict(max_num_iterations=max_it, q_tolerance=q_tol)
        got = cg_dense.pcg_dense(_t(Hz), _t(chol), _t(b), **kw)
        pal = pcg_dense_vmem(jnp.asarray(Hz), jnp.asarray(chol),
                             jnp.asarray(b), interpret=True, **kw)
        out[q_tol] = (got, pal)
    return out


@pytest.mark.parametrize("q_tol", [1e-1, float("-inf")])
def test_pcg_dense_grid_sized_matches_pallas(grid_sized_k3, q_tol):
    """Above the cluster kernels' 128 cameras, where the card runs the
    grid kernel: the twin follows the Pallas kernel (interpret mode) on
    N = 129 of Nc = 256 lanes: the same iteration count and termination,
    x to rtol 2e-4 / atol 2e-5 (the JAX package's own kernel test)."""
    got, pal = grid_sized_k3[q_tol]
    assert int(got.num_iterations) == int(pal.num_iterations) > 1
    assert int(got.termination_type) == int(pal.termination_type)
    np.testing.assert_allclose(got.x.numpy(), np.asarray(pal.x),
                               rtol=2e-4, atol=2e-5)


def test_k3_plan_rejects():
    """Above the grid kernel's capacity (2100 cameras on 132 SMs: its
    vector and two row stages fill 227 KB) k3_plan raises, naming it."""
    assert cg_dense.grid_max_cameras() == 2100
    assert cg_dense.k3_plan(2100, 2176).kernel == "grid"
    with pytest.raises(ValueError, match="2100, the grid kernel's capacity"):
        cg_dense.k3_plan(2101, 2176)
    with pytest.raises(ValueError, match="N <= Nc"):
        cg_dense.k3_plan(50, 49)


@pytest.mark.parametrize("sms", [132, 114])
def test_k3_launch_follows_plan(monkeypatch, sms):
    """_launch hands each system to the kernel k3_plan names on the SMs
    of Hz's card (the H100 SXM's 132, the PCIe card's 114), and the grid
    kernel the plan it chose; no launcher stands in for another."""
    seen = []
    monkeypatch.setattr(cg_dense, "card_sms", lambda device: sms)
    monkeypatch.setattr(cg_dense, "_launch_in_cluster",
                        lambda name, Hz, b2, Lp, N, **kw:
                        seen.append((name, N)))

    def grid(Hz, b2, Lp, N, plan, **kw):
        assert plan == cg_dense.grid_plan(N, sms) and plan.ctas == min(sms, N)
        seen.append(("grid", N))

    monkeypatch.setattr(cg_dense, "_launch_grid", grid)
    for N in (20, 49, 92, 93, 96, 97, 100, 126, 128, 129, 257, 1025, 2048):
        M = 9 * -(-N // 128) * 128
        cg_dense._launch(torch.empty((M, M), device="meta"), None, None, N,
                         max_iters=1)
    assert seen == [("cluster", 20), ("cluster", 49), ("cluster", 92),
                    ("cluster", 93), ("cluster", 96), ("half", 97),
                    ("half", 100), ("half", 126), ("half", 128),
                    ("grid", 129), ("grid", 257), ("grid", 1025),
                    ("grid", 2048)]


@pytest.mark.parametrize("q_tol,max_it", [(1e-1, 100), (float("-inf"), 25)])
def test_pcg_dense_plain_padding_free(q_tol, max_it):
    """The premise of the cluster kernel, which skips the padded lanes:
    the twin on Hz padded to 128 lanes and on the unpadded N-lane system
    gives the same iteration count, termination and x (float32 sums over
    the zero lanes in another blocking: 1e-6), and the unpadded twin
    follows the Pallas kernel (interpret mode) on the unpadded system at
    rtol 2e-4 / atol 2e-5."""
    import jax.numpy as jnp

    from rootba_tpu.ops.pallas_cg import pcg_dense_vmem

    N = 11
    kw = dict(max_num_iterations=max_it, q_tolerance=q_tol)
    A, Hz, blocks, b = _cg_system(N, 128, 7)
    _, Hz_n, _, _ = _cg_system(N, N, 7)
    chol = np.linalg.cholesky(blocks.astype(np.float64)).astype(np.float32)
    padded = cg_dense.pcg_dense(_t(Hz), _t(chol), _t(b), **kw)
    tight = cg_dense.pcg_dense(_t(Hz_n), _t(chol), _t(b), **kw)
    for got in (padded, tight):
        assert int(got.num_iterations) > 1
    assert int(padded.num_iterations) == int(tight.num_iterations)
    assert int(padded.termination_type) == int(tight.termination_type)
    np.testing.assert_allclose(padded.x.numpy(), tight.x.numpy(),
                               rtol=1e-6, atol=1e-6)
    pal = pcg_dense_vmem(jnp.asarray(Hz_n), jnp.asarray(chol),
                         jnp.asarray(b), interpret=True, **kw)
    assert int(tight.num_iterations) == int(pal.num_iterations)
    assert int(tight.termination_type) == int(pal.termination_type)
    np.testing.assert_allclose(tight.x.numpy(), np.asarray(pal.x),
                               rtol=2e-4, atol=2e-5)


def test_wrappers_reject_bad_inputs():
    a = torch.zeros(10, 27)
    with pytest.raises(ValueError, match="does not divide"):
        fold.outer81_fold(a, a, 4)
    with pytest.raises(TypeError):
        fold.outer81_fold(a, a.double(), 2)
    with pytest.raises(ValueError, match="contiguous"):
        fold.outer81_fold(a.T.contiguous().T, a, 2)
    with pytest.raises(ValueError):
        fold.w_build(torch.zeros(4, 12), torch.zeros(4, 35), 2)


def test_plain_paths_do_not_count_launches():
    before = dict(kernels.LAUNCHES)
    a = torch.ones(8, 18)
    fold.outer81_fold(a, a, 4)
    fold.w_build(torch.ones(2, 12), torch.ones(2, 36), 2)
    assert kernels.LAUNCHES == before


@pytest.mark.cuda
def test_kernels_match_plain_on_card():
    """Each CUDA kernel against its plain twin on the card: phase 2 of
    chip_smoke.py, at its tolerances -- K1 at every run width up to 64,
    K = 2 and 3, f32 and f64, on run counts ragged against its tile and on
    a stream long enough to cycle its copy pipeline; K2; the three K3
    kernels on both sides of each size switch, through the residual
    reset, and through the wrapper pcg_dense."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run chip_smoke.py on the card)")
    import chip_smoke

    dev = torch.device("cuda")
    errs = dict.fromkeys(chip_smoke.KERNEL_NAMES, 0.0)
    chip_smoke.check_k1(dev, errs)
    chip_smoke.check_k2(dev, errs)
    chip_smoke.check_k3(dev, errs)
    # the system of _cg_system(20, 128, 3) at q_tol 1e-8, through the
    # residual reset every 3rd iteration: the kernel k3_plan gives
    # against the twin, a stop one iteration apart passing only as a
    # float32 tie (chip_smoke.compare_k3)
    _, Hz, blocks, b = _cg_system(20, 128, 3)
    chol = torch.linalg.cholesky(torch.as_tensor(blocks).double()).float()
    Lp = cg_dense.chol_planes(chol.to(dev), 128)
    b2 = torch.zeros(9, 128, device=dev)
    b2[:, :20] = torch.as_tensor(b, device=dev).T
    Hz = torch.as_tensor(Hz, device=dev)
    for period in (10, 3):
        kw = dict(min_iters=0, max_iters=100, q_tol=1e-8, r_tol=-1.0,
                  reset_period=period)
        chip_smoke.compare_k3(
            "pcg_dense_cluster",
            lambda *a, **k: cg_dense._launch(*a, 20, **k), Hz, b2, Lp, 20,
            kw, errs)


@pytest.mark.cuda
def test_bsr_matvecs_match_cpu_on_card():
    """The BSR table build and both block-sparse CG operators
    (bsr_matvec_packed, bsr_matvec_sym) on the card against the port on
    the CPU from the same inputs, f32 and f64: chip_smoke.check_bsr."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run chip_smoke.py on the card)")
    import chip_smoke

    chip_smoke.check_bsr(torch.device("cuda"))


@pytest.mark.cuda
def test_fused_w_rows_match_cpu_on_card():
    """The fused-W rows, built by K2 after the slot gather, on the card
    against the CPU, pads included, f32 and f64:
    chip_smoke.check_fused_w."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run chip_smoke.py on the card)")
    import chip_smoke

    chip_smoke.check_fused_w(torch.device("cuda"))


@pytest.mark.cuda
def test_k3_plan_matches_kernel_on_card():
    """k3_plan's capacity formula equals the cluster kernel's own check
    (rb_pcg_dense_cluster_plan in csrc/cg_dense.cu) at every N up to
    MAX_NC."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run chip_smoke.py on the card)")
    import chip_smoke

    chip_smoke.check_k3_plan()
