"""The plain twins of the port's three kernels against the JAX package's
Pallas kernels (run in interpret mode on the CPU, as the JAX package's
own tests run them) and their XLA counterparts, and -- on a card only --
each CUDA kernel against its twin.

K1 fold_plain      vs outer81_fold_pallas / _outer81_fold
K2 w_build_plain   vs w_build_table (n <= 16) / the elementwise chain
K3 pcg_dense_plain vs pcg_dense_vmem / solver.cg.pcg, on padded and
   unpadded systems; k3_plan, the size switch between K3's two kernels

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
    (92, 128, "cluster", 52),    # the largest slab a CTA holds
    (93, 128, "grid", 0),
    (126, 128, "grid", 0),       # trafalgar-126
    (0, 128, "grid", 0),
    (300, 1024, "grid", 0),      # pallas_cg="on" up to MAX_NC
])
def test_k3_plan(N, Nc, kernel, rows):
    """K3's size switch: the cluster kernel (16 CTAs) while a CTA's slab
    of ceil(9N / 16) real rows, its vectors and Lp fit in 227 KB of shared
    memory; else the grid kernel. One camera more moves N = 0 and N = 92
    to the other kernel. (The card test holds k3_plan equal to the
    kernel's own capacity check.)"""
    plan = cg_dense.k3_plan(N, Nc)
    assert (plan.kernel, plan.rows_per_cta) == (kernel, rows)
    assert plan.cluster == (cg_dense.CLUSTER if kernel == "cluster" else 0)
    assert plan.smem_bytes <= cg_dense.SMEM_LIMIT
    if kernel == "cluster":
        assert rows == -(-9 * N // 16) <= cg_dense.MAX_ROWS_PER_CTA
        assert N <= cg_dense.MAX_LANES
        assert plan.smem_bytes == cg_dense.cluster_smem_bytes(N, rows)
    else:
        assert N == 0 or cg_dense.cluster_smem_bytes(
            N, -(-9 * N // 16)) > cg_dense.SMEM_LIMIT
    if N + 1 <= Nc:
        nxt = cg_dense.k3_plan(N + 1, Nc)
        assert (nxt.kernel != kernel) == (N in (0, 92))


def test_k3_plan_rejects():
    with pytest.raises(ValueError, match="camera lanes"):
        cg_dense.k3_plan(200, 1152)
    with pytest.raises(ValueError, match="N <= Nc"):
        cg_dense.k3_plan(50, 49)


def test_k3_launch_follows_plan(monkeypatch):
    """_launch hands each system to the kernel k3_plan names; neither
    launcher stands in for the other."""
    seen = []
    monkeypatch.setattr(cg_dense, "_launch_cluster",
                        lambda Hz, b2, Lp, N, **kw: seen.append(
                            ("cluster", N)))
    monkeypatch.setattr(cg_dense, "_launch_grid",
                        lambda Hz, b2, Lp, **kw: seen.append(("grid",)))
    for N in (20, 49, 92, 93, 100):
        cg_dense._launch(torch.zeros(1152, 1152), None, None, N,
                         max_iters=1)
    assert seen == [("cluster", 20), ("cluster", 49), ("cluster", 92),
                    ("grid",), ("grid",)]


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
    a stream long enough to cycle its copy pipeline; K2; both K3 kernels
    on both sides of each size switch, through the residual reset, and
    through the wrapper pcg_dense."""
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
def test_k3_plan_matches_kernel_on_card():
    """k3_plan's capacity formula equals the cluster kernel's own check
    (rb_pcg_dense_cluster_plan in csrc/cg_dense.cu) at every N up to
    MAX_NC."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run chip_smoke.py on the card)")
    import chip_smoke

    chip_smoke.check_k3_plan()
