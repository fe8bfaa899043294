"""The explicit Schur complement (SCHUR_COMPLEMENT) and power-series
Schur complement (POWER_SCHUR_COMPLEMENT, PoBA) solvers.

Port of the JAX package's `solver/explicit_sc.py` (reference
sc/landmark_block.hpp, sc/linearization_sc.hpp,
sc/linearization_power_sc.hpp) on one device:

* Stage 1 linearizes every bucket in the bucket layout
  (linearization.LinBucket: Jp [L,n,2,9], Jl [L,n,2,3], r [L,n,2]) with
  the pose jacobi scaling applied to Jp (LinearizerBase._stage1_common).
* Hll^-1 is a batched closed-form 3x3 cofactor inverse per landmark.
* The reduced camera system H = Jp'Jp - Jp'Jl Hll^-1 Jl'Jp + lam I is
  assembled as the dense z-space matrix up to dense_rcs_max_cameras
  (sc_assemble_dense), as the BSR half/packed table above it
  (sc_assemble_bsr), both through the reducers of the pair gather that
  `pair_gather` names (stream or obs), whose block products are
  kernel K1 (pair block (c_i, c_j) = -(Hll^-1 T)_i' T_j with T = Jl'Jp;
  diagonal Jp'Jp - (Hll^-1 T)' T per camera), or, with
  dense_rcs_max_cameras=0, by the segment-sum scatter over unique
  camera pairs (sc_assemble).
* SC solves with pcg under the SCHUR_JACOBI, DIAGONAL or
  POWER_SCHUR_COMPLEMENT preconditioner; PoBA evaluates
  x = sum_i (Hpp^-1 E0)^i Hpp^-1 (-b) with the zeta test, E0 assembled
  densely, as a BSR table, or swept implicitly (e0_matvec).

Under a mesh (parallel.mesh) the dense and BSR modes are off, as in the
JAX package: SC assembles by the scatter and PoBA sweeps E0 implicitly,
every bucket holding this rank's landmark rows. Each sum over landmarks
is completed by one all-reduce: the RHS b, the [P+1, 81] pair blocks
once per stage2, the Jp gram blocks, every E0 sweep and l_diff;
sc_matvec reads the replicated H and needs none.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from rootba_tpu_torch.config.options import PreconditionerType
from rootba_tpu_torch.core import lie
from rootba_tpu_torch.log import trace
from rootba_tpu_torch.ops.block9 import chol9, chol9_inv, inv9_apply
from rootba_tpu_torch.parallel.mesh import all_reduce_sum, shard_rows
from rootba_tpu_torch.solver.cg import pcg
from rootba_tpu_torch.solver.linearization import (
    POSE_SIZE,
    BsrMatvecIndex,
    CamState,
    assemble_rcs_bsr,
    assemble_rcs_dense,
    bsr_build_table,
    build_pair_index,
    bsr_symmetric_fits,
    bsr_table_matvec,
    cam_reduce_stream,
    compute_error_buckets,
    csr_cam_reduce,
    segment_sum,
)

P9 = POSE_SIZE


def sc_matvec_dense(Hz: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """GEMV against the z-space dense RCS (the JAX package's
    explicit_sc.sc_matvec_dense): x [N, 9] is reordered to
    z[a*G+i] = x[i, a] around the product. A plain large GEMV outside
    any kernel, so torch.mv; float32 runs at full precision (no TF32,
    utils.device)."""
    N = x.shape[0]
    G = Hz.shape[0] // P9
    z2 = x.new_zeros((P9, G))
    z2[:, :N] = x.T
    y = torch.mv(Hz, z2.reshape(-1))
    return y.reshape(P9, G)[:, :N].T


def inv3x3(A: torch.Tensor) -> torch.Tensor:
    """Batched closed-form 3x3 inverse (cofactor expansion)."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    A11 = e * i - f * h
    A12 = c * h - b * i
    A13 = b * f - c * e
    A21 = f * g - d * i
    A22 = a * i - c * g
    A23 = c * d - a * f
    A31 = d * h - e * g
    A32 = b * g - a * h
    A33 = a * e - b * d
    det = a * A11 + b * A21 + c * A31
    inv_det = 1.0 / det
    M = torch.stack([torch.stack([A11, A12, A13], dim=-1),
                     torch.stack([A21, A22, A23], dim=-1),
                     torch.stack([A31, A32, A33], dim=-1)], dim=-2)
    return M * inv_det[..., None, None]


def damped_hll_inv(lin, bucket, lam) -> torch.Tensor:
    """(Jl_s' Jl_s + lam I)^-1 per landmark, zeroed for padded landmark
    rows (whose Jl is all-zero and would give NaN at lam = 0; the
    reference has no padded rows)."""
    L, n = lin.Jl.shape[0], lin.Jl.shape[1]
    Jl2 = lin.Jl.reshape(L, 2 * n, 3)
    eye = torch.eye(3, dtype=Jl2.dtype, device=Jl2.device)
    Hll = torch.einsum("lrc,lrd->lcd", Jl2, Jl2) + lam.to(Jl2.dtype) * eye
    inv = inv3x3(Hll)
    return torch.where(bucket.lm_mask[:, None, None], inv,
                       torch.zeros_like(inv))


class PairStructure(NamedTuple):
    """Static sparsity of the RCS for the scatter assembly: the unique
    ordered camera pairs (both directions and the diagonal) of every
    landmark's observations."""

    pair_row: torch.Tensor  # [P]
    pair_col: torch.Tensor  # [P]
    pair_ids: Tuple[torch.Tensor, ...]  # per bucket [L,n,n] (P = dummy)
    diag_pid: torch.Tensor  # [N] (P = camera unobserved)

    @property
    def num_pairs(self) -> int:
        return self.pair_row.shape[0]


def build_pair_structure(bp, num_cameras: int, device,
                         mesh=None) -> PairStructure:
    """The unique pairs of the whole problem; under a mesh each bucket's
    pair ids keep this rank's landmark rows."""
    with trace.span("prep.build.pair_structure"):
        return _build_pair_structure(bp, num_cameras, device, mesh)


def _build_pair_structure(bp, num_cameras, device, mesh):
    N = num_cameras
    codes_list = []
    for b in bp.buckets:
        rows = b.cam_idx[:, :, None].astype(np.int64)
        cols = b.cam_idx[:, None, :].astype(np.int64)
        valid = b.mask[:, :, None] & b.mask[:, None, :]
        codes_list.append(np.where(valid, rows * N + cols, N * N))
    valid_codes = (np.concatenate([c[c < N * N].ravel() for c in codes_list])
                   if codes_list else np.zeros(0, np.int64))
    unique = np.unique(valid_codes)
    P = unique.size
    diag_codes = np.arange(N, dtype=np.int64) * (N + 1)
    pos = np.searchsorted(unique, diag_codes)
    pos_clipped = np.minimum(pos, max(P - 1, 0))
    exists = (P > 0) & (unique[pos_clipped] == diag_codes)

    def up(a):
        return torch.as_tensor(np.asarray(a, np.int64), device=device)

    return PairStructure(
        pair_row=up(unique // N), pair_col=up(unique % N),
        pair_ids=tuple(up(shard_rows(np.searchsorted(unique, c), mesh))
                       for c in codes_list),
        diag_pid=up(np.where(exists, pos, P)))


class SCStage2(NamedTuple):
    H: torch.Tensor  # [P, 9, 9] RCS blocks of the scatter assembly
    b: torch.Tensor  # [N, 9]
    Hll_inv: Tuple[torch.Tensor, ...]  # per bucket [L,3,3] (damped)
    lam: torch.Tensor


def sc_rhs_and_hll(lins, buckets, lam, num_cameras, cam_csr=None,
                   cam_stream=None, mesh=None):
    """Per-bucket damped Hll^-1 and the RCS right-hand side
    b = Jp'(r - Jl Hll^-1 Jl' r) (landmark_block stage(),
    sc/landmark_block.hpp:342-364), reduced per camera through the
    camera stream, else the camera CSR, else a segment sum.
    Returns (b, Hll_invs)."""
    b = lins[0].Jp.new_zeros((num_cameras, P9))
    b_parts = []
    Hll_invs = []
    for lin, bucket in zip(lins, buckets):
        L, n = lin.Jp.shape[0], lin.Jp.shape[1]
        Jl2 = lin.Jl.reshape(L, 2 * n, 3)
        r2 = lin.r.reshape(L, 2 * n)
        Hll_inv = damped_hll_inv(lin, bucket, lam)
        Hll_invs.append(Hll_inv)
        bl = torch.einsum("lrc,lr->lc", Jl2, r2)
        hbl = torch.einsum("lcd,ld->lc", Hll_inv, bl)
        rr = lin.r - torch.einsum("lnrc,lc->lnr", lin.Jl, hbl)
        yb = torch.einsum("lnrj,lnr->lnj", lin.Jp, rr)
        if cam_stream is not None:
            b_parts.append(yb.reshape(L, n * P9))
        elif cam_csr is not None:
            b_parts.append(yb.reshape(-1, P9))
        else:
            b = b + segment_sum(yb.reshape(-1, P9), bucket.cam_idx.reshape(-1),
                                num_cameras)
    if cam_stream is not None:
        b = cam_reduce_stream(tuple(b_parts), buckets, cam_stream)
    elif cam_csr is not None:
        b = csr_cam_reduce(b_parts, cam_csr, num_cameras)
    return all_reduce_sum(b, mesh), tuple(Hll_invs)


def sc_assemble(lins, buckets, pairs: PairStructure, lam, num_cameras,
                cam_csr=None, mesh=None):
    """get_Hb (sc/linearization_sc.hpp:232-348 + landmark_block add_Hb)
    in block-sparse form: every ordered pair block of every landmark
    added into its unique pair by a segment sum (the JAX package's
    segment_sum). The dense_rcs_max_cameras=0 path, and SC's path under
    a mesh, where H's pair blocks are all-reduced once, before the
    damping."""
    P = pairs.num_pairs
    H = lins[0].Jp.new_zeros((P + 1, P9 * P9))
    b, Hll_invs = sc_rhs_and_hll(lins, buckets, lam, num_cameras,
                                 cam_csr=cam_csr, mesh=mesh)
    for lin, pid, Hll_inv in zip(lins, pairs.pair_ids, Hll_invs):
        # diagonal Jp_i' Jp_i at (c_i, c_i); SC coupling
        # -Jp_i' Jl_i Hll^-1 Jl_j' Jp_j at (c_i, c_j)
        n = lin.Jp.shape[1]
        D = torch.einsum("lnri,lnrj->lnij", lin.Jp, lin.Jp)
        T = torch.einsum("lnrc,lnrj->lncj", lin.Jl, lin.Jp)  # [L,n,3,9]
        HT = torch.einsum("lcd,lndj->lncj", Hll_inv, T)
        M = -torch.einsum("lnci,lmcj->lnmij", T, HT)  # [L,n,n,9,9]
        ar = torch.arange(n, device=pid.device)
        diag_pid_b = pid[:, ar, ar]  # [L,n]
        H = H + segment_sum(
            torch.cat([D.reshape(-1, P9 * P9), M.reshape(-1, P9 * P9)]),
            torch.cat([diag_pid_b.reshape(-1), pid.reshape(-1)]), P + 1)
    H = all_reduce_sum(H, mesh)
    # pose damping on the diagonal blocks (linearization_sc.hpp:317-320)
    eye9 = torch.eye(P9, dtype=H.dtype, device=H.device).reshape(P9 * P9)
    H.index_add_(0, pairs.diag_pid,
                 (lam.to(H.dtype) * eye9).repeat(num_cameras, 1))
    return SCStage2(H=H[:P].reshape(P, P9, P9), b=b,
                    Hll_inv=tuple(Hll_invs), lam=lam)


def _sc_strip_factors(lins, Hll_invs, cam_stream, with_jp: bool = True):
    """(HT, T, Jp) factors of the SC/E0 assemblies: T = Jl'Jp and
    HT = Hll^-1 T, per-bucket [L, n*27] tables (col c*9+j) and Jp
    [L, n*18] (col r*9+j) on the stream route (cam_stream given), else
    flat [O, 3, 9] / [O, 2, 9] arrays (the obs route)."""
    T_parts, HT_parts, Jp_parts = [], [], []
    for lin, Hll_inv in zip(lins, Hll_invs):
        L, n = lin.Jp.shape[0], lin.Jp.shape[1]
        # T[l,n,c,j] = sum_r Jl[l,n,r,c] Jp[l,n,r,j]
        T = torch.sum(lin.Jl[..., :, None] * lin.Jp[..., None, :], dim=2)
        HT = torch.sum(Hll_inv[:, None, :, :, None] * T[:, :, None, :, :],
                       dim=3)  # [L,n,3,9]
        T_parts.append(T.reshape(L, n * 3 * P9))
        HT_parts.append(HT.reshape(L, n * 3 * P9))
        Jp_parts.append(lin.Jp.reshape(L, n * 2 * P9))
    if cam_stream is not None:
        return (tuple(HT_parts), tuple(T_parts),
                tuple(Jp_parts) if with_jp else None)

    def flat(ts, K):
        return torch.cat([t.reshape(-1, K, P9) for t in ts], dim=0)

    return (flat(HT_parts, 3), flat(T_parts, 3),
            flat(Jp_parts, 2) if with_jp else None)


def sc_assemble_dense(lins, buckets, pairs, cam_stream, lam, num_cameras,
                      cam_csr=None):
    """Dense-RCS SC assembly through the pair and camera reducers of
    `pairs` / `cam_stream` (the camera CSR where cam_stream is None):
    pair block (c_i, c_j) = -(Hll^-1 T)_i' T_j with T = Jl'Jp, diagonal
    Jp_i'Jp_i - (Hll^-1 T)_i' T_i per camera (K1 folds both). Returns
    (H_dense, diag_blocks, b, Hll_invs)."""
    b, Hll_invs = sc_rhs_and_hll(lins, buckets, lam, num_cameras,
                                 cam_csr=cam_csr, cam_stream=cam_stream)
    HT, T, Jp = _sc_strip_factors(lins, Hll_invs, cam_stream)
    Hd, diag = assemble_rcs_dense(
        HT, T, pairs, lam, num_cameras, buckets, None, None,
        diag_terms=[(Jp, Jp, 1.0), (HT, T, -1.0)], csr=cam_csr,
        cam_stream=cam_stream)
    return Hd, diag, b, Hll_invs


def sc_assemble_bsr(lins, buckets, pairs, cam_stream, lam, num_cameras,
                    cam_csr=None, symmetric: bool = False):
    """Block-sparse SC assembly (the H of sc_assemble_dense without the
    densify). Returns (blocks, diag, b, Hll_invs) with blocks/diag as in
    linearization.assemble_rcs_bsr (the strict-pair half table with
    symmetric=True)."""
    b, Hll_invs = sc_rhs_and_hll(lins, buckets, lam, num_cameras,
                                 cam_csr=cam_csr, cam_stream=cam_stream)
    HT, T, Jp = _sc_strip_factors(lins, Hll_invs, cam_stream)
    blocks, diag = assemble_rcs_bsr(
        HT, T, pairs, lam, num_cameras, buckets, None, None,
        symmetric=symmetric, diag_terms=[(Jp, Jp, 1.0), (HT, T, -1.0)],
        csr=cam_csr, cam_stream=cam_stream)
    return blocks, diag, b, Hll_invs


def sc_matvec(stage2: SCStage2, pairs: PairStructure, num_cameras, x):
    """Block-sparse matvec over the scatter assembly's unique pairs
    (cg/block_sparse_matrix.hpp:223-249)."""
    xg = x[pairs.pair_col]  # [P,9]
    y = torch.einsum("pij,pj->pi", stage2.H, xg)
    return segment_sum(y, pairs.pair_row, num_cameras)


def sc_diag_blocks(stage2: SCStage2, pairs: PairStructure, num_cameras):
    """Per-camera diagonal 9x9 blocks of the scatter-assembled RCS
    (lam I for a camera without observations)."""
    H = stage2.H
    padded = torch.cat([H, H.new_zeros((1, P9, P9))], dim=0)
    blocks = padded[pairs.diag_pid]
    missing = pairs.diag_pid >= H.shape[0]
    fallback = stage2.lam.to(H.dtype) * torch.eye(P9, dtype=H.dtype,
                                                  device=H.device)
    return torch.where(missing[:, None, None], fallback, blocks)


def jp_gram_blockdiag(lins, buckets, lam, num_cameras, mesh=None):
    """Damped Jp'Jp block diagonal = get_jacobi
    (sc/linearization_sc.hpp:244-268), as a segment sum."""
    blocks = lins[0].Jp.new_zeros((num_cameras, P9, P9))
    for lin, bucket in zip(lins, buckets):
        blk = torch.einsum("lnri,lnrj->lnij", lin.Jp, lin.Jp)
        blocks = blocks + segment_sum(blk.reshape(-1, P9, P9),
                                      bucket.cam_idx.reshape(-1), num_cameras)
    blocks = all_reduce_sum(blocks, mesh)
    eye = torch.eye(P9, dtype=blocks.dtype, device=blocks.device)
    return blocks + lam.to(blocks.dtype) * eye


def e0_matvec(lins, buckets, Hll_invs, num_cameras, x, csr=None,
              mesh=None):
    """E0 x = Jp' Jl Hll^-1 Jl' Jp x (sc/linearization_power_sc.hpp
    :250-272), the implicit sweep."""
    y = torch.zeros_like(x)
    yb_rows = []
    for lin, bucket, Hll_inv in zip(lins, buckets, Hll_invs):
        xg = x[bucket.cam_idx]
        w = torch.einsum("lnrj,lnj->lnr", lin.Jp, xg)  # Jp x
        t = torch.einsum("lnrc,lnr->lc", lin.Jl, w)  # Jl' (Jp x)
        t = torch.einsum("lcd,ld->lc", Hll_inv, t)
        w = torch.einsum("lnrc,lc->lnr", lin.Jl, t)  # Jl Hll^-1 ...
        yb = torch.einsum("lnrj,lnr->lnj", lin.Jp, w)
        if csr is not None:
            yb_rows.append(yb.reshape(-1, P9))
        else:
            y = y + segment_sum(yb.reshape(-1, P9), bucket.cam_idx.reshape(-1),
                                num_cameras)
    if csr is not None:
        y = y + csr_cam_reduce(yb_rows, csr, num_cameras)
    return all_reduce_sum(y, mesh)


def power_series_solve(apply_hpp_inv, apply_e0, b, order: int,
                       q_tolerance: float):
    """x = sum_{i=0..order} (Hpp^-1 E0)^i Hpp^-1 (-b), terminated when
    zeta = i |tmp| / |acc| < q_tolerance (sc/linearization_power_sc.hpp
    :127-154). Returns (x, iterations). A q_tolerance <= 0 can never
    stop the series early (zeta >= 0), so the fixed-order series of
    the preconditioner reads nothing back per term."""
    acc = tmp = apply_hpp_inv(-b)
    i = 0
    while i < order:
        i += 1
        tmp = apply_hpp_inv(apply_e0(tmp))
        acc = acc + tmp
        if q_tolerance > 0:
            zeta = (float(i) * torch.linalg.vector_norm(tmp.reshape(-1))
                    / torch.linalg.vector_norm(acc.reshape(-1)))
            with trace.sync("power_series"):
                stop = bool(zeta < q_tolerance)
            if stop:
                break
    return acc, i


def sc_back_substitute(lins, buckets, Hll_invs, lm_ps, pose_inc,
                       compensated: bool = False, mesh=None):
    """Reference sc/landmark_block.hpp:409-446 back_substitute:
    dl = -Hll_lam^-1 Jl'(r + Jp dp); l_diff -= v'(0.5 v + r).
    compensated=True accumulates l_diff with error-free transforms
    (ops.compensated; the sum cancels under f32 near convergence)."""
    from rootba_tpu_torch.ops.compensated import comp_sum2, two_sum

    l_hi = pose_inc.new_zeros(())
    l_lo = pose_inc.new_zeros(())
    new_lm_ps = []
    for lin, bucket, Hll_inv, lm_p in zip(lins, buckets, Hll_invs, lm_ps):
        xg = pose_inc[bucket.cam_idx]
        w = torch.einsum("lnrj,lnj->lnr", lin.Jp, xg)
        u = lin.r + w
        t = torch.einsum("lnrc,lnr->lc", lin.Jl, u)
        dl_s = -torch.einsum("lcd,ld->lc", Hll_inv, t)
        dl_s = torch.where(bucket.lm_mask[:, None], dl_s,
                           torch.zeros_like(dl_s))
        v = w + torch.einsum("lnrc,lc->lnr", lin.Jl, dl_s)
        parts = v * (0.5 * v + lin.r)
        if compensated:
            bhi, blo = comp_sum2(parts)
            l_hi, e = two_sum(l_hi, -bhi)
            l_lo = l_lo + e - blo
        else:
            l_hi = l_hi - torch.sum(parts)
        new_lm_ps.append(lm_p + (dl_s * lin.Jl_scale).to(lm_p.dtype))
    if mesh is not None:
        l_hi, l_lo = all_reduce_sum(torch.stack([l_hi, l_lo]), mesh)
    return tuple(new_lm_ps), l_hi + l_lo


def e0_assemble_dense(lins, buckets, Hll_invs, pairs, cam_stream,
                      num_cameras, cam_csr=None):
    """E0 = Jp' Jl Hll^-1 Jl' Jp as a z-space dense matrix: the SC pair
    products with the diagonal blocks (Hll^-1 T)' T, through the pair
    and camera reducers (K1). The reference never materializes E0; one
    assembly per stage2 makes every power iteration a dense GEMV."""
    HT, T, _ = _sc_strip_factors(lins, Hll_invs, cam_stream, with_jp=False)
    zero_lam = lins[0].Jp.new_zeros(())
    # the assembly gives diag(terms) - pairs + 0 I = -E0; negate
    negE0, _ = assemble_rcs_dense(
        HT, T, pairs, zero_lam, num_cameras, buckets, None, None,
        diag_terms=[(HT, T, -1.0)], csr=cam_csr, cam_stream=cam_stream)
    return negE0.neg_()


def e0_assemble_bsr(lins, buckets, Hll_invs, pairs, cam_stream,
                    num_cameras, symmetric: bool = False, cam_csr=None):
    """Block-sparse E0 (the matrix of e0_assemble_dense, no densify).
    Returns the NEGATED (blocks, diag) pair: apply as
    e0(v) = -bsr_table_matvec(...)(v)."""
    HT, T, _ = _sc_strip_factors(lins, Hll_invs, cam_stream, with_jp=False)
    zero_lam = lins[0].Jp.new_zeros(())
    return assemble_rcs_bsr(
        HT, T, pairs, zero_lam, num_cameras, buckets, None, None,
        symmetric=symmetric, diag_terms=[(HT, T, -1.0)], csr=cam_csr,
        cam_stream=cam_stream)


def _dense_e0_from_h(H_dense, jacobi, lam):
    """SC's power preconditioner operator from the assembled dense H:
    E0 = blockdiag(Jp'Jp) - H + lam I, with Jp'Jp = jacobi - lam I
    (one elementwise pass, no second assembly)."""
    N = jacobi.shape[0]
    G = H_dense.shape[0] // P9
    dev = H_dense.device
    lam = lam.to(H_dense.dtype)
    gi = torch.arange(N, device=dev)
    a = torch.arange(P9, device=dev)
    rows = (a[:, None, None] * G + gi[None, None, :]).expand(P9, P9, N)
    cols = (a[None, :, None] * G + gi[None, None, :]).expand(P9, P9, N)
    eye = torch.eye(P9, dtype=jacobi.dtype, device=dev)
    dz = (jacobi - lam * eye).permute(1, 2, 0)  # [a, b, i]
    E0 = -H_dense
    E0[rows.reshape(-1), cols.reshape(-1)] += dz.reshape(-1)
    E0.diagonal().add_(lam)
    return E0


# ---------------------------------------------------------------------------
# Linearizer facades

from rootba_tpu_torch.solver.lm import LinearizerBase  # noqa: E402


class SCLinearizer(LinearizerBase):
    """SCHUR_COMPLEMENT solver (reference solver/linearizor_sc.cpp)."""

    linear_solver_type = "bal_sc"
    # the reference logs the SC assembly as prepare_time
    # (linearizor_sc.cpp get_Hb span)
    prepare_field = "prepare_time_in_seconds"

    def _build_rcs_index(self):
        """dense_rcs up to dense_rcs_max_cameras, bsr_rcs above it;
        dense_rcs_max_cameras=0 or a mesh disables both (the scatter
        assembly, or PoBA's implicit sweep). Builds the stream indices
        and, in BSR mode, the operator's index and its half-table
        decision."""
        opts = self.options
        N = self.num_cameras
        self.dense_rcs = (self.mesh is None
                          and 0 < N <= opts.dense_rcs_max_cameras)
        self.bsr_rcs = (self.mesh is None and not self.dense_rcs
                        and opts.dense_rcs_max_cameras > 0)
        self.pair_index = self.cam_stream = self.bsr = None
        self.bsr_sym = False
        if not (self.dense_rcs or self.bsr_rcs):
            return
        from rootba_tpu_torch.bal.bucketing import build_bsr_matvec

        self.pair_index, self.cam_stream, pairs_host = build_pair_index(
            self.bp.buckets, N, opts.pair_gather, self.device,
            dense_grid=self.dense_rcs)
        if self.bsr_rcs:
            with trace.span("prep.build.bsr_matvec"):
                self.bsr = BsrMatvecIndex.from_host(build_bsr_matvec(
                    pairs_host.pair_row, pairs_host.pair_col, N),
                    self.device)
            self.bsr_sym = bsr_symmetric_fits(
                self.bsr, self.dtype.itemsize,
                int(opts.bsr_pack_max_gb * (1 << 30)))

    def _build(self):
        opts = self.options
        self._build_rcs_index()
        self.pairs = None
        if not (self.dense_rcs or self.bsr_rcs):
            self.pairs = build_pair_structure(self.bp, self.num_cameras,
                                              self.device, self.mesh)
        precond_type = opts.preconditioner_type
        if precond_type not in (PreconditionerType.SCHUR_JACOBI,
                                PreconditionerType.DIAGONAL,
                                PreconditionerType.POWER_SCHUR_COMPLEMENT):
            raise ValueError(
                f"preconditioner {precond_type} not implemented for the "
                f"SCHUR_COMPLEMENT solver")
        # scalar DIAGONAL = diag of the SCHUR_JACOBI blocks (reference
        # preconditioner.hpp:48-69)
        self.precond_diag = precond_type == PreconditionerType.DIAGONAL
        self.use_power_precond = (
            precond_type == PreconditionerType.POWER_SCHUR_COMPLEMENT)

    def error(self, cams, lm_ps):
        return compute_error_buckets(cams, lm_ps, self.buckets,
                                     self.robust_norm, self.huber,
                                     mesh=self.mesh)

    def stage1(self, cams, lm_ps):
        return self._stage1_common(self.buckets, cams, lm_ps,
                                   csr=self.cam_csr)

    def stage2(self, lins, lam):
        """Assembly + preconditioner materials (reference get_Hb +
        preconditioner construction, linearizor_sc.cpp:112-177)."""
        N = self.num_cameras
        H_dense = None
        if self.dense_rcs:
            H_dense, diag, b, Hll_invs = sc_assemble_dense(
                lins, self.buckets, self.pair_index, self.cam_stream, lam,
                N, cam_csr=self.cam_csr)
            stage2 = SCStage2(H=b.new_zeros((0, P9, P9)), b=b,
                              Hll_inv=Hll_invs, lam=lam)
        elif self.bsr_rcs:
            half, diag, b, Hll_invs = sc_assemble_bsr(
                lins, self.buckets, self.pair_index, self.cam_stream, lam,
                N, cam_csr=self.cam_csr, symmetric=True)
            H_dense = (bsr_build_table(half, self.bsr, self.bsr_sym), diag)
            stage2 = SCStage2(H=b.new_zeros((0, P9, P9)), b=b,
                              Hll_inv=Hll_invs, lam=lam)
        else:
            stage2 = sc_assemble(lins, self.buckets, self.pairs, lam, N,
                                 cam_csr=self.cam_csr, mesh=self.mesh)
            diag = None

        chol = hpp_chol = E0 = None
        if not self.use_power_precond:
            if diag is None:
                diag = sc_diag_blocks(stage2, self.pairs, N)
            if self.precond_diag:
                diag = diag * torch.eye(P9, dtype=diag.dtype,
                                        device=diag.device)
            chol = chol9(diag)
        else:
            jacobi = jp_gram_blockdiag(lins, self.buckets, lam, N,
                                       mesh=self.mesh)
            hpp_chol = chol9(jacobi)
            if self.dense_rcs:
                E0 = _dense_e0_from_h(H_dense, jacobi, lam)
        return stage2, H_dense, chol, hpp_chol, E0

    def lsolve(self, lins, aux):
        opts = self.options
        stage2, H_dense, chol, hpp_chol, E0 = aux
        if self.dense_rcs:
            def matvec(x):
                return sc_matvec_dense(H_dense, x)
        elif self.bsr_rcs:
            table, diag_b = H_dense
            matvec = bsr_table_matvec(table, diag_b, self.bsr, self.bsr_sym)
        else:
            def matvec(x):
                return sc_matvec(stage2, self.pairs, self.num_cameras, x)

        if not self.use_power_precond:
            pinv = chol9_inv(chol)

            def precond(r):
                return inv9_apply(pinv, r)
        else:
            hpp_inv = chol9_inv(hpp_chol)

            def apply_hpp_inv(v):
                return inv9_apply(hpp_inv, v)

            if self.dense_rcs:
                def apply_e0(v):
                    return sc_matvec_dense(E0, v)
            else:
                csr = self.cam_csr

                def apply_e0(v):
                    return e0_matvec(lins, self.buckets, stage2.Hll_inv,
                                     self.num_cameras, v, csr=csr,
                                     mesh=self.mesh)

            def precond(r):
                # power_series_solve(v) = sum_i (Hpp^-1 E0)^i Hpp^-1 (-v);
                # the preconditioner applies the series to +r
                # (PowerSCPreconditioner::solve_assign, fixed order, no
                # tolerance) -> pass -r
                x, _ = power_series_solve(apply_hpp_inv, apply_e0, -r,
                                          opts.power_order, q_tolerance=-1.0)
                return x

        res = pcg(matvec, precond, stage2.b,
                  min_num_iterations=opts.min_linear_solver_iterations,
                  max_num_iterations=opts.max_linear_solver_iterations,
                  q_tolerance=opts.eta, r_tolerance=-1.0,
                  compensated=self.compensated)
        # we solve H(-x) = b -> negate (linearizor_base.cpp:99-101)
        return -res.x, stage2, res.num_iterations, res.termination_type

    def apply(self, cams: CamState, lm_ps, lins, stage2: SCStage2,
              pose_scale, inc):
        new_lm_ps, l_diff = sc_back_substitute(
            lins, self.buckets, stage2.Hll_inv, lm_ps, inc,
            compensated=self.compensated, mesh=self.mesh)
        inc_scaled = inc * pose_scale
        q, t = lie.apply_inc_pose(cams.q, cams.t, inc_scaled[:, :6])
        intr = cams.intr + inc_scaled[:, 6:9]
        return CamState(q=q, t=t, intr=intr), new_lm_ps, l_diff


class PowerSCLinearizer(SCLinearizer):
    """POWER_SCHUR_COMPLEMENT solver (reference
    solver/linearizor_power_sc.cpp): power-series solve, no CG. E0 is
    assembled once per stage2, densely up to dense_rcs_max_cameras and
    as a BSR table above; with dense_rcs_max_cameras=0 the implicit
    per-obs sweep (e0_matvec), like the reference."""

    linear_solver_type = "bal_power_sc"

    def _build(self):
        self._build_rcs_index()

    def stage2(self, lins, lam):
        """prepare_Hb (reference sc/linearization_power_sc.hpp:93-125):
        RHS + cached Hll^-1 + damped per-camera Hpp Cholesky + E0."""
        N = self.num_cameras
        b, Hll_invs = sc_rhs_and_hll(lins, self.buckets, lam, N,
                                     cam_csr=self.cam_csr,
                                     cam_stream=self.cam_stream,
                                     mesh=self.mesh)
        hpp_chol = chol9(jp_gram_blockdiag(lins, self.buckets, lam, N,
                                           mesh=self.mesh))
        E0 = None
        if self.dense_rcs:
            E0 = e0_assemble_dense(lins, self.buckets, Hll_invs,
                                   self.pair_index, self.cam_stream, N,
                                   cam_csr=self.cam_csr)
        elif self.bsr_rcs:
            neg_half, neg_diag = e0_assemble_bsr(
                lins, self.buckets, Hll_invs, self.pair_index,
                self.cam_stream, N, symmetric=True, cam_csr=self.cam_csr)
            E0 = (bsr_build_table(neg_half, self.bsr, self.bsr_sym),
                  neg_diag)
        stage2 = SCStage2(H=b.new_zeros((0, P9, P9)), b=b,
                          Hll_inv=Hll_invs, lam=lam)
        return stage2, hpp_chol, E0

    def lsolve(self, lins, aux):
        """Power-series solve (sc/linearization_power_sc.hpp:127-154)."""
        opts = self.options
        stage2, hpp_chol, E0 = aux
        hpp_inv = chol9_inv(hpp_chol)

        def apply_hpp_inv(v):
            return inv9_apply(hpp_inv, v)

        if self.dense_rcs:
            def apply_e0(v):
                return sc_matvec_dense(E0, v)
        elif self.bsr_rcs:
            neg_table, neg_diag = E0
            neg_mv = bsr_table_matvec(neg_table, neg_diag, self.bsr,
                                      self.bsr_sym)

            def apply_e0(v):
                return -neg_mv(v)
        else:
            csr = self.cam_csr

            def apply_e0(v):
                return e0_matvec(lins, self.buckets, stage2.Hll_inv,
                                 self.num_cameras, v, csr=csr,
                                 mesh=self.mesh)

        inc, iters = power_series_solve(apply_hpp_inv, apply_e0, stage2.b,
                                        opts.power_order,
                                        q_tolerance=opts.eta)
        return inc, stage2, iters, 1
