"""Square-root (QR) landmark marginalization in the bucket layout: the
einsum layout of the SQUARE_ROOT solver.

Port of the JAX package's `solver/sqrt_qr.py` (reference LinearizationQR,
qr/linearization_qr.hpp + qr/impl/landmark_block_base.ipp). It applies
the marginalized operator through the thin factors of the projection
identity

    Q2 Q2^T = I - Q1 Q1^T,     [Jl_s; sqrt(lam) I3] = Q1 R   (thin QR)

    (Q2^T Jp)^T (Q2^T Jp) x = Jp^T (w - Q1h (Q1h^T w)),  w = Jp x
    (Q2^T Jp)^T  Q2^T r     = Jp^T (r - Q1h (Q1h^T r))

with Q1h the top 2n rows of Q1, on the per-bucket tensors of
linearization.LinBucket (Jp [L,n,2,9], Jl [L,n,2,3], r [L,n,2]) with
batched einsums and per-camera sums. Landmark damping re-QRs the
augmented [Jl_s; sqrt(lam) I3] per solve; pose damping adds lam x to
the matvec and lam to the preconditioner diagonal.

The JAX package computes the preconditioner's Jp'Jp and W'W blocks by
repeat/tile products flattened to [O, 81] to dodge the TPU's (8, 128)
tiling of [.., 9, 9] shapes; here they are batched [O, 9, 9] products
of the same function.

Per-camera sums: stage2's RHS and preconditioner blocks by segment sum
(the JAX package's SqrtLinearizer never passes its stage2 the camera
CSR: 81-wide rows make the CSR gather slower than the scatter, and
stage2 runs once per solve), the matvec through the camera CSR when
given one, else by segment sum. Under a mesh (parallel.mesh) every
bucket holds this rank's landmark rows only, and each sum over
landmarks is completed by one all-reduce: stage2's b and blocks (one
collective), the matvec's landmark part (lam x is added once, after
it) and back substitution's l_diff (hi and lo).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from rootba_tpu_torch.ops.batched_qr import householder_qr3_planar, solve_upper
from rootba_tpu_torch.ops.block9 import chol9
from rootba_tpu_torch.parallel.mesh import LandmarkMesh, all_reduce_sum
from rootba_tpu_torch.solver.linearization import (
    POSE_SIZE,
    BucketIndex,
    CamCsrIndex,
    LinBucket,
    csr_cam_reduce,
    segment_sum,
)

P9 = POSE_SIZE


class SqrtStage2(NamedTuple):
    """Per-lambda marginalization data."""

    Q1h: Tuple[torch.Tensor, ...]  # per bucket [L, n, 2, 3]
    R: Tuple[torch.Tensor, ...]  # per bucket [L, 3, 3] damped upper factor
    b: torch.Tensor  # [N, 9] RHS = (Q2'Jp)' Q2'r
    precond_chol: torch.Tensor  # [N, 9, 9] Cholesky of precond blocks
    lam: torch.Tensor  # scalar


def _augmented_qr(lin: LinBucket, lam: torch.Tensor):
    """Thin QR of [Jl_s; sqrt(lam) I3] -> (R [L,3,3], Q1h [L,n,2,3])."""
    L, n = lin.Jl.shape[0], lin.Jl.shape[1]
    dtype = lin.Jl.dtype
    Jl2p = lin.Jl.reshape(L, 2 * n, 3).permute(1, 2, 0)  # [2n, 3, L]
    eye = torch.eye(3, dtype=dtype, device=lin.Jl.device)
    dampp = torch.sqrt(lam).to(dtype) * eye[:, :, None].expand(3, 3, L)
    Rp, Q1p = householder_qr3_planar(torch.cat([Jl2p, dampp], dim=0))
    R = Rp.permute(2, 0, 1)
    Q1 = Q1p.permute(2, 0, 1)
    return R, Q1[:, :2 * n, :].reshape(L, n, 2, 3)


def _project_out(Q1h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """w <- (I - Q1h Q1h^T) w per landmark; w [L,n,2], Q1h [L,n,2,3]."""
    t3 = torch.einsum("lnrc,lnr->lc", Q1h, w)
    return w - torch.einsum("lnrc,lc->lnr", Q1h, t3)


def sqrt_stage2(lin_buckets: Sequence[LinBucket],
                buckets: Sequence[BucketIndex], lam: torch.Tensor,
                num_cameras: int, *, precond_jacobi: bool = False,
                precond_diagonal: bool = False,
                mesh: Optional[LandmarkMesh] = None) -> SqrtStage2:
    """Per-lambda stage 2 (reference get_stage2,
    linearization_qr.hpp:716-815): landmark damping, RHS, SCHUR_JACOBI
    preconditioner blocks (Jp_i'Jp_i - W_i'W_i, W_i = Q1h_i'Jp_i), or
    with precond_jacobi the JACOBI blocks Jp'Jp + lam I (reference
    linearizor_qr.cpp:201-228), or with precond_diagonal their
    diagonal."""
    dtype = lin_buckets[0].Jp.dtype
    device = lin_buckets[0].Jp.device
    N = num_cameras
    sums = torch.zeros((N, P9 + P9 * P9), dtype=dtype, device=device)
    Q1hs, Rs = [], []
    for lin, bucket in zip(lin_buckets, buckets):
        R, Q1h = _augmented_qr(lin, lam)
        Q1hs.append(Q1h)
        Rs.append(R)
        L, n = lin.Jp.shape[0], lin.Jp.shape[1]
        # RHS: Jp^T (r - Q1h Q1h^T r)
        y = torch.einsum("lnrj,lnr->lnj", lin.Jp, _project_out(Q1h, lin.r))
        blk = torch.einsum("lnri,lnrj->lnij", lin.Jp, lin.Jp)
        if not precond_jacobi:
            W = torch.einsum("lnrc,lnrj->lncj", Q1h, lin.Jp)  # [L,n,3,9]
            blk = blk - torch.einsum("lnci,lncj->lnij", W, W)
        row = torch.cat([y.reshape(L * n, P9), blk.reshape(L * n, P9 * P9)],
                        dim=1)
        sums = sums + segment_sum(row, bucket.cam_idx.reshape(-1), N)
    sums = all_reduce_sum(sums, mesh)
    b = sums[:, :P9]
    blocks = sums[:, P9:].reshape(N, P9, P9)
    # pose damping on the preconditioner diagonal (JACOBI's explicit
    # damping and SCHUR_JACOBI's += lam, reference
    # linearizor_qr.cpp:216-232, linearization_qr.hpp:485-486)
    eye9 = torch.eye(P9, dtype=dtype, device=device)
    blocks = blocks + lam.to(dtype) * eye9
    if precond_diagonal:
        # scalar DIAGONAL (reference preconditioner.hpp:48-69): chol9 of a
        # diagonal block is its elementwise sqrt
        blocks = blocks * eye9
    return SqrtStage2(Q1h=tuple(Q1hs), R=tuple(Rs), b=b.contiguous(),
                      precond_chol=chol9(blocks), lam=lam.to(dtype))


def sqrt_matvec(lin_buckets: Sequence[LinBucket],
                buckets: Sequence[BucketIndex], stage2: SqrtStage2,
                num_cameras: int, x: torch.Tensor,
                csr: Optional[CamCsrIndex] = None,
                mesh: Optional[LandmarkMesh] = None) -> torch.Tensor:
    """y = [(Q2'Jp)'(Q2'Jp) + lam I] x (reference right_multiply,
    linearization_qr.hpp:823-825)."""
    acc = x.new_zeros((num_cameras, P9))
    rows = []
    for lin, bucket, Q1h in zip(lin_buckets, buckets, stage2.Q1h):
        w = torch.einsum("lnrj,lnj->lnr", lin.Jp, x[bucket.cam_idx])
        yb = torch.einsum("lnrj,lnr->lnj", lin.Jp, _project_out(Q1h, w))
        if csr is not None:
            rows.append(yb.reshape(-1, P9))
        else:
            acc = acc + segment_sum(yb.reshape(-1, P9),
                                    bucket.cam_idx.reshape(-1), num_cameras)
    if csr is not None:
        acc = csr_cam_reduce(rows, csr, num_cameras)
    return stage2.lam.to(x.dtype) * x + all_reduce_sum(acc, mesh)


def sqrt_back_substitute(lin_buckets: Sequence[LinBucket],
                         buckets: Sequence[BucketIndex], stage2: SqrtStage2,
                         lm_ps: Sequence[torch.Tensor],
                         pose_inc: torch.Tensor, compensated: bool = False,
                         mesh: Optional[LandmarkMesh] = None):
    """Landmark back substitution and the model-cost decrease (reference
    landmark_block_base.ipp:213-284):

        dl_s  = -R^-1 Q1h^T (r + Jp dp)
        l_diff -= v^T (0.5 v + r),  v = Jp dp + Jl_s dl_s
        lm_p  += dl_s * Jl_col_scale

    compensated=True accumulates l_diff with error-free transforms
    (ops.compensated; the sum cancels near convergence in float32)."""
    from rootba_tpu_torch.ops.compensated import comp_sum2, two_sum

    acc_dtype = torch.promote_types(pose_inc.dtype, torch.float32)
    l_hi = torch.zeros((), dtype=acc_dtype, device=pose_inc.device)
    l_lo = torch.zeros_like(l_hi)
    new_lm_ps = []
    for lin, bucket, Q1h, R, lm_p in zip(lin_buckets, buckets, stage2.Q1h,
                                         stage2.R, lm_ps):
        w = torch.einsum("lnrj,lnj->lnr", lin.Jp, pose_inc[bucket.cam_idx])
        rhs3 = torch.einsum("lnrc,lnr->lc", Q1h, lin.r + w)
        dl_s = -solve_upper(R, rhs3)  # [L, 3]
        # padded landmark rows (R can be anything there)
        dl_s = torch.where(bucket.lm_mask[:, None], dl_s,
                           torch.zeros_like(dl_s))
        v = w + torch.einsum("lnrc,lc->lnr", lin.Jl, dl_s)
        parts = (v * (0.5 * v + lin.r)).to(acc_dtype)
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
