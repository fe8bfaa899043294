"""Flat-layout SQUARE_ROOT solver: the port's main path.

Port of the JAX package's `solver/sqrt_flat.py` (projection-form sqrt
marginalization). Every per-observation tensor is a per-bucket 2-D
landmark-row table

    Jp [L, n*18]   Q0R0 [L, n*6+9]   r [L, n*2]   Q1h [L, n*6]

(one landmark per row, slot-major columns; see FlatLin). Reference
mapping: stage1 = linearize+scale (linearizor_qr.cpp:78-138), stage2 =
damp+RHS+precond (:141-265), matvec = right_multiply
(linearization_qr.hpp:823-825), apply = back_substitute (:267-291).

Three CG operators are ported: 'dense' (the explicit reduced camera
system, assembled once per stage2 through kernels K1 and K2, solved by
kernel K3 when it is small enough or by pcg on dense GEMVs), 'bsr' (the
same system's camera-pair blocks only, assembled through K1 and K2, pcg
on the block-sparse operator) and 'implicit' (matrix-free, the
reference's own). The explicit system's pair and camera sums go
through the pair gather that `pair_gather` names: 'stream' or 'obs'.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from rootba_tpu_torch.config.options import PreconditionerType
from rootba_tpu_torch.core import lie
from rootba_tpu_torch.log import trace
from rootba_tpu_torch.ops import fold
from rootba_tpu_torch.ops.batched_qr import householder_qr3_planar, solve_upper
from rootba_tpu_torch.ops.block9 import chol9, chol9_inv, inv9_apply
from rootba_tpu_torch.solver.cg import pcg
from rootba_tpu_torch.solver.explicit_sc import sc_matvec_dense
from rootba_tpu_torch.solver.linearization import (
    POSE_SIZE,
    BsrMatvecIndex,
    CamCsrIndex,
    CamState,
    PairStreamIndex,
    StreamFactors,
    _broadcast_lm,
    _map_rows,
    assemble_rcs_bsr,
    assemble_rcs_dense,
    bsr_build_table,
    bsr_symmetric_fits,
    bsr_table_matvec,
    build_pair_index,
    cam_gram_stream,
    cam_reduce_stream,
    csr_cam_reduce,
    gather_cam_planes,
    packed_cam_table,
    pair_slots,
    segment_sum,
)

P9 = POSE_SIZE

# materialized-W table budget of the stream reducers (see _rcs_factors):
# above this many bytes the reducers gather (Q1h, Jp) factor rows and
# build W rows after the gather instead. Module global so tests can
# force the fused path at toy size.
_FUSED_W_MIN_BYTES = 1_500_000_000


class FlatLin(NamedTuple):
    """Stage-1 output: per-bucket 2-D landmark-row tables.

    Jp is stored UNSCALED; the jacobi pose scale S (pose_scale, [N,9])
    is applied by the per-camera/per-pair consumers (b = S b_u,
    H_ij = S_i H_u,ij S_j). Q0R0 packs the undamped thin-QR factors of
    the scaled Jl (cols 0..n*6 = Q0, col i*6+r*3+c; cols n*6..n*6+9 =
    R0 row-major): the damped factors of every lambda follow from a
    6x3 re-QR of [R0; sqrt(lam) I]."""

    Jp: Tuple[torch.Tensor, ...]  # per bucket [L, n*18], col i*18+r*9+a
    Q0R0: Tuple[torch.Tensor, ...]  # per bucket [L, n*6+9]
    r: Tuple[torch.Tensor, ...]  # per bucket [L, n*2], col i*2+r
    Jl_scale: Tuple[torch.Tensor, ...]  # per bucket [L,3]
    pose_scale: torch.Tensor  # [N,9]
    # lambda-independent per-camera Jp'Jp gram [N, 81] (unscaled) of the
    # explicit mode, so each attempt only reduces its -W'W part
    diag_jp81: Optional[torch.Tensor]


class FlatStage2(NamedTuple):
    """Per-lambda marginalization data."""

    Q1h: Tuple[torch.Tensor, ...]  # per bucket [L, n*6], col i*6+r*3+c
    R: Tuple[torch.Tensor, ...]  # per bucket [L,3,3]
    b: torch.Tensor  # [N,9]
    precond_chol: torch.Tensor  # [N,9,9]
    lam: torch.Tensor


def _cam_flat(buckets):
    return torch.cat([b.cam_idx.reshape(-1) for b in buckets])


def flat_linearize(cams: CamState, lm_ps, buckets, robust_norm,
                   huber_parameter, use_valid_only, jacobi_eps,
                   jacobi_scaling, num_cameras, cam_stream=None,
                   csr: Optional[CamCsrIndex] = None):
    """Stage 1: linearize + Jl column scaling + undamped Jl QR + jacobi
    pose scaling, all buckets in one pass (reference get_stage1,
    linearization_qr.hpp:634-712). With the camera stream (the explicit
    modes' stream route) one K1 pass reduces the whole Jp gram, which the
    attempts' assembly reuses, and diag2 is its block diagonal; else the
    per-camera diag2 reduce goes through the camera CSR
    (reduction_alg != 0), else a segment sum. Returns (FlatLin,
    pose_scale, failures)."""
    from rootba_tpu_torch.ops.planar import robust_sqrt_weight, snavely_planes

    table = packed_cam_table(cams)
    jp_us, jl_parts, r_parts, d2_parts, scales = [], [], [], [], []
    failures = table.new_zeros((), dtype=torch.int64)
    for lm_p, bucket in zip(lm_ps, buckets):
        L, n = bucket.cam_idx.shape

        def lin_chunk(ts, n=n):
            lmp_c, cam_c, uv_c, mask_c = ts
            Lc = cam_c.shape[0]
            X, Y, Z = _broadcast_lm(lmp_c, n)
            res_u, res_v, valid, Jp_pl, Jl_pl = snavely_planes(
                *gather_cam_planes(table, cam_c.reshape(-1)), X, Y, Z,
                uv_c[..., 0].reshape(-1), uv_c[..., 1].reshape(-1))
            sw, use_mask = robust_sqrt_weight(
                res_u, res_v, valid, mask_c.reshape(-1), robust_norm,
                huber_parameter, use_valid_only)
            finite = torch.isfinite(res_u) & torch.isfinite(res_v)
            for v in Jp_pl + Jl_pl:
                finite = finite & torch.isfinite(v)
            fail = (use_mask & ~finite).reshape(Lc, n).sum(dim=1)
            jp_f = torch.stack([sw * p for p in Jp_pl], dim=-1)  # [Lc*n,18]
            jl_f = torch.stack([sw * p for p in Jl_pl], dim=-1)  # [Lc*n,6]
            r_c = torch.stack([sw * res_u, sw * res_v],
                              dim=-1).reshape(Lc, n * 2)

            # landmark-Jacobian column scaling
            # (landmark_block_base.ipp:572-587): col2[c], both rows
            col2 = jl_f[:, :3] * jl_f[:, :3] + jl_f[:, 3:] * jl_f[:, 3:]
            nrm = torch.sqrt(col2.reshape(Lc, n, 3).sum(dim=1))
            scale = 1.0 / (jacobi_eps + nrm)  # [Lc,3]
            se = scale[:, None, :].expand(Lc, n, 3).reshape(Lc * n, 3)
            jl_c = (jl_f * se.repeat(1, 2)).reshape(Lc, n * 6)

            # undamped thin-QR of the scaled Jl (see FlatLin.Q0R0)
            R0p, Q0p = householder_qr3_planar(jl_c.T.reshape(2 * n, 3, Lc))
            q0_c = Q0p.permute(2, 0, 1).reshape(Lc, n * 6)
            r0_c = R0p.permute(2, 0, 1).reshape(Lc, 9)
            q0r0_c = torch.cat([q0_c, r0_c], dim=1)

            jp2 = jp_f * jp_f
            d2_c = (jp2[:, :P9] + jp2[:, P9:]).reshape(Lc, n * P9)
            return (jp_f.reshape(Lc, n * 18), q0r0_c, r_c, d2_c, scale,
                    fail)

        jp_b, jl_b, r_b, d2_b, scale_b, fail_b = _map_rows(
            lin_chunk, [lm_p, bucket.cam_idx, bucket.obs_uv, bucket.mask],
            L, n)
        failures = failures + fail_b.sum()
        r_parts.append(r_b)
        scales.append(scale_b)
        jl_parts.append(jl_b)
        d2_parts.append(d2_b)
        jp_us.append(jp_b)

    # pose jacobi scaling (add_Jp_diag2 -> linearizor_qr.cpp:104-110)
    diag_jp81 = None
    if cam_stream is not None:
        # one K1 pass yields the full lambda-independent Jp gram; diag2
        # is its block diagonal
        jp_t = tuple(jp_us)
        diag_jp81 = cam_gram_stream([(jp_t, jp_t, 1.0)], buckets,
                                    cam_stream)
        diag2 = torch.diagonal(diag_jp81.reshape(num_cameras, P9, P9),
                               dim1=1, dim2=2)
    elif csr is not None:
        diag2 = csr_cam_reduce([d.reshape(-1, P9) for d in d2_parts], csr,
                               num_cameras)
    else:
        diag2 = segment_sum(
            torch.cat([d.reshape(-1, P9) for d in d2_parts]),
            _cam_flat(buckets), num_cameras)
    if jacobi_scaling:
        pose_scale = 1.0 / (jacobi_eps + torch.sqrt(diag2))
    else:
        pose_scale = torch.ones_like(diag2)
    return (FlatLin(Jp=tuple(jp_us), Q0R0=tuple(jl_parts),
                    r=tuple(r_parts), Jl_scale=tuple(scales),
                    pose_scale=pose_scale, diag_jp81=diag_jp81),
            pose_scale, failures)


def flat_stage2(lin: FlatLin, buckets, lam: torch.Tensor, num_cameras,
                *, precond_jacobi: bool = False,
                precond_diagonal: bool = False, with_precond: bool = True,
                cam_stream=None,
                csr: Optional[CamCsrIndex] = None) -> FlatStage2:
    """Stage 2 (reference get_stage2, linearization_qr.hpp:716-815):
    landmark damping via the 6x3 re-QR, RHS, preconditioner.
    with_precond=False skips the per-obs Gram preconditioner pass (the
    explicit mode takes its blocks from the assembled H). The RHS
    reduces as stage1's diag2; the preconditioner blocks by a segment
    sum, as in the JAX package."""
    dtype = lin.Jp[0].dtype
    device = lin.Jp[0].device
    eye3 = torch.eye(3, dtype=dtype, device=device)

    Q1h_parts = []
    Rs = []
    for bucket, q0r0_b in zip(buckets, lin.Q0R0):
        L, n = bucket.cam_idx.shape

        # [Jl; sqrt(lam) I] = blockdiag(Q0, I) [R0; sqrt(lam) I]: one
        # planar 6-row QR plus a 3x3 rotation of Q0 per landmark
        def qr_chunk(ts, n=n):
            q0r0_c = ts[0]
            Lc = q0r0_c.shape[0]
            R0p = q0r0_c[:, n * 6:].T.reshape(3, 3, Lc)
            dampp = torch.sqrt(lam).to(dtype) * eye3[:, :, None].expand(
                3, 3, Lc)
            Rtp, Qtp = householder_qr3_planar(torch.cat([R0p, dampp], 0))
            R_c = Rtp.permute(2, 0, 1)
            Q0p = q0r0_c[:, :n * 6].T.reshape(2 * n, 3, Lc)
            Qt3 = Qtp[:3]  # [3(c), 3(c'), Lc]
            Q1p = (Q0p[:, 0:1, :] * Qt3[0][None]
                   + Q0p[:, 1:2, :] * Qt3[1][None]
                   + Q0p[:, 2:3, :] * Qt3[2][None])  # [2n,3,Lc]
            return R_c, Q1p.permute(2, 0, 1).reshape(Lc, n * 6)

        R, Q1h_b = _map_rows(qr_chunk, [q0r0_b], L, n)
        Rs.append(R)
        Q1h_parts.append(Q1h_b)
    Q1h = tuple(Q1h_parts)

    # RHS: Jp^T (r - Q1h Q1h^T r), per bucket, row-chunked
    ybp = []
    for bucket, q_b, r_b, jp_b in zip(buckets, Q1h, lin.r, lin.Jp):
        L, n = bucket.cam_idx.shape

        def rhs_chunk(ts, n=n):
            q_c, r_c, jp_c = ts
            Lc = q_c.shape[0]
            qf = q_c.reshape(Lc * n, 6)
            rf = r_c.reshape(Lc * n, 2)
            jpf = jp_c.reshape(Lc * n, 18)
            p3 = qf[:, :3] * rf[:, 0:1] + qf[:, 3:] * rf[:, 1:2]
            t3 = p3.reshape(Lc, n, 3).sum(dim=1)
            t3e = t3[:, None, :].expand(Lc, n, 3).reshape(Lc * n, 3)
            wp0 = rf[:, 0] - torch.sum(qf[:, :3] * t3e, dim=1)
            wp1 = rf[:, 1] - torch.sum(qf[:, 3:] * t3e, dim=1)
            yb = jpf[:, :P9] * wp0[:, None] + jpf[:, P9:] * wp1[:, None]
            return yb.reshape(Lc, n * P9)

        ybp.append(_map_rows(rhs_chunk, [q_b, r_b, jp_b], L, n))
    if cam_stream is not None:
        b = cam_reduce_stream(tuple(ybp), buckets, cam_stream)
    elif csr is not None:
        b = csr_cam_reduce([y.reshape(-1, P9) for y in ybp], csr,
                           num_cameras)
    else:
        b = segment_sum(torch.cat([y.reshape(-1, P9) for y in ybp]),
                        _cam_flat(buckets), num_cameras)
    b = b * lin.pose_scale

    if not with_precond:
        return FlatStage2(Q1h=Q1h, R=tuple(Rs), b=b,
                          precond_chol=b.new_zeros((0, P9, P9)), lam=lam)

    # preconditioner blocks: JACOBI = sum Jp_o' Jp_o; SCHUR_JACOBI
    # subtracts W' W with W = Q1h_o' Jp_o, as [*, 81] rows
    def gram81_2d(rows):
        out = None
        for m in rows:
            t = m.repeat_interleave(P9, dim=1) * m.repeat(1, P9)
            out = t if out is None else out + t
        return out

    blocks = b.new_zeros((num_cameras, P9 * P9))
    for bucket, q_b, jp_b in zip(buckets, Q1h, lin.Jp):
        L, n = bucket.cam_idx.shape
        qf = q_b.reshape(L * n, 6)
        jpf = jp_b.reshape(L * n, 18)
        blk = gram81_2d([jpf[:, :P9], jpf[:, P9:]])
        if not precond_jacobi:
            W27 = fold.w_build(qf, jpf, 1)
            blk = blk - gram81_2d(
                [W27[:, c * P9:(c + 1) * P9] for c in range(3)])
        blocks = blocks + segment_sum(blk, bucket.cam_idx.reshape(-1),
                                      num_cameras)
    ps = lin.pose_scale
    blocks = blocks * (ps.repeat_interleave(P9, dim=1) * ps.repeat(1, P9))
    eye9 = torch.eye(P9, dtype=dtype, device=device)
    blocks = blocks.reshape(num_cameras, P9, P9) + lam * eye9
    if precond_diagonal:
        # scalar DIAGONAL preconditioner (preconditioner.hpp:48-69)
        blocks = blocks * eye9
    return FlatStage2(Q1h=Q1h, R=tuple(Rs), b=b, precond_chol=chol9(blocks),
                      lam=lam)


def _rcs_factors(lin: FlatLin, stage2: FlatStage2, buckets, pairs):
    """W = Q1h'Jp strip factors, built per bucket by kernel K2: on the
    stream route the per-bucket [L, n*27] tables, or above
    _FUSED_W_MIN_BYTES of tables the (Q1h, Jp) StreamFactors instead,
    whose W rows the stream reducers build after each slot gather, by K2
    on the gathered rows (24 values gathered per slot instead of 27, and
    no resident W table); on the obs route their flat [O, 3, 9] form."""
    stream = isinstance(pairs, PairStreamIndex)
    slots = sum(b.cam_idx.shape[0] * b.cam_idx.shape[1] for b in buckets)
    if stream and slots * 27 * lin.Jp[0].element_size() > _FUSED_W_MIN_BYTES:
        return StreamFactors(q=tuple(stage2.Q1h), jp=tuple(lin.Jp))
    Wp = tuple(fold.w_build(q_b, jp_b, bucket.cam_idx.shape[1])
               for bucket, q_b, jp_b in zip(buckets, stage2.Q1h, lin.Jp))
    if stream:
        return Wp
    return torch.cat([w.reshape(-1, 3, P9) for w in Wp], dim=0)


def _assemble(assembler, lin: FlatLin, stage2: FlatStage2, pairs,
              num_cameras, buckets, cam_stream, csr, **kw):
    """The explicit system by `assembler` (assemble_rcs_dense or _bsr):
    the W factors' pair products and the diagonal blocks -- on the
    stream route stage1's cached Jp gram less this attempt's W'W (one K1
    pass), on the obs route Jp'Jp - W'W reduced by the assembler."""
    W = _rcs_factors(lin, stage2, buckets, pairs)
    diag81 = diag_terms = None
    if cam_stream is not None:
        diag81 = lin.diag_jp81 + cam_gram_stream([(W, W, -1.0)], buckets,
                                                 cam_stream)
    else:
        Jpf = torch.cat([j.reshape(-1, 2, P9) for j in lin.Jp], dim=0)
        diag_terms = [(Jpf, Jpf, 1.0), (W, W, -1.0)]
    return assembler(W, W, pairs, stage2.lam, num_cameras, buckets,
                     lin.pose_scale, diag81, diag_terms=diag_terms,
                     csr=csr, cam_stream=cam_stream, **kw)


def flat_assemble_rcs(lin: FlatLin, stage2: FlatStage2, pairs, num_cameras,
                      buckets, cam_stream, csr=None):
    """The explicit reduced camera system of the sqrt solver,

        H = Jp'Jp - (Q1'Jp)'(Q1'Jp) + lam I = (Q2'Jp)'(Q2'Jp) + lam I,

    as the dense z-space [9G, 9G] matrix plus its per-camera diagonal
    blocks (the SCHUR_JACOBI preconditioner, free). Block (c_i, c_j) =
    delta_ij Jp_i'Jp_i - W_i'W_j with W_o = Q1h_o'Jp_o. csr: the camera
    CSR of the obs route's diagonal blocks."""
    return _assemble(assemble_rcs_dense, lin, stage2, pairs, num_cameras,
                     buckets, cam_stream, csr)


def flat_assemble_rcs_bsr(lin: FlatLin, stage2: FlatStage2, pairs,
                          num_cameras, buckets, cam_stream,
                          symmetric=False, csr=None):
    """Block-sparse form of flat_assemble_rcs (the same H, no densify):
    (blocks [2P, 81], diag [N, 9, 9]), or with symmetric=True the
    [P, 81] strict-pair half table (see linearization.assemble_rcs_bsr).
    """
    return _assemble(assemble_rcs_bsr, lin, stage2, pairs, num_cameras,
                     buckets, cam_stream, csr, symmetric=symmetric)


def flat_matvec(lin: FlatLin, stage2: FlatStage2, buckets, num_cameras,
                x: torch.Tensor,
                csr: Optional[CamCsrIndex] = None) -> torch.Tensor:
    """y = [(Q2'Jp)'(Q2'Jp) + lam I] x (right_multiply,
    linearization_qr.hpp:823-825), with the deferred pose scale:
    y = lam x + S reduce(Jp_u' ... Jp_u (S x)), the per-camera reduce
    through the camera CSR when given, else a segment sum."""
    xs = x * lin.pose_scale
    ybp = []
    for bucket, q_b, jp_b in zip(buckets, stage2.Q1h, lin.Jp):
        L, n = bucket.cam_idx.shape
        qf = q_b.reshape(L * n, 6)
        jpf = jp_b.reshape(L * n, 18)
        xg = xs[bucket.cam_idx.reshape(-1)]
        w0 = torch.sum(jpf[:, :P9] * xg, dim=1)
        w1 = torch.sum(jpf[:, P9:] * xg, dim=1)
        p3 = qf[:, :3] * w0[:, None] + qf[:, 3:] * w1[:, None]
        t3 = p3.reshape(L, n, 3).sum(dim=1)
        t3e = t3[:, None, :].expand(L, n, 3).reshape(L * n, 3)
        wp0 = w0 - torch.sum(qf[:, :3] * t3e, dim=1)
        wp1 = w1 - torch.sum(qf[:, 3:] * t3e, dim=1)
        ybp.append(jpf[:, :P9] * wp0[:, None] + jpf[:, P9:] * wp1[:, None])
    if csr is not None:
        red = csr_cam_reduce(ybp, csr, num_cameras)
    else:
        red = segment_sum(torch.cat(ybp, dim=0), _cam_flat(buckets),
                          num_cameras)
    return stage2.lam.to(x.dtype) * x + lin.pose_scale * red


def flat_back_substitute(lin: FlatLin, stage2: FlatStage2, buckets, lm_ps,
                         pose_inc: torch.Tensor, compensated: bool = False):
    """Landmark back-substitution + model cost decrease
    (landmark_block_base.ipp:213-284); compensated=True sums l_diff with
    error-free transforms (ops.compensated)."""
    inc_pre = pose_inc * lin.pose_scale
    new_lm_ps = []
    bucket_sums = []
    for bucket, jp_b, q0r0_b, r_b, q_b, R, scale, lm_p in zip(
            buckets, lin.Jp, lin.Q0R0, lin.r, stage2.Q1h, stage2.R,
            lin.Jl_scale, lm_ps):
        L, n = bucket.cam_idx.shape

        def bsub_chunk(ts, n=n):
            jp_c, q0r0_c, r_c, q_c, cam_c, mask_c, R_c, sc_c, lm_c = ts
            Lc = jp_c.shape[0]
            jpf = jp_c.reshape(Lc * n, 18)
            rf = r_c.reshape(Lc * n, 2)
            qf = q_c.reshape(Lc * n, 6)
            xg = inc_pre[cam_c.reshape(-1)]
            w0 = torch.sum(jpf[:, :P9] * xg, dim=1)
            w1 = torch.sum(jpf[:, P9:] * xg, dim=1)
            u0 = rf[:, 0] + w0
            u1 = rf[:, 1] + w1
            p3 = qf[:, :3] * u0[:, None] + qf[:, 3:] * u1[:, None]
            rhs = p3.reshape(Lc, n, 3).sum(dim=1)  # [Lc,3]
            dl_s = -solve_upper(R_c, rhs)
            dl_s = torch.where(mask_c[:, None], dl_s, torch.zeros_like(dl_s))
            new_lm = lm_c + (dl_s * sc_c).to(lm_c.dtype)
            # Jl dl = Q0 (R0 dl) (Jl itself is not stored)
            R0_c = q0r0_c[:, n * 6:].reshape(Lc, 3, 3)
            rdl = torch.sum(R0_c * dl_s[:, None, :], dim=2)  # [Lc,3]
            rdl_e = rdl[:, None, :].expand(Lc, n, 3).reshape(Lc * n, 3)
            q0f = q0r0_c[:, :n * 6].reshape(Lc * n, 6)
            v0 = w0 + torch.sum(q0f[:, :3] * rdl_e, dim=1)
            v1 = w1 + torch.sum(q0f[:, 3:] * rdl_e, dim=1)
            parts = (v0 * (0.5 * v0 + rf[:, 0])
                     + v1 * (0.5 * v1 + rf[:, 1]))
            return new_lm, parts.reshape(Lc, n).sum(dim=1)

        new_lm, lsum = _map_rows(
            bsub_chunk,
            [jp_b, q0r0_b, r_b, q_b, bucket.cam_idx, bucket.lm_mask, R,
             scale, lm_p], L, n)
        new_lm_ps.append(new_lm)
        if compensated:
            from rootba_tpu_torch.ops.compensated import comp_sum

            bucket_sums.append(comp_sum(lsum))
        else:
            bucket_sums.append(lsum.sum())
    l_diff = -torch.stack(bucket_sums).sum()
    return tuple(new_lm_ps), l_diff


# ---------------------------------------------------------------------------

from rootba_tpu_torch.solver.lm import LinearizerBase  # noqa: E402


class FlatSqrtLinearizer(LinearizerBase):
    """SQUARE_ROOT solver on flat per-bucket tables (default layout)."""

    linear_solver_type = "bal_qr"

    def _build(self):
        opts = self.options
        if self.mesh is not None:
            raise ValueError("the flat layout runs unsharded; a mesh takes "
                             "the einsum layout (create_linearizer)")
        self.precond_jacobi = (opts.preconditioner_type
                               == PreconditionerType.JACOBI)
        # scalar DIAGONAL = diag of the SCHUR_JACOBI blocks
        self.precond_diag = (opts.preconditioner_type
                             == PreconditionerType.DIAGONAL)
        if opts.preconditioner_type not in (
                PreconditionerType.JACOBI, PreconditionerType.SCHUR_JACOBI,
                PreconditionerType.DIAGONAL):
            raise ValueError(
                f"preconditioner {opts.preconditioner_type} not "
                f"implemented for the SQUARE_ROOT solver")
        N = self.num_cameras
        mode = opts.sqrt_rcs_mode
        if mode == "auto":
            if self.precond_jacobi:
                mode = "implicit"
            elif 0 < N <= opts.dense_rcs_max_cameras:
                mode = "dense"
            else:
                mode = "bsr"
        if mode not in ("dense", "implicit", "bsr"):
            raise ValueError(f"unknown sqrt_rcs_mode {mode!r}")
        self.explicit_rcs = mode == "dense"
        self.bsr_rcs = mode == "bsr"
        # whole-loop CG kernel K3, gated as in the JAX package: float32,
        # dense mode, and the padded system within 12 MB (N <= 128) or
        # forced with pallas_cg='on' (the option keeps its name)
        Nc = -(-N // 128) * 128
        small = (9 * Nc) * (9 * Nc) * 4 <= (12 << 20)
        self.use_cg_kernel = (self.explicit_rcs and opts.pallas_cg != "off"
                              and self.dtype == torch.float32
                              and (small or opts.pallas_cg == "on"))
        self.pairs = None
        self.pair_slots = 0
        self.cam_stream = None
        self.bsr = None
        self.bsr_sym = False
        if self.explicit_rcs or self.bsr_rcs:
            from rootba_tpu_torch.bal.bucketing import build_bsr_matvec

            # BSR mode builds no [G*G] dense block maps (at 3,068 cameras
            # each would hold 9.4M entries)
            self.pairs, self.cam_stream, pairs_host = build_pair_index(
                self.bp.buckets, N, opts.pair_gather, self.device,
                grid_n=Nc if self.use_cg_kernel else None,
                dense_grid=self.explicit_rcs)
            self.pair_slots = pair_slots(self.pairs)
            if self.bsr_rcs:
                # the stream reducers take every per-camera sum of BSR
                # mode, so the camera CSR is never built (as in the JAX
                # package)
                if self.cam_stream is not None:
                    self.cam_csr = None
                with trace.span("prep.build.bsr_matvec"):
                    self.bsr = BsrMatvecIndex.from_host(
                        build_bsr_matvec(pairs_host.pair_row,
                                         pairs_host.pair_col, N),
                        self.device)
                # the half table when the packed one would exceed the
                # budget
                self.bsr_sym = bsr_symmetric_fits(
                    self.bsr, self.dtype.itemsize,
                    int(opts.bsr_pack_max_gb * (1 << 30)))

    @property
    def stage_csr(self) -> Optional[CamCsrIndex]:
        """The camera CSR of the per-camera sums that the camera stream
        does not take (built on first use)."""
        return None if self.cam_stream is not None else self.cam_csr

    def error(self, cams, lm_ps):
        from rootba_tpu_torch.solver.linearization import (
            compute_error_buckets,
        )

        return compute_error_buckets(cams, lm_ps, self.buckets,
                                     self.robust_norm, self.huber)

    def stage1(self, cams, lm_ps):
        return flat_linearize(
            cams, lm_ps, self.buckets, self.robust_norm, self.huber,
            self.options.use_projection_validity_check(), self.jacobi_eps,
            self.options.jacobi_scaling, self.num_cameras,
            cam_stream=self.cam_stream, csr=self.stage_csr)

    def stage2(self, lins: FlatLin, lam: torch.Tensor):
        N = self.num_cameras
        if not (self.explicit_rcs or self.bsr_rcs):
            return flat_stage2(lins, self.buckets, lam, N,
                               precond_jacobi=self.precond_jacobi,
                               precond_diagonal=self.precond_diag,
                               csr=self.cam_csr), None
        # explicit RCS: assemble H once, then CG is dense GEMVs (or the
        # K3 kernel) or block-sparse products; SCHUR_JACOBI blocks are
        # H's diagonal (free), forced-JACOBI keeps stage2's own Jp'Jp
        # block pass
        csr = self.stage_csr
        stage2 = flat_stage2(lins, self.buckets, lam, N,
                             precond_jacobi=self.precond_jacobi,
                             with_precond=self.precond_jacobi,
                             cam_stream=self.cam_stream, csr=csr)
        # the assembly's device time (read after the attempt's sync)
        # and the pair slots it folds, for the benchmark's stage2 metrics
        with trace.timer("rcs.assemble", self.device):
            if self.bsr_rcs:
                # always the strict-pair half table (scaled and negated
                # in place), expanded here to the packed table when it
                # fits, so the [2P, 81] form never exists. The index
                # goes in as an argument: eager PyTorch traces nothing,
                # so no index is captured as a program constant (the
                # JAX package's stage2 captures it in a closure,
                # sqrt_flat.py:904 there).
                half, diag = flat_assemble_rcs_bsr(
                    lins, stage2, self.pairs, N, self.buckets,
                    self.cam_stream, symmetric=True, csr=csr)
                H = bsr_build_table(half, self.bsr, self.bsr_sym)
            else:
                H, diag = flat_assemble_rcs(lins, stage2, self.pairs, N,
                                            self.buckets, self.cam_stream,
                                            csr=csr)
        trace.count("rcs.pair_slots", self.pair_slots)
        if not self.precond_jacobi:
            if self.precond_diag:
                diag = diag * torch.eye(P9, dtype=diag.dtype,
                                        device=diag.device)
            stage2 = stage2._replace(precond_chol=chol9(diag))
        return stage2, ((H, diag) if self.bsr_rcs else H)

    def lsolve(self, lins: FlatLin, aux):
        opts = self.options
        stage2, H = aux
        if self.use_cg_kernel:
            from rootba_tpu_torch.ops.cg_dense import pcg_dense

            res = pcg_dense(
                H, stage2.precond_chol, stage2.b,
                min_num_iterations=opts.min_linear_solver_iterations,
                max_num_iterations=opts.max_linear_solver_iterations,
                q_tolerance=float(opts.eta), r_tolerance=-1.0)
        else:
            if self.bsr_rcs:
                table, diag = H
                matvec = bsr_table_matvec(table, diag, self.bsr,
                                          self.bsr_sym)
            elif self.explicit_rcs:
                def matvec(x):
                    return sc_matvec_dense(H, x)
            else:
                csr = self.cam_csr

                def matvec(x):
                    return flat_matvec(lins, stage2, self.buckets,
                                       self.num_cameras, x, csr=csr)
            # explicit per-block inverse once per solve (ops/block9)
            pinv = chol9_inv(stage2.precond_chol)
            res = pcg(matvec, lambda r: inv9_apply(pinv, r), stage2.b,
                      min_num_iterations=opts.min_linear_solver_iterations,
                      max_num_iterations=opts.max_linear_solver_iterations,
                      q_tolerance=opts.eta, r_tolerance=-1.0,
                      compensated=self.compensated)
        # we solve H(-x) = b -> negate (linearizor_base.cpp:99-101)
        return -res.x, stage2, res.num_iterations, res.termination_type

    def apply(self, cams: CamState, lm_ps, lins: FlatLin,
              stage2: FlatStage2, pose_scale, inc):
        new_lm_ps, l_diff = flat_back_substitute(
            lins, stage2, self.buckets, lm_ps, inc,
            compensated=self.compensated)
        inc_scaled = inc * pose_scale
        q, t = lie.apply_inc_pose(cams.q, cams.t, inc_scaled[:, :6])
        intr = cams.intr + inc_scaled[:, 6:9]
        return CamState(q=q, t=t, intr=intr), new_lm_ps, l_diff
