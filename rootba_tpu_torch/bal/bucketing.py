"""Obs-count bucketing and the stream indices of the explicit RCS.

Host-side (numpy) copy of the JAX package's bucketing, trimmed to what
the port uses: `bucketize`, the camera CSR index of the per-camera
gather-reduce (`CamCsr`, built on first use), the indices of the
explicit reduced camera system's pair and camera gathers -- PairStream /
CamStream ("stream", with the fixed-order reduction of their runs,
`RunTree`) and PairCsr ("obs") -- the BsrMatvec index of its
block-sparse operator, and `scatter_landmarks`. Landmarks are grouped by
observation count into a small set of buckets; each bucket is a
struct-of-arrays batch with a static per-landmark obs count (padded
slots masked).

Exact buckets for nobs < bucket_pow2_from (default 9, mirroring the
reference's static specializations), power-of-two padded buckets above.
"""

from __future__ import annotations

import os
from typing import List, NamedTuple, Tuple

import numpy as np

from rootba_tpu_torch.bal.problem import BalProblem

class Bucket(NamedTuple):
    """Static per-bucket data (index part; landmark positions live in
    the solver state so they can be updated functionally)."""

    n_obs: int  # padded obs slots per landmark (static)
    num_real: int  # number of real landmarks (before row padding)
    obs_uv: np.ndarray  # [L, n, 2]
    cam_idx: np.ndarray  # [L, n] int32 (padded slots point at camera 0)
    mask: np.ndarray  # [L, n] bool, False = padded obs slot
    lm_mask: np.ndarray  # [L] bool, False = padded landmark row
    lm_id: np.ndarray  # [L] int32, original landmark index (-1 padded)


class CamCsr(NamedTuple):
    """Camera-major view of the flat obs axis (concatenation of every
    bucket's [L*n] slots, in bucket order).

    Per-camera accumulations (the reference's mutex scatters,
    linearization_qr.hpp:406-429) become a static gather + a reduction
    in a fixed order: each camera's observation slots are listed in
    fixed-width "virtual rows" of `width` slots (a camera with many obs
    gets several rows; rows are sorted by camera; padding points at the
    dump slot = total_slots). A per-camera reduction is then
    sum(gather(contrib)[R, width], axis=1), and the second level maps
    each camera to its virtual rows with the same fixed-width trick (pad
    entries point at the dump row R). No scatter-add anywhere, so the
    sums repeat bit for bit on the card.

    The JAX package's CamCsr also carries the inverse maps of its
    camera-major solver layout (row_cam, lm2cs, cs_lm); that layout is
    not ported, so neither are they."""

    idx: np.ndarray  # [R, width] int32 flat-slot positions (pad=dump)
    idx2: np.ndarray  # [N, vmax] int32 virtual-row ids (pad=R)
    total_slots: int  # dump index == sum of L*n over buckets


class BucketedProblem(NamedTuple):
    num_cameras: int
    num_landmarks: int  # real landmarks across all buckets
    num_observations: int  # real observations
    buckets: Tuple[Bucket, ...]
    lm_p0: Tuple[np.ndarray, ...]  # initial [L,3] per bucket (f64)
    cam_q0: np.ndarray  # [N,4] f64
    cam_t0: np.ndarray
    cam_intr0: np.ndarray
    cam_csr: "_LazyCamCsr"  # built on first access


def _bucket_sizes_vec(counts: np.ndarray, pow2_from: int) -> np.ndarray:
    """Per-landmark bucket width, vectorized: exact below pow2_from,
    the next power of two above."""
    c = np.maximum(counts.astype(np.int64), 1)
    pow2 = np.int64(1) << np.ceil(np.log2(c)).astype(np.int64)
    return np.where(c < pow2_from, c, pow2)


def bucketize(
    problem: BalProblem,
    pow2_from: int = 9,
    row_align: int = 8,
    max_bucket_obs: int = 4_000_000,
    max_bucket_rows: int = 0,
) -> BucketedProblem:
    """Group landmarks into obs-count buckets with padded SoA tensors.

    row_align pads each bucket's landmark count to a multiple (keeps
    sharding/retiling friendly; padded landmark rows are fully masked).

    max_bucket_obs splits an obs-count class into several buckets of at
    most that many obs slots each (0 disables); max_bucket_rows caps
    the landmark rows per bucket (0 = off). Both keep the bucket
    layout identical to the JAX package's, so a run of either package
    sees the same buckets."""
    counts = problem.obs_per_landmark()
    if counts.min(initial=2) < 2:
        raise ValueError("landmarks must have >= 2 observations; "
                         "run filter_obs first")
    sizes = _bucket_sizes_vec(counts, pow2_from)

    # merge undersized buckets into the next larger one: a bucket with a
    # handful of landmarks costs a full extra compiled program section
    # for negligible work (the reference's analog is the single dynamic
    # landmark block class for all nobs > 8, landmark_block.cpp:48-83)
    min_rows = min(256, max(1, counts.size // 16))
    uniq = np.sort(np.unique(sizes))
    for i, n in enumerate(uniq[:-1]):
        if np.sum(sizes == n) < min_rows:
            nxt = uniq[uniq > n][0]
            sizes[sizes == n] = nxt
    # undersized largest bucket: nothing above to merge into; keep it
    obs_start = np.concatenate([[0], np.cumsum(counts)])

    # camera-locality ordering inside each bucket: landmarks sorted by
    # their minimum camera id, so a contiguous landmark range covers
    # few cameras -> few distinct camera pairs per PairStream
    # sub-stream (dense width-runs) and local scatter/gather patterns
    # everywhere else. Pure reordering; the math is permutation-
    # invariant (f32 sums reassociate within test tolerances).
    min_cam = np.minimum.reduceat(
        problem.obs_cam, obs_start[:-1]) if counts.size else \
        np.zeros(0, np.int64)

    buckets: List[Bucket] = []
    lm_p0: List[np.ndarray] = []
    groups: List[Tuple[int, np.ndarray]] = []
    for n in sorted(set(sizes.tolist())):
        ids = np.nonzero(sizes == n)[0]
        ids = ids[np.argsort(min_cam[ids], kind="stable")]
        per = ids.size
        if max_bucket_obs and ids.size * n > max_bucket_obs:
            per = max_bucket_obs // int(n)
        if max_bucket_rows:
            per = min(per, max_bucket_rows)
        per = max(per, row_align)
        if per < ids.size:
            for s in range(0, ids.size, per):
                groups.append((n, ids[s:s + per]))
        else:
            groups.append((n, ids))
    for n, lm_ids in groups:
        num_real = lm_ids.size
        L = -(-num_real // row_align) * row_align
        obs_uv = np.zeros((L, n, 2), dtype=np.float64)
        cam_idx = np.zeros((L, n), dtype=np.int32)
        mask = np.zeros((L, n), dtype=bool)
        lm_mask = np.zeros((L,), dtype=bool)
        lm_id = np.full((L,), -1, dtype=np.int32)
        p0 = np.zeros((L, 3), dtype=np.float64)

        lm_mask[:num_real] = True
        lm_id[:num_real] = lm_ids
        p0[:num_real] = problem.lm_p[lm_ids]
        # vectorized ragged gather: for each selected landmark, its obs
        # span [obs_start[m], obs_start[m]+counts[m]) in the (lm, cam)-
        # sorted flat obs arrays
        c_sel = counts[lm_ids].astype(np.int64)
        total = int(c_sel.sum())
        rows = np.repeat(np.arange(num_real, dtype=np.int64), c_sel)
        within = (np.arange(total, dtype=np.int64)
                  - np.repeat(np.cumsum(c_sel) - c_sel, c_sel))
        src = np.repeat(obs_start[lm_ids], c_sel) + within
        obs_uv[rows, within] = problem.obs_uv[src]
        cam_idx[rows, within] = problem.obs_cam[src]
        mask[rows, within] = True
        buckets.append(Bucket(n_obs=int(n), num_real=int(num_real),
                              obs_uv=obs_uv, cam_idx=cam_idx, mask=mask,
                              lm_mask=lm_mask, lm_id=lm_id))
        lm_p0.append(p0)

    return BucketedProblem(
        num_cameras=problem.num_cameras,
        num_landmarks=problem.num_landmarks,
        num_observations=problem.num_observations,
        buckets=tuple(buckets),
        lm_p0=tuple(lm_p0),
        cam_q0=problem.cam_q.copy(),
        cam_t0=problem.cam_t.copy(),
        cam_intr0=problem.cam_intr.copy(),
        # lazy: only the implicit SQUARE_ROOT operator and the SC/PoBA
        # stages read it, so the stream and BSR routes never pay its
        # host build
        cam_csr=_LazyCamCsr(tuple(buckets), problem.num_cameras),
    )


class _LazyCamCsr:
    """Build-on-first-access CamCsr (duck-typed: .idx/.idx2/.total_slots).
    The lock keeps concurrent first accesses from building it twice."""

    def __init__(self, buckets, num_cameras: int):
        import threading

        self._buckets = buckets
        self._n = num_cameras
        self._v: CamCsr | None = None
        self._lock = threading.Lock()

    def _get(self) -> CamCsr:
        if self._v is None:
            with self._lock:
                if self._v is None:
                    self._v = build_cam_csr(self._buckets, self._n)
        return self._v

    @property
    def idx(self):
        return self._get().idx

    @property
    def idx2(self):
        return self._get().idx2

    @property
    def total_slots(self):
        return self._get().total_slots


def build_cam_csr(buckets, num_cameras: int, width: int = 64) -> CamCsr:
    """Build the camera-major virtual-row index of all real obs slots
    (camera c's slots in flat-slot order, through _csr_rows)."""
    cam_flat = np.concatenate([b.cam_idx.reshape(-1) for b in buckets])
    mask_flat = np.concatenate([b.mask.reshape(-1) for b in buckets])
    total_slots = cam_flat.size
    pos = np.nonzero(mask_flat)[0].astype(np.int64)
    cams = cam_flat[pos].astype(np.int64)
    order = np.argsort(cams, kind="stable")
    idx, idx2, _ = _csr_rows(pos[order], cams[order], num_cameras, width,
                             total_slots)
    return CamCsr(idx=idx.astype(np.int32), idx2=idx2.astype(np.int32),
                  total_slots=int(total_slots))


class RunTree(NamedTuple):
    """Fixed-order reduction of the runs of one sub-stream into their
    targets (pairs or cameras). The stream builders pad each target's
    sorted slots to width-aligned runs, so a target with more than W
    slots in a sub-stream owns several ADJACENT runs, and a scatter-add
    of all runs would add them in whatever order the card's atomics
    take. Instead, run rows are summed pairwise in place: pass d adds
    the run at rank r + 2^d of its target into the one at rank r, for
    every r divisible by 2^(d+1) -- within a pass every destination is
    distinct and no destination is a source -- until each target's
    first run (its head) holds the target's sum, which one add with
    distinct targets puts into the output. The same tree on every run,
    so the same bits.

    passes is empty when no target has a second run; the caller then
    adds the run rows straight into their targets (pad runs, which
    target the dump row, may collide there: it is dropped)."""

    passes: Tuple[Tuple[np.ndarray, np.ndarray], ...]  # (dst, src) runs
    head: np.ndarray  # [U] run ids of the heads (real targets only)


def build_run_tree(target: np.ndarray, dump: int) -> RunTree:
    """RunTree of one sub-stream's run targets ([R], runs of one target
    adjacent, pad runs = dump). Only targets with several runs enter the
    passes, so the host work follows those runs, not R."""
    t = np.asarray(target, np.int64)
    R = t.size
    starts = np.flatnonzero(np.concatenate([[True], t[1:] != t[:-1]])) \
        if R else np.zeros(0, np.int64)
    counts = np.diff(np.append(starts, R))
    real = t[starts] != dump
    head = starts[real]
    multi = real & (counts > 1)
    ms, mc = starts[multi], counts[multi]
    passes = []
    step = 1
    while mc.size and int(mc.max()) > step:
        sel = mc > step
        s_, c_ = ms[sel], mc[sel]
        # ranks r = 2 k step with r + step < count, per segment
        n = (c_ - step + 2 * step - 1) // (2 * step)
        k = np.arange(int(n.sum()), dtype=np.int64) - np.repeat(
            np.cumsum(n) - n, n)
        dst = np.repeat(s_, n) + 2 * step * k
        passes.append((dst, dst + step))
        step *= 2
    return RunTree(passes=tuple(passes), head=head)


def _pad_runs(code_sorted, width, *cols):
    """Pad pair-sorted per-slot columns to width-aligned per-pair runs.
    Returns (padded columns..., run pair-codes) with pad slots left at
    the fill values pre-set in `fill`."""
    if code_sorted.size == 0:
        # fully-padded sub-stream (e.g. a trailing landmark range of
        # row padding): no slots, no runs
        return ([np.zeros(0, col.dtype) for col, _ in cols],
                np.zeros(0, code_sorted.dtype))
    u, counts = np.unique(code_sorted, return_counts=True)
    padded = (counts + width - 1) // width * width
    total = int(padded.sum())
    starts = np.concatenate([[0], np.cumsum(padded)[:-1]])
    src_starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    within = (np.arange(code_sorted.size, dtype=np.int64)
              - np.repeat(src_starts, counts))
    dst = np.repeat(starts, counts) + within
    outs = []
    for col, fill in cols:
        out = np.full(total, fill, dtype=col.dtype)
        out[dst] = col
        outs.append(out)
    return outs, np.repeat(u, padded // width)


def _csr_rows(pos: np.ndarray, seg: np.ndarray, num_segments: int,
              width: int, dump: int):
    """Shared virtual-row packing: scatter sorted positions `pos`
    (segment ids `seg`, already sorted by segment) into fixed-width
    rows grouped by segment. Returns (idx [R,width], idx2 [S,vmax],
    rows_per_segment)."""
    counts = np.bincount(seg, minlength=num_segments).astype(np.int64)
    rows_per_seg = -(-counts // width)
    R = max(int(rows_per_seg.sum()), 1)
    idx = np.full((R, width), dump, dtype=np.int64)
    row_starts = np.zeros(num_segments + 1, dtype=np.int64)
    row_starts[1:] = np.cumsum(rows_per_seg)
    within = (np.arange(pos.size, dtype=np.int64)
              - np.repeat(np.cumsum(counts) - counts, counts))
    row = np.repeat(row_starts[:-1], counts) + within // width
    col = within % width
    idx[row, col] = pos
    vmax = max(int(rows_per_seg.max(initial=1)), 1)
    idx2 = np.full((num_segments, vmax), R, dtype=np.int64)
    rr = np.repeat(np.arange(num_segments, dtype=np.int64), rows_per_seg)
    cc = (np.arange(rr.size, dtype=np.int64)
          - np.repeat(np.cumsum(rows_per_seg) - rows_per_seg,
                      rows_per_seg))
    idx2[rr, cc] = np.arange(rr.size, dtype=np.int64)
    return idx, idx2, rows_per_seg


class PairCsr(NamedTuple):
    """Camera-pair-major index of all strict observation pairs (i < j
    within one landmark), canonicalized so the first element's camera
    <= the second's: the "obs" pair gather.

    Each slot of the fixed-width virtual rows stores the FLAT obs
    indices (into the [O] obs axis) of the pair's two observations; the
    consumer gathers both sides' per-obs factor rows, folds each run of
    slots into one 9x9 block product (kernel K1) and sums each unique
    camera pair's runs through idx2 (the two-level scheme of CamCsr).
    Only the upper camera triangle is assembled; the densify mirrors
    the transpose. Diagonal (i == i) contributions reduce per camera
    (CamCsr). Replaces the reference's num_cams^2 mutex array for RCS
    assembly (sc/linearization_sc.hpp:92-95, :327-348).
    """

    wi_idx: np.ndarray  # [R, width] int32 flat obs index of side 1 (pad=O)
    wj_idx: np.ndarray  # [R, width] int32 flat obs index of side 2 (pad=O)
    idx2: np.ndarray  # [P, vmax] int32 virtual-row ids (pad=R)
    pair_row: np.ndarray  # [P] int32 camera row (<= col) of each pair
    pair_col: np.ndarray  # [P] int32 camera col
    up_idx: np.ndarray  # [N*N] int32 dense block (r,c) -> pair id of
    #                     (r,c) if r <= c else P
    lo_idx: np.ndarray  # [N*N] int32 dense block (r,c) -> pair id of
    #                     (c,r) if c <= r else P (transposed mirror)
    num_obs_slots: int  # dump obs index == sum of L*n over buckets


def build_pair_csr(buckets, num_cameras: int, width: int = 64,
                   grid_n: int | None = None,
                   dense_grid: bool = True) -> PairCsr:
    """Build the canonicalized strict-pair index (see PairCsr).

    grid_n > num_cameras lays the dense block tables out on a padded
    [grid_n, grid_n] camera grid (padded blocks stay zero) -- used by
    the VMEM-resident CG kernel, which wants the camera axis padded to
    a lane multiple.

    dense_grid=False skips the [G*G] up_idx/lo_idx block maps (the
    block-sparse RCS mode never densifies; at final-13682's 13682
    cameras each map would be 750 MB)."""
    N = num_cameras
    G = grid_n if grid_n is not None else N
    wi_list, wj_list, code_list = [], [], []
    off = 0
    for b in buckets:
        L, n = b.cam_idx.shape
        iu, ju = np.triu_indices(n, k=1)
        if iu.size:
            # flat obs index of slot (l, k) is off + l*n + k
            base = off + np.arange(L, dtype=np.int64)[:, None] * n
            oi = (base + iu[None, :]).reshape(-1)
            oj = (base + ju[None, :]).reshape(-1)
            ci = b.cam_idx[:, iu].astype(np.int64).reshape(-1)
            cj = b.cam_idx[:, ju].astype(np.int64).reshape(-1)
            valid = (b.mask[:, iu] & b.mask[:, ju]).reshape(-1)
            # canonical order: first side's camera <= second side's
            swap = ci > cj
            oi2 = np.where(swap, oj, oi)
            oj2 = np.where(swap, oi, oj)
            a = np.where(swap, cj, ci)
            c = np.where(swap, ci, cj)
            wi_list.append(oi2[valid])
            wj_list.append(oj2[valid])
            code_list.append((a * N + c)[valid])
        off += L * n
    num_obs_slots = off
    if code_list:
        wi = np.concatenate(wi_list)
        wj = np.concatenate(wj_list)
        codes = np.concatenate(code_list)
    else:
        wi = wj = np.zeros(0, np.int64)
        codes = np.zeros(0, np.int64)

    unique, seg = np.unique(codes, return_inverse=True)
    P = unique.size
    order = np.argsort(seg, kind="stable")
    wi, wj, seg = wi[order], wj[order], seg[order]

    # pack (wi, wj) into the fixed-width virtual-row grid grouped by
    # unique pair; padded slots point both sides at the dump obs row O
    pos_rows, idx2, _ = _csr_rows(
        np.arange(wi.size, dtype=np.int64), seg, P, width, wi.size)
    wi_ext = np.concatenate([wi, [num_obs_slots]])
    wj_ext = np.concatenate([wj, [num_obs_slots]])
    wi_idx = wi_ext[np.minimum(pos_rows, wi.size)]
    wj_idx = wj_ext[np.minimum(pos_rows, wj.size)]

    rows = (unique // N).astype(np.int64)
    cols = (unique % N).astype(np.int64)
    if dense_grid:
        up_idx = np.full(G * G, P, dtype=np.int64)
        up_idx[rows * G + cols] = np.arange(P, dtype=np.int64)
        lo_idx = np.full(G * G, P, dtype=np.int64)
        lo_idx[cols * G + rows] = np.arange(P, dtype=np.int64)
    else:
        up_idx = lo_idx = np.zeros(0, dtype=np.int64)

    return PairCsr(
        wi_idx=wi_idx.astype(np.int32), wj_idx=wj_idx.astype(np.int32),
        idx2=idx2.astype(np.int32),
        pair_row=rows.astype(np.int32), pair_col=cols.astype(np.int32),
        up_idx=up_idx.astype(np.int32), lo_idx=lo_idx.astype(np.int32),
        num_obs_slots=int(num_obs_slots),
    )


class BsrMatvec(NamedTuple):
    """Camera-major index for the block-sparse RCS matvec.

    The dense z-space GEMV needs the [9N, 9N] matrix on the device,
    which grows with the square of the camera count; BAL problems'
    camera-pair graphs are sparse at large counts, so above
    dense_rcs_max_cameras the CG operator is applied block-sparsely:
    each unique strict pair (i, j) contributes H_ij x_j to y_i AND
    H_ij' x_i to y_j. Both directions are laid out as one camera-major
    entry list (2P entries), packed into fixed-width runs: per entry,
    the [81] block row of the [2P, 81] table [H_up; H_up'] times the
    [9] x row of the source camera, summed over runs, then over each
    camera's runs through idx2. No scatter anywhere; the transpose is a
    static column permutation applied once per stage2, not per CG
    iteration.
    """

    blk_idx: np.ndarray  # [R, width] int32 row into the [2P,81] block
    #   table: pair id p for (row=pair_row[p]), P + p for the
    #   transposed direction (row=pair_col[p]); pad = 2P (reads zeros)
    col_idx: np.ndarray  # [R, width] int32 source camera of x (pad = N)
    idx2: np.ndarray  # [N, vmax] int32 run-row ids (pad = R)


def build_bsr_matvec(pair_row: np.ndarray, pair_col: np.ndarray,
                     num_cameras: int, width: int = 0) -> BsrMatvec:
    """Build the block-sparse matvec index from the strict-pair list
    (pair_row[p] < pair_col[p], as build_pair_stream produces it).

    width=0 picks the run width adaptively: every padded slot costs a
    row of the packed block table per matvec
    (solver.linearization.bsr_matvec_packed), so the width minimizing
    the total of padded slots wins."""
    P = pair_row.size
    N = num_cameras
    rows = np.concatenate([pair_row.astype(np.int64),
                           pair_col.astype(np.int64)])
    cols = np.concatenate([pair_col.astype(np.int64),
                           pair_row.astype(np.int64)])
    if width <= 0:
        counts = np.bincount(rows, minlength=N)
        best = None
        width = 64
        for w in (8, 16, 32, 64):
            padded = int(np.sum(-(-counts // w) * w))
            if best is None or padded < best:
                best, width = padded, w
    blks = np.concatenate([np.arange(P, dtype=np.int64),
                           P + np.arange(P, dtype=np.int64)])
    order = np.argsort(rows, kind="stable")
    rows, cols, blks = rows[order], cols[order], blks[order]
    pos_rows, idx2, _ = _csr_rows(
        np.arange(rows.size, dtype=np.int64), rows, N, width, rows.size)
    blks_ext = np.concatenate([blks, [2 * P]])
    cols_ext = np.concatenate([cols, [N]])
    sel = np.minimum(pos_rows, rows.size)
    return BsrMatvec(
        blk_idx=blks_ext[sel].astype(np.int32),
        col_idx=cols_ext[sel].astype(np.int32),
        idx2=idx2.astype(np.int32))


def scatter_landmarks(
    bp: BucketedProblem, lm_p_buckets
) -> np.ndarray:
    """Gather per-bucket landmark positions back into problem order."""
    out = np.zeros((bp.num_landmarks, 3), dtype=np.float64)
    for bucket, p in zip(bp.buckets, lm_p_buckets):
        ids = bucket.lm_id[bucket.lm_mask]
        out[ids] = np.asarray(p, dtype=np.float64)[bucket.lm_mask]
    return out


class PairStream(NamedTuple):
    """Source-locality-tiled strict-pair index of the explicit RCS.

    Every strict pair slot (l, i, j) of a landmark's observations is
    one per-observation gather from a bounded sub-table:

      * landmarks are sorted by min-camera inside each bucket
        (bucketize) so a contiguous landmark range covers few cameras
        -> few distinct pairs -> dense width-runs;
      * each bucket is tiled into uniform sub-streams of <= slot_cap
        slots; the device reducer takes the bucket's [L, n*K9] rows
        [start, start + rows_sub) as the [rows_sub*n, K9] slot table and
        gathers slots from that;
      * slots are pair-sorted within the sub-stream and padded to
        width-aligned single-pair runs; run sums land in a global
        [P+1, 81] table by one scatter-add per sub-stream.

    The layout is the JAX package's, index for index.
    """

    pair_row: np.ndarray  # [P] int32 (<= pair_col)
    pair_col: np.ndarray  # [P] int32
    widths: Tuple[int, ...]  # run width per stack (adaptive: wide
    #   buckets have few slots per (pair, stream), so a fixed W=16
    #   pads 5-7x at final scale; chosen per bucket to minimize
    #   padded-gather + run-scatter cost)
    stream_bucket: Tuple[int, ...]  # bucket id per stack
    rows_sub: Tuple[int, ...]  # landmark rows per sub-stream, per stack
    wi_idx: Tuple[np.ndarray, ...]  # per stack [S, R, W] int32 local
    #   slot ids into [rows_sub*n] (pad = rows_sub*n), canonical side 1
    wj_idx: Tuple[np.ndarray, ...]  # [S, R, W] side 2
    run_pair: Tuple[np.ndarray, ...]  # per stack [S, R] int32 pair id
    #   of each run (pad = P)
    run_tree: Tuple[Tuple[RunTree, ...], ...]  # per stack, per
    #   sub-stream: the fixed-order reduction of its runs (port only)
    up_idx: np.ndarray  # [G*G] int32 dense block (r,c) -> pair id of
    #   (r,c) if r <= c else P; empty if not dense
    lo_idx: np.ndarray  # [G*G] int32 -> pair id of (c,r) if c <= r
    #   else P (the transposed mirror)


def _stream_tiles(L: int, n: int, slot_cap: int,
                  npairs_hint: int) -> int:
    """Landmark rows per sub-stream: bound the [rows_sub*n, K9] slot
    table to the fast gather regime AND the per-stream pair-slot count
    (rows_sub * npairs) to a workable sort/pad size."""
    rows = max(1, slot_cap // max(n, 1))
    if npairs_hint > 0:
        rows = max(1, min(rows, 4_000_000 // npairs_hint))
    return rows


# pair-slot count above which the stream index shrinks its sub-tables
# to u16 indexing (module global so tests can force it at toy size)
_U16_SLOT_THRESHOLD = 80_000_000


def build_pair_stream(buckets, num_cameras: int, width: int = 16,
                      grid_n: int | None = None,
                      dense_grid: bool = True,
                      slot_cap: int = 196_608) -> PairStream:
    """Build the PairStream index (vectorized; no per-pattern loops)."""
    N = num_cameras
    G = grid_n if grid_n is not None else N

    # pass 1: global unique pair codes (per-bucket uniques merged)
    uniques = []
    total_slots = 0
    for b in buckets:
        L, n = b.cam_idx.shape
        if L == 0 or n < 2:
            continue
        iu, ju = np.triu_indices(n, k=1)
        ci = b.cam_idx[:, iu].astype(np.int64)
        cj = b.cam_idx[:, ju].astype(np.int64)
        valid = b.mask[:, iu] & b.mask[:, ju]
        total_slots += int(valid.sum())
        code = np.minimum(ci, cj) * N + np.maximum(ci, cj)
        uniques.append(np.unique(code[valid]))
    unique = (np.unique(np.concatenate(uniques)) if uniques
              else np.zeros(0, np.int64))
    P = unique.size

    # giant pair graphs: shrink the sub-tables so every slot index
    # fits u16 (halves the [S, R, W] wi/wj tables). The fill sentinel
    # rows_sub*n must itself fit, hence the cap at 65535 rows. The
    # device copy widens them at upload.
    idx_dtype = np.int32
    if total_slots > _U16_SLOT_THRESHOLD and slot_cap > 65_535:
        slot_cap = 65_535
        idx_dtype = np.uint16

    stream_bucket = []
    rows_sub_list = []
    widths_list = []
    wi_stacks = []
    wj_stacks = []
    rp_stacks = []
    rt_stacks = []
    for bi, b in enumerate(buckets):
        L, n = b.cam_idx.shape
        if L == 0 or n < 2:
            continue
        iu, ju = np.triu_indices(n, k=1)
        npairs = iu.size
        rows_sub = _stream_tiles(L, n, slot_cap, npairs)
        S = -(-L // rows_sub)

        def one_stream(s, b=b, n=n, iu=iu, ju=ju, npairs=npairs,
                       rows_sub=rows_sub, L=L):
            l0 = s * rows_sub
            l1 = min(L, l0 + rows_sub)
            ci = b.cam_idx[l0:l1, iu].astype(np.int64)
            cj = b.cam_idx[l0:l1, ju].astype(np.int64)
            valid = (b.mask[l0:l1, iu] & b.mask[l0:l1, ju]).ravel()
            code = (np.minimum(ci, cj) * N
                    + np.maximum(ci, cj)).ravel()[valid]
            swap = (ci > cj).ravel()[valid]
            lrel = np.repeat(
                np.arange(l1 - l0, dtype=np.int64), npairs)[valid]
            oi = lrel * n + np.tile(iu, l1 - l0)[valid]
            oj = lrel * n + np.tile(ju, l1 - l0)[valid]
            wi = np.where(swap, oj, oi)
            wj = np.where(swap, oi, oj)
            order = np.argsort(code, kind="stable")
            pid = np.searchsorted(unique, code[order])
            return pid, wi[order], wj[order]

        # per-sub-stream work is embarrassingly parallel and numpy's
        # sorts release the GIL
        from concurrent.futures import ThreadPoolExecutor

        if S > 1:
            with ThreadPoolExecutor(
                    max_workers=min(16, os.cpu_count() or 1)) as pool:
                sorted_streams = list(pool.map(one_stream, range(S)))
        else:
            sorted_streams = [one_stream(0)]

        # adaptive run width: wide buckets have few slots per
        # (pair, stream), so a fixed W=16 pads heavily. Choose the W
        # minimizing gathered-slot + run-scatter cost over the realized
        # per-(pair, stream) slot counts. The weights are the JAX
        # package's cost model, kept as they are so that both packages
        # build the same index (and so take the same path).
        counts_all = []
        for pid, _, _ in sorted_streams:
            if pid.size:
                counts_all.append(np.unique(pid, return_counts=True)[1])
        counts_all = (np.concatenate(counts_all) if counts_all
                      else np.zeros(0, np.int64))
        best_w, best_cost = width, None
        for w in (16, 8, 4, 2):
            runs = int(np.sum(-(-counts_all // w)))
            cost = runs * w * 2 + runs * 10
            if best_cost is None or cost < best_cost:
                best_cost, best_w = cost, w
        bw = best_w

        fill = rows_sub * n
        wi_runs, wj_runs, rp_runs = [], [], []
        for pid, wi_s, wj_s in sorted_streams:
            (wi_p, wj_p), rp = _pad_runs(
                pid, bw, (wi_s, fill), (wj_s, fill))
            wi_runs.append(wi_p.reshape(-1, bw))
            wj_runs.append(wj_p.reshape(-1, bw))
            rp_runs.append(rp)
        R = max([r.shape[0] for r in wi_runs] + [1])
        wi_st = np.full((S, R, bw), fill, idx_dtype)
        wj_st = np.full((S, R, bw), fill, idx_dtype)
        rp_st = np.full((S, R), P, np.int32)
        for s in range(S):
            r = wi_runs[s].shape[0]
            wi_st[s, :r] = wi_runs[s]
            wj_st[s, :r] = wj_runs[s]
            rp_st[s, :r] = rp_runs[s]
        rt_stacks.append(tuple(build_run_tree(rp_st[s], P)
                               for s in range(S)))
        stream_bucket.append(bi)
        rows_sub_list.append(rows_sub)
        widths_list.append(bw)
        wi_stacks.append(wi_st)
        wj_stacks.append(wj_st)
        rp_stacks.append(rp_st)

    rows = (unique // N).astype(np.int64)
    cols = (unique % N).astype(np.int64)
    if dense_grid:
        up_idx = np.full(G * G, P, dtype=np.int64)
        up_idx[rows * G + cols] = np.arange(P, dtype=np.int64)
        lo_idx = np.full(G * G, P, dtype=np.int64)
        lo_idx[cols * G + rows] = np.arange(P, dtype=np.int64)
    else:
        up_idx = lo_idx = np.zeros(0, dtype=np.int64)

    return PairStream(
        pair_row=rows.astype(np.int32), pair_col=cols.astype(np.int32),
        widths=tuple(widths_list),
        stream_bucket=tuple(stream_bucket),
        rows_sub=tuple(rows_sub_list),
        wi_idx=tuple(wi_stacks), wj_idx=tuple(wj_stacks),
        run_pair=tuple(rp_stacks), run_tree=tuple(rt_stacks),
        up_idx=up_idx.astype(np.int32), lo_idx=lo_idx.astype(np.int32))


class CamStream(NamedTuple):
    """Per-camera reduce in the PairStream formulation (self-slots,
    runs keyed by camera), in place of per-(bucket, slot column) groups
    whose whole-row gathers pay n x bandwidth on wide buckets (a
    684-wide final bucket would read its table 684 times)."""

    width: int
    num_cameras: int
    stream_bucket: Tuple[int, ...]
    rows_sub: Tuple[int, ...]
    w_idx: Tuple[np.ndarray, ...]  # per stack [S, R, W] int32 local
    #   slot ids (pad = rows_sub*n)
    run_cam: Tuple[np.ndarray, ...]  # per stack [S, R] int32 (pad = N)
    run_tree: Tuple[Tuple[RunTree, ...], ...]  # per stack, per
    #   sub-stream (see PairStream.run_tree)


def build_cam_stream(buckets, num_cameras: int, width: int = 16,
                     slot_cap: int = 196_608) -> CamStream:
    N = num_cameras
    stream_bucket = []
    rows_sub_list = []
    w_stacks = []
    rc_stacks = []
    rt_stacks = []
    for bi, b in enumerate(buckets):
        L, n = b.cam_idx.shape
        if L == 0:
            continue
        rows_sub = max(1, slot_cap // max(n, 1))
        S = -(-L // rows_sub)
        w_runs, rc_runs = [], []
        for s in range(S):
            l0 = s * rows_sub
            l1 = min(L, l0 + rows_sub)
            cam = b.cam_idx[l0:l1].astype(np.int64).ravel()
            valid = b.mask[l0:l1].ravel()
            slot = np.arange((l1 - l0) * n, dtype=np.int64)[valid]
            cam = cam[valid]
            order = np.argsort(cam, kind="stable")
            fill = rows_sub * n
            (w_p,), rc = _pad_runs(cam[order], width,
                                   (slot[order], fill))
            w_runs.append(w_p.reshape(-1, width))
            rc_runs.append(rc)
        R = max([r.shape[0] for r in w_runs] + [1])
        fill = rows_sub * n
        w_st = np.full((S, R, width), fill, np.int32)
        rc_st = np.full((S, R), N, np.int32)
        for s in range(S):
            r = w_runs[s].shape[0]
            w_st[s, :r] = w_runs[s]
            rc_st[s, :r] = rc_runs[s]
        rt_stacks.append(tuple(build_run_tree(rc_st[s], N)
                               for s in range(S)))
        stream_bucket.append(bi)
        rows_sub_list.append(rows_sub)
        w_stacks.append(w_st)
        rc_stacks.append(rc_st)
    return CamStream(
        width=width,
        num_cameras=N,
        stream_bucket=tuple(stream_bucket),
        rows_sub=tuple(rows_sub_list),
        w_idx=tuple(w_stacks), run_cam=tuple(rc_stacks),
        run_tree=tuple(rt_stacks))
