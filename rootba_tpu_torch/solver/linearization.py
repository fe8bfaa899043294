"""Device-side structures and reducers of the flat SQUARE_ROOT path and
of the SC/PoBA solvers.

Port of the parts of the JAX package's `solver/linearization.py` that
the ported paths run: the camera state and bucket index, row chunking,
the packed camera table, the cost evaluation, the camera-CSR
gather-reduce (`CamCsrIndex`, `csr_cam_reduce`), the indices of the
three pair gathers with their reducers (pair products, per-camera grams
and sums) feeding the dense reduced camera system
(`assemble_rcs_dense`): "stream" (`PairStreamIndex`, `CamStreamIndex`),
"strips" (`PairStripsIndex`, `CamStripsIndex`, `csr_pair_outer_strips`,
`cam_gram_strips`, `cam_reduce_strips`, and the W-free sandwich
`sqrt_ww_pair_strips` / `sqrt_ww_diag_strips`) and "obs"
(`PairCsrIndex`, `csr_pair_outer`, the camera CSR through
`_SelfPairView`), one builder choosing among them (`build_pair_index`);
the fused-W factors the stream reducers take above the W-table budget
(`StreamFactors`),
the block-sparse form of that system with its CG operators
(`BsrMatvecIndex`, `assemble_rcs_bsr`, `bsr_build_table`,
`bsr_table_matvec`), and the bucket-layout linearization of the SC/PoBA
solvers (`LinBucket`, `linearize_bucket`, `scale_jl_cols`, `jp_diag2`,
`jp_t_jp_blockdiag`, `scale_jp_cols`).

Every per-camera and per-pair sum adds in a fixed order, so it repeats
bit for bit on the card: the CSR, strips and obs reducers and the BSR
operator gather and sum; the stream reducers reduce each sub-stream's
runs of one target through a fixed tree (`RunTreeIndex`,
bal.bucketing.RunTree) before their one scatter-add with distinct
targets; `segment_sum`, where the JAX package keeps its segment sum
(the preconditioner blocks of the implicit SQUARE_ROOT mode and of the
einsum layout, reduction_alg=0, SC's scatter assembly, the Jp gram of
the power-series paths, every per-camera sum under a mesh), sums fixed
blocks of each target's rows in two levels before one sorted add.

Index tensors are uploaded once as int64. The stream indices address
slot rows of a bucket's landmark tables; their fill sentinel (the
reference gathers zeros for it with `take(..., mode="fill")`) points at
one zero row appended to the gathered table, and run ids padded to the
pair (camera) count land in an extra row of the output that is dropped.

Counterparts that collapse here: the JAX package's per-sub-stream
slicing and padding (`_stream_sub_tables`, `_pad_stack_rows`) become
one gather from the bucket's slot table (`_gather_slot_rows`) with slot
ids made global at upload. Its per-group loop of the strips reducers
(`csr_pair_outer_strips`, `_strip_run_rows`, `sqrt_ww_pair_strips`:
one landmark-row gather, two static column slices and a fold per
group) becomes one slot gather per side and bucket, chunked by
`_PAIR_CHUNK_BYTES`, with each group's slot ids, the canonical swap
applied, built on the host (`_collapse_groups`): the same run rows in
the same order, a few launches per bucket where an eager loop would
launch several per group (327,586 groups at final-3068 with
min_group=0). `_outer81_fold` / `_outer81_fold_chunked` and the obs
route's elementwise fold are `ops.fold.outer81_fold` (kernel K1; its
plain twin `fold_plain` on the CPU).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from rootba_tpu_torch.core.residuals import (
    ACC_DTYPE,
    ResidualInfo,
    ResidualItem,
    accumulate_residual_info,
    empty_residual_info,
    join_residual_info,
)
from rootba_tpu_torch.log import trace
from rootba_tpu_torch.ops import fold
from rootba_tpu_torch.parallel.mesh import all_reduce_sum

POSE_SIZE = 9


class CamState(NamedTuple):
    q: torch.Tensor  # [N,4]
    t: torch.Tensor  # [N,3]
    intr: torch.Tensor  # [N,3]


class BucketIndex(NamedTuple):
    """Static per-bucket index data (device tensors, never updated)."""

    obs_uv: torch.Tensor  # [L,n,2]
    cam_idx: torch.Tensor  # [L,n] int64
    mask: torch.Tensor  # [L,n] bool
    lm_mask: torch.Tensor  # [L] bool


# per-chunk obs-slot budget of _map_rows (the JAX package's, so both
# packages chunk alike; it bounds the transients of one chunk)
_ROW_CHUNK_SLOTS = 131_072


def _budget_rows(n: int) -> int:
    return max(8, (_ROW_CHUNK_SLOTS // max(n, 1)) // 8 * 8)


def _map_rows(f: Callable, tables: Sequence[torch.Tensor], L: int, n: int):
    """Apply f(list of [Lc, *] tables) -> tuple of [Lc, *] outputs over
    landmark-row chunks of a bucket's tables and concatenate the
    outputs (one chunk's transients live at a time)."""
    rows = _budget_rows(n)
    if L <= rows:
        return f(list(tables))
    outs = [f([t[a:a + rows] for t in tables]) for a in range(0, L, rows)]
    if isinstance(outs[0], tuple):
        return tuple(torch.cat(parts, dim=0) for parts in zip(*outs))
    return torch.cat(outs, dim=0)


# rows per block of each level of segment_sum
_SEG_BLOCK = 64


def _block_sums(data: torch.Tensor, seg: torch.Tensor, num_segments: int):
    """One level of segment_sum: the rows of each id, in their order,
    are cut into blocks of _SEG_BLOCK rows and each block is summed by
    index_put_ with accumulate (on the card it sorts the targets stably
    and adds each target's rows in turn). Returns the block sums and
    their ids in block order; blocks past the last real one are zero and
    carry the dump id num_segments, which seg may hold too."""
    n = seg.shape[0]
    dev = seg.device
    counts = torch.zeros(num_segments + 1, dtype=torch.int64,
                         device=dev).index_add_(0, seg, torch.ones_like(seg))
    order = torch.argsort(seg, stable=True)
    rank = torch.empty_like(seg)
    rank[order] = (torch.arange(n, device=dev)
                   - (torch.cumsum(counts, 0) - counts)[seg[order]])
    nblk = (counts + _SEG_BLOCK - 1) // _SEG_BLOCK
    ends = torch.cumsum(nblk, 0)
    rows = n // _SEG_BLOCK + num_segments + 2  # >= nblk.sum()
    sums = data.new_zeros((rows,) + tuple(data.shape[1:])).index_put_(
        ((ends - nblk)[seg] + rank // _SEG_BLOCK,), data, accumulate=True)
    owner = torch.searchsorted(ends, torch.arange(rows, device=dev),
                               right=True)
    return sums, torch.clamp(owner, max=num_segments)


def segment_sum(data: torch.Tensor, seg: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """out[s] = sum of data rows whose seg id is s, in a fixed order, so
    it repeats bit for bit on the card (index_add_'s atomic adds come in
    a varying order): two levels of _block_sums, then one sorted
    accumulate of the block sums. No target's rows are added one after
    another more than _SEG_BLOCK times per level, where one sorted
    accumulate of all rows would chain a camera's tens of thousands of
    rows (final-3068's twin) into one sequential sum."""
    for _ in range(2):
        data, seg = _block_sums(data, seg, num_segments)
    out = data.new_zeros((num_segments + 1,) + tuple(data.shape[1:]))
    return out.index_put_((seg,), data, accumulate=True)[:num_segments]


@dataclass(frozen=True)
class CamCsrIndex:
    """Device copy of bucketing.CamCsr (see its docstring): idx
    [R, width] flat-slot positions (pad = total_slots), idx2 [N, vmax]
    virtual-row ids (pad = R)."""

    idx: torch.Tensor
    idx2: torch.Tensor

    @staticmethod
    def from_host(csr, device) -> "CamCsrIndex":
        def up(a):
            return torch.as_tensor(np.asarray(a, np.int64), device=device)

        return CamCsrIndex(idx=up(csr.idx), idx2=up(csr.idx2))


# virtual rows per chunk of csr_cam_reduce's first level: one chunk's
# [chunk, width, F] gather lives at a time (the JAX package's budget)
_CSR_CHUNK_SLOTS = 512 << 10


def csr_cam_reduce(contribs, csr: CamCsrIndex,
                   num_cameras: int) -> torch.Tensor:
    """Per-camera sum of per-obs-slot contribution rows without a
    scatter: contribs is the per-bucket list of flat [L*n, F] rows (in
    bucket order, matching the CamCsr slot numbering); returns [N, F].
    Each virtual row's slots are gathered and summed, then each
    camera's virtual rows (_level2_reduce): a fixed order."""
    flat = torch.cat(list(contribs) + [contribs[0].new_zeros(
        (1, contribs[0].shape[1]))], dim=0)  # + the dump slot's zero row
    F = flat.shape[1]
    R, W = csr.idx.shape
    chunk = max(1, min(R, _CSR_CHUNK_SLOTS // max(W, 1)))
    rsum = flat.new_zeros((R + 1, F))  # + the dump row of idx2
    for a in range(0, R, chunk):
        ic = csr.idx[a:a + chunk]
        rsum[a:a + ic.shape[0]] = flat.index_select(
            0, ic.reshape(-1)).reshape(-1, W, F).sum(dim=1)
    return _level2_reduce(rsum, csr.idx2)


def packed_cam_table(cams: CamState) -> torch.Tensor:
    """Per-camera parameters as one [N, 16] table (q[4], t[3],
    intr[3], zero pad): one row gather per bucket."""
    pad = cams.q.new_zeros((cams.q.shape[0], 6))
    return torch.cat([cams.q, cams.t, cams.intr, pad], dim=1)


def gather_cam_planes(table: torch.Tensor, idx_flat: torch.Tensor):
    """Packed camera rows of flat obs slots -> 10 [O] planes
    (qw,qx,qy,qz, tx,ty,tz, f,k1,k2)."""
    rows = table[idx_flat]
    return tuple(rows[:, i] for i in range(10))


def _broadcast_lm(lmp_c: torch.Tensor, n: int):
    """Landmark coordinates repeated over a bucket's n slots -> three
    flat [Lc*n] planes."""
    Lc = lmp_c.shape[0]
    return tuple(lmp_c[:, k:k + 1].expand(Lc, n).reshape(-1)
                 for k in range(3))


def compute_error_buckets(cams: CamState, lm_ps: Sequence[torch.Tensor],
                          buckets: Sequence[BucketIndex], robust_norm: int,
                          huber_parameter: float,
                          mesh=None) -> ResidualInfo:
    """Whole-problem cost (reference bal_bundle_adjustment_helper.cpp
    :67-109 compute_error), row-chunked per bucket; under a mesh the
    sums over this rank's landmark rows, all-reduced."""
    from rootba_tpu_torch.ops.planar import snavely_planes

    info = empty_residual_info(cams.q.device)
    table = packed_cam_table(cams)
    for lm_p, bucket in zip(lm_ps, buckets):
        L, n = bucket.cam_idx.shape

        def err_chunk(ts, n=n):
            lmp_c, cam_c, uv_c, mask_c = ts
            X, Y, Z = _broadcast_lm(lmp_c, n)
            res_u, res_v, valid, _, _ = snavely_planes(
                *gather_cam_planes(table, cam_c.reshape(-1)), X, Y, Z,
                uv_c[..., 0].reshape(-1), uv_c[..., 1].reshape(-1),
                with_jacobians=False)
            return accumulate_residual_info(
                torch.stack([res_u, res_v], dim=-1), valid,
                mask_c.reshape(-1), robust_norm, huber_parameter)

        tables = [lm_p, bucket.cam_idx, bucket.obs_uv, bucket.mask]
        rows = _budget_rows(n)
        for a in range(0, L, rows):
            info = join_residual_info(
                info, err_chunk([t[a:a + rows] for t in tables]))
    if mesh is None:
        return info
    return _all_reduce_info(info, mesh)


def _all_reduce_info(info: ResidualInfo, mesh) -> ResidualInfo:
    """The ranks' ResidualInfo sums in one all-reduce (float64: counts
    are exact below 2**53); numerically valid on no rank's failure."""
    v = all_reduce_sum(torch.stack([
        info.all.num_obs.to(ACC_DTYPE), info.all.error,
        info.all.residual_sum, info.valid.num_obs.to(ACC_DTYPE),
        info.valid.error, info.valid.residual_sum,
        (~info.is_numerically_valid).to(ACC_DTYPE)]), mesh)

    def item(k):
        return ResidualItem(num_obs=v[k].to(torch.int64), error=v[k + 1],
                            residual_sum=v[k + 2])

    return ResidualInfo(all=item(0), valid=item(3),
                        is_numerically_valid=v[6] == 0)


# ---------------------------------------------------------------------------
# Stream indices (the pair stream built on the device by
# solver.pair_stream, whose host twin is bal.bucketing.build_pair_stream;
# the camera stream by bal.bucketing.build_cam_stream) and their reducers.


def _global_slots(local: np.ndarray, rows_sub: int, n: int,
                  L: int) -> np.ndarray:
    """[S, R, W] sub-stream-local slot ids -> slot ids of the bucket's
    whole [L*n] slot table; the fill sentinel rows_sub*n maps to L*n, the
    zero row `_slot_table` appends."""
    local = local.astype(np.int64)
    S = local.shape[0]
    start = (np.arange(S, dtype=np.int64) * rows_sub * n)[:, None, None]
    return np.where(local == rows_sub * n, L * n, local + start)


@dataclass(frozen=True)
class RunTreeIndex:
    """Device copy of bucketing.RunTree: the (dst, src) run ids of each
    pass and the head runs with their targets, int32 views of one
    uploaded index tensor (a sub-stream with a tree needs no [R] run
    targets on the card: its scatter adds the heads only)."""

    passes: Tuple[Tuple[torch.Tensor, torch.Tensor], ...]
    head: torch.Tensor
    head_target: torch.Tensor

    @staticmethod
    def from_host(tree, target, device):
        """The tree of one sub-stream whose [R] run targets are `target`,
        or None when no target has a second run (a plain scatter-add is
        then in a fixed order already)."""
        if not tree.passes:
            return None
        parts = [tree.head, np.asarray(target, np.int64)[tree.head]]
        for d, s in tree.passes:
            parts += [d, s]
        flat = torch.as_tensor(np.concatenate(parts).astype(np.int32),
                               device=device)
        views = torch.split(flat, [len(x) for x in parts])
        return RunTreeIndex(
            passes=tuple(zip(views[2::2], views[3::2])), head=views[0],
            head_target=views[1])


def _scatter_runs(out: torch.Tensor, rows: torch.Tensor,
                  target: Optional[torch.Tensor], tree) -> None:
    """out[target[r]] += rows[r] for one sub-stream's run rows, in a
    fixed order: through the run tree when a target has several runs
    (rows is reduced in place; target is None then), else one
    scatter-add with distinct targets (pads hit the dump row, which is
    dropped)."""
    if tree is None:
        out.index_add_(0, target, rows)
        return
    for dst, src in tree.passes:
        rows.index_add_(0, dst, rows.index_select(0, src))
    out.index_add_(0, tree.head_target, rows.index_select(0, tree.head))


@dataclass(frozen=True)
class PairStreamIndex:
    """Device copy of bucketing.PairStream. Per stack t: the bucket id,
    run width, landmark rows per sub-stream and, per sub-stream, the
    [R*W] slot ids of both pair sides, and either the [R] pair id of
    each run (pad = P) or, where a pair has several runs, the run tree.
    The solvers build it on their device (solver.pair_stream); from_host
    uploads the host build."""

    widths: Tuple[int, ...]
    stream_bucket: Tuple[int, ...]
    rows_sub: Tuple[int, ...]
    wi_idx: Tuple[Tuple[torch.Tensor, ...], ...]
    wj_idx: Tuple[Tuple[torch.Tensor, ...], ...]
    run_pair: Tuple[Tuple[Optional[torch.Tensor], ...], ...]
    run_tree: Tuple[Tuple[Optional[RunTreeIndex], ...], ...]
    pair_row: torch.Tensor  # [P]
    pair_col: torch.Tensor  # [P]
    up_idx: torch.Tensor  # [G*G]
    lo_idx: torch.Tensor  # [G*G]

    @property
    def num_pairs(self) -> int:
        return self.pair_row.shape[0]

    @staticmethod
    def from_host(ps, buckets, device) -> "PairStreamIndex":
        """Upload a host PairStream; `buckets` are the host buckets (for
        their [L, n] shapes). u16 tables widen here."""
        def up(a):
            return torch.as_tensor(np.asarray(a, np.int64), device=device)

        wi, wj, rp, rt = [], [], [], []
        for t, bi in enumerate(ps.stream_bucket):
            L, n = buckets[bi].cam_idx.shape
            rs = ps.rows_sub[t]
            gi = _global_slots(ps.wi_idx[t], rs, n, L)
            gj = _global_slots(ps.wj_idx[t], rs, n, L)
            wi.append(tuple(up(g.reshape(-1)) for g in gi))
            wj.append(tuple(up(g.reshape(-1)) for g in gj))
            trees = tuple(RunTreeIndex.from_host(tr, r, device)
                          for tr, r in zip(ps.run_tree[t], ps.run_pair[t]))
            rp.append(tuple(up(r) if tr is None else None
                            for tr, r in zip(trees, ps.run_pair[t])))
            rt.append(trees)
        return PairStreamIndex(
            widths=tuple(ps.widths), stream_bucket=tuple(ps.stream_bucket),
            rows_sub=tuple(ps.rows_sub), wi_idx=tuple(wi),
            wj_idx=tuple(wj), run_pair=tuple(rp), run_tree=tuple(rt),
            pair_row=up(ps.pair_row), pair_col=up(ps.pair_col),
            up_idx=up(ps.up_idx), lo_idx=up(ps.lo_idx))


@dataclass(frozen=True)
class CamStreamIndex:
    """Device copy of bucketing.CamStream: per stack, per sub-stream the
    [R*W] slot ids of each camera run, and either the [R] camera of
    each run (pad = N) or, where a camera has several runs, the run
    tree."""

    width: int
    num_cameras: int
    stream_bucket: Tuple[int, ...]
    w_idx: Tuple[Tuple[torch.Tensor, ...], ...]
    run_cam: Tuple[Tuple[Optional[torch.Tensor], ...], ...]
    run_tree: Tuple[Tuple[Optional[RunTreeIndex], ...], ...]

    @staticmethod
    def from_host(cs, buckets, device) -> "CamStreamIndex":
        def up(a):
            return torch.as_tensor(np.asarray(a, np.int64), device=device)

        w, rc, rt = [], [], []
        for t, bi in enumerate(cs.stream_bucket):
            L, n = buckets[bi].cam_idx.shape
            g = _global_slots(cs.w_idx[t], cs.rows_sub[t], n, L)
            w.append(tuple(up(x.reshape(-1)) for x in g))
            trees = tuple(RunTreeIndex.from_host(tr, r, device)
                          for tr, r in zip(cs.run_tree[t], cs.run_cam[t]))
            rc.append(tuple(up(r) if tr is None else None
                            for tr, r in zip(trees, cs.run_cam[t])))
            rt.append(trees)
        return CamStreamIndex(
            width=cs.width, num_cameras=cs.num_cameras,
            stream_bucket=tuple(cs.stream_bucket), w_idx=tuple(w),
            run_cam=tuple(rc), run_tree=tuple(rt))


class StreamFactors(NamedTuple):
    """Lazy W = Q1h x Jp factor tables for the stream reducers: the
    slot rows W27[o, c*9+a] = sum_r q[o, r*3+c] jp[o, r*9+a] are built
    after each slot gather (`_gather_slot_rows`), so that no [slots, 27]
    W table exists. Per bucket: q [L, n*6], jp [L, n*18]."""

    q: tuple
    jp: tuple


def _first_table(t) -> torch.Tensor:
    """The first per-bucket tensor of a reducer side (per-bucket tables
    or StreamFactors): the dtype and device of the reduction (the JAX
    package's `_table_dtype`)."""
    return t.q[0] if isinstance(t, StreamFactors) else t[0]


def _factor_tables(t):
    """Per-bucket tables of a reducer side: the tables themselves, or
    the (q, jp) pair of each bucket of a StreamFactors."""
    return tuple(zip(t.q, t.jp)) if isinstance(t, StreamFactors) else t


def _slot_table(t, n: int):
    """A bucket's [L, n*K] table as its [L*n + 1, K] slot table; the
    appended zero row is what the fill sentinel gathers. A (q, jp) pair
    gives the pair of slot tables."""
    if isinstance(t, tuple):
        return tuple(_slot_table(x, n) for x in t)
    K = t.shape[1] // n
    flat = t.reshape(-1, K)
    return torch.cat([flat, flat.new_zeros((1, K))], dim=0)


def _gather_slot_rows(table, idx: torch.Tensor) -> torch.Tensor:
    """Slot rows of a slot table at idx, or, from a (q, jp) pair of slot
    tables, the W rows of those slots built after the gather: K2 at
    n = 1 on the gathered rows (the r = 0 term plus the r = 1 term; zero
    rows at the pads)."""
    if isinstance(table, tuple):
        q6, jp18 = table
        return fold.w_build(q6[idx], jp18[idx], 1)
    return table[idx]


def pair_outer_stream(strip_a, strip_b, buckets: Sequence[BucketIndex],
                      ps: PairStreamIndex) -> torch.Tensor:
    """Strict-pair block-product reduction over the PairStream index:

        out[p, a*9+b] = sum over slots of pair p of
                        sum_k strip_a[first, k*9+a] strip_b[second, k*9+b]

    strip_a/strip_b are per-bucket tuples of [L_b, n_b*K*9] tables or
    StreamFactors. Each sub-stream's gathered slot rows go through K1
    (ops.fold) and its run rows are added into the [P+1, 81] table in a
    fixed order (_scatter_runs)."""
    same = strip_a is strip_b
    P = ps.num_pairs
    out = _first_table(strip_a).new_zeros((P + 1, 81))
    strip_a, strip_b = _factor_tables(strip_a), _factor_tables(strip_b)
    for t, bi in enumerate(ps.stream_bucket):
        n = buckets[bi].cam_idx.shape[1]
        fa = _slot_table(strip_a[bi], n)
        fb = fa if same else _slot_table(strip_b[bi], n)
        for wi, wj, rp, tree in zip(ps.wi_idx[t], ps.wj_idx[t],
                                    ps.run_pair[t], ps.run_tree[t]):
            rows = fold.outer81_fold(_gather_slot_rows(fa, wi),
                                     _gather_slot_rows(fb, wj),
                                     ps.widths[t])
            _scatter_runs(out, rows, rp, tree)
    return out[:P]


def cam_gram_stream(terms, buckets: Sequence[BucketIndex],
                    cs: CamStreamIndex) -> torch.Tensor:
    """Per-camera 81-wide gram sums over the CamStream index:
    out[c] = sum over obs slots of camera c of
             sum_terms sign * A_slot' B_slot (terms: [(A, B, sign)] of
    per-bucket [L, n*K*9] tables or StreamFactors); each fold is a K1
    launch."""
    N = cs.num_cameras
    out = _first_table(terms[0][0]).new_zeros((N + 1, 81))
    terms = [(_factor_tables(A), _factor_tables(B), sign, A is B)
             for A, B, sign in terms]
    for t, bi in enumerate(cs.stream_bucket):
        n = buckets[bi].cam_idx.shape[1]
        tabs = []
        for A, B, sign, same_t in terms:
            fa = _slot_table(A[bi], n)
            tabs.append((fa, fa if same_t else _slot_table(B[bi], n),
                         sign, same_t))
        for w, rc, tree in zip(cs.w_idx[t], cs.run_cam[t],
                               cs.run_tree[t]):
            acc = None
            for fa, fb, sign, same_t in tabs:
                si = _gather_slot_rows(fa, w)
                sj = si if same_t else _gather_slot_rows(fb, w)
                g = fold.outer81_fold(si, sj, cs.width) * sign
                acc = g if acc is None else acc + g
            _scatter_runs(out, acc, rc, tree)
    return out[:N]


def cam_reduce_stream(tables, buckets: Sequence[BucketIndex],
                      cs: CamStreamIndex) -> torch.Tensor:
    """Per-camera F-wide row sums over the CamStream index: tables is a
    per-bucket tuple of [L, n*F] contribution rows."""
    N = cs.num_cameras
    W = cs.width
    n0 = buckets[0].cam_idx.shape[1]
    F = tables[0].shape[1] // n0
    out = tables[0].new_zeros((N + 1, F))
    for t, bi in enumerate(cs.stream_bucket):
        fa = _slot_table(tables[bi], buckets[bi].cam_idx.shape[1])
        for w, rc, tree in zip(cs.w_idx[t], cs.run_cam[t],
                               cs.run_tree[t]):
            _scatter_runs(out, fa[w].reshape(-1, W, F).sum(dim=1), rc,
                          tree)
    return out[:N]


# ---------------------------------------------------------------------------
# The "strips" and "obs" pair gathers (host builders:
# bal.bucketing.build_pair_strips / build_cam_strips / build_pair_csr) and
# their reducers. Their run rows are concatenated in the JAX package's
# order (the groups in emission order, then the leftover stream) and
# summed per pair or camera through idx2 (_level2_reduce): a gather and a
# sum, so these routes add no scatter and repeat bit for bit on the card.

PAIR_WIDTH = 64
# per-chunk gather budget of the strips and obs reducers: the bytes of
# one chunk's gathered slot rows of one table (module global so tests can
# force several chunks). One chunk's gathers and K1 output live at a time.
_PAIR_CHUNK_BYTES = 64 << 20


def _chunk_slots(row_bytes: int, width: int) -> int:
    """Slots per chunk of a gather-and-fold: whole runs of `width`, at
    most _PAIR_CHUNK_BYTES of gathered rows of `row_bytes` each."""
    return max(1, _PAIR_CHUNK_BYTES // max(row_bytes * width, 1)) * width


def _flat_ext(flat: torch.Tensor) -> torch.Tensor:
    """A flat [O, ...] per-obs array as its [O + 1, F] row table; the
    appended zero row is what the pad index O gathers."""
    f2 = flat.reshape(flat.shape[0], -1)
    return torch.cat([f2, f2.new_zeros((1, f2.shape[1]))], dim=0)


def split_flat_by_bucket(flat, buckets):
    """[O, ...] flat per-obs array -> per-bucket tuple of [L, n*F] tables
    (views); per-bucket tables (or StreamFactors) pass through."""
    if isinstance(flat, (tuple, list)):
        return flat
    f2 = flat.reshape(flat.shape[0], -1)
    outs = []
    off = 0
    for b in buckets:
        L, n = b.cam_idx.shape
        outs.append(f2[off:off + L * n].reshape(L, -1))
        off += L * n
    return tuple(outs)


def _fold_gathered(fa: torch.Tensor, fb: torch.Tensor, i1: torch.Tensor,
                   i2: Optional[torch.Tensor], width: int):
    """K1 over the slot rows fa[i1] and fb[i2] (i2 None: the same rows
    as the first side), chunk by chunk: yields each chunk's [runs, 81]
    run rows."""
    step = _chunk_slots(fa.shape[1] * fa.element_size(), width)
    for a in range(0, i1.shape[0], step):
        s1 = fa.index_select(0, i1[a:a + step])
        s2 = s1 if i2 is None else fb.index_select(0, i2[a:a + step])
        yield fold.outer81_fold(s1, s2, width)


def _sum_runs(chunks, num_runs: int, idx2: torch.Tensor,
              like: torch.Tensor, F: int) -> torch.Tensor:
    """Write the [*, F] run rows that `chunks` yields, in order, into
    one [num_runs + 1, F] table (its last row the zero dump row of
    idx2's pads) and sum them per target through idx2: one resident
    table, one chunk's transients at a time."""
    rows = like.new_empty((num_runs + 1, F))
    at = 0
    for c in chunks:
        rows[at:at + c.shape[0]] = c
        at += c.shape[0]
    if at != num_runs:
        raise ValueError(f"{at} run rows for an index of {num_runs}")
    rows[num_runs] = 0
    return _level2_reduce(rows, idx2)


def _num_runs(slot_lists, leftover: torch.Tensor) -> int:
    """Run rows of a strips index: its groups' slots in runs of
    PAIR_WIDTH, then the leftover stream's [Rl, width] runs."""
    return (sum(x.shape[0] for x in slot_lists) // PAIR_WIDTH
            + leftover.shape[0])


@dataclass(frozen=True)
class PairCsrIndex:
    """Device copy of bucketing.PairCsr (the "obs" pair gather): wi_idx /
    wj_idx [R, width] flat obs indices of each slot's two sides
    (pad = O), idx2 [P, vmax] (pad = R), the pair list and the dense
    block maps."""

    wi_idx: torch.Tensor
    wj_idx: torch.Tensor
    idx2: torch.Tensor
    pair_row: torch.Tensor
    pair_col: torch.Tensor
    up_idx: torch.Tensor
    lo_idx: torch.Tensor

    @property
    def num_pairs(self) -> int:
        return self.pair_row.shape[0]

    @staticmethod
    def from_host(pc, device) -> "PairCsrIndex":
        def up(a, dt=np.int64):
            return torch.as_tensor(np.asarray(a, dt), device=device)

        # the slot tables are the largest index (two int32 per pair slot)
        return PairCsrIndex(
            wi_idx=up(pc.wi_idx, np.int32), wj_idx=up(pc.wj_idx, np.int32),
            idx2=up(pc.idx2), pair_row=up(pc.pair_row),
            pair_col=up(pc.pair_col), up_idx=up(pc.up_idx),
            lo_idx=up(pc.lo_idx))


class _SelfPairView(NamedTuple):
    """A CamCsrIndex presented as a pair index whose two sides are the
    same observation, so that csr_pair_outer reduces per-camera gram
    blocks (the obs route's diagonal blocks)."""

    wi_idx: torch.Tensor
    wj_idx: torch.Tensor
    idx2: torch.Tensor

    @staticmethod
    def of(csr: CamCsrIndex) -> "_SelfPairView":
        return _SelfPairView(wi_idx=csr.idx, wj_idx=csr.idx, idx2=csr.idx2)


def csr_pair_outer(strip_a: torch.Tensor, strip_b: torch.Tensor,
                   pairs) -> torch.Tensor:
    """Per-unique-camera-pair sum of per-observation-pair block products
    over a PairCsrIndex (or _SelfPairView):

        out[p, a*9+b] = sum over obs pairs (i, j) of camera pair p of
                        sum_k strip_a[i, k, a] * strip_b[j, k, b]

    strips are flat per-obs [O, K, 9] factors (the middle matrix
    symmetric, so that the canonical pair swap is valid). Both sides'
    slot rows are gathered chunk by chunk and each run of `width` slots
    folded by K1. Replaces the reference's num_cams^2 mutex scatter for
    RCS assembly (sc/linearization_sc.hpp:327-348)."""
    same = strip_a is strip_b
    fa = _flat_ext(strip_a)
    fb = fa if same else _flat_ext(strip_b)
    shared = pairs.wi_idx is pairs.wj_idx
    wi = pairs.wi_idx.reshape(-1)
    wj = None if (same and shared) else (
        wi if shared else pairs.wj_idx.reshape(-1))
    rows = _fold_gathered(fa, fb, wi, wj, pairs.wi_idx.shape[1])
    return _sum_runs(rows, pairs.wi_idx.shape[0], pairs.idx2, fa,
                     81)  # [P, 81]


def _collapse_groups(buckets, group_bucket, lm_idx, cols):
    """A strips index's groups as one slot list per bucket: the buckets
    that have groups, in order, and per side the [S_b] slot ids
    lm*n + col into the bucket's [L*n + 1] slot table (pad rows L ->
    L*n, the zero row of _slot_table), in the groups' order. cols(g)
    gives, for the bucket's group ids g, each side's per-slot column.
    build_pair_strips and build_cam_strips emit the groups bucket by
    bucket, so the concatenated per-bucket lists keep the JAX package's
    row order."""
    gb = np.asarray(group_bucket, np.int64)
    if gb.size and np.any(np.diff(gb) < 0):
        raise ValueError("strip groups are not in bucket order")
    ids, per_side = [], []
    for bi in np.unique(gb):
        L, n = buckets[bi].cam_idx.shape
        g = np.nonzero(gb == bi)[0]
        # int32 throughout (a bucket's L*n + 1 slots fit): 518M slot ids
        # per side at final-3068 with min_group=0
        lm = np.concatenate([lm_idx[k] for k in g]).astype(np.int32)
        pad = lm == L
        ids.append(int(bi))
        per_side.append([np.where(pad, np.int32(L * n), lm * np.int32(n)
                                  + c) for c in cols(g)])
    return tuple(ids), per_side


@dataclass(frozen=True)
class PairStripsIndex:
    """Device copy of bucketing.PairStrips (the "strips" pair gather)
    with each bucket's groups collapsed: per bucket that has groups, the
    slot ids of every slot's canonical first and second side (the swap
    applied on the host), so that a bucket costs one gather per side
    and one K1 launch per chunk where the JAX package slices per group;
    the leftover stream's flat obs indices (pad = O); idx2 [P, vmax]
    over the groups' runs then the leftover's; the pair list and the
    dense block maps."""

    bucket_ids: Tuple[int, ...]
    first: Tuple[torch.Tensor, ...]
    second: Tuple[torch.Tensor, ...]
    wi_idx: torch.Tensor  # [Rl, width] int32
    wj_idx: torch.Tensor
    idx2: torch.Tensor
    pair_row: torch.Tensor
    pair_col: torch.Tensor
    up_idx: torch.Tensor
    lo_idx: torch.Tensor

    @property
    def num_pairs(self) -> int:
        return self.pair_row.shape[0]

    @property
    def has_leftover(self) -> bool:
        return self.wi_idx.shape[0] > 0

    @staticmethod
    def from_host(ps, buckets, device) -> "PairStripsIndex":
        """Upload a host PairStrips; `buckets` are the host buckets (for
        their [L, n] shapes)."""
        def up(a, dt=np.int64):
            return torch.as_tensor(np.asarray(a, dt), device=device)

        sizes = np.array([x.size for x in ps.lm_idx], np.int64)
        gi = np.asarray(ps.group_i, np.int32)
        gj = np.asarray(ps.group_j, np.int32)

        def cols(g):
            sw = np.concatenate([ps.swap[k] for k in g]).astype(bool)
            i = np.repeat(gi[g], sizes[g])
            j = np.repeat(gj[g], sizes[g])
            return np.where(sw, j, i), np.where(sw, i, j)

        ids, per = _collapse_groups(buckets, ps.group_bucket, ps.lm_idx,
                                    cols)
        return PairStripsIndex(
            bucket_ids=ids, first=tuple(up(s[0], np.int32) for s in per),
            second=tuple(up(s[1], np.int32) for s in per),
            wi_idx=up(ps.wi_idx, np.int32), wj_idx=up(ps.wj_idx, np.int32),
            idx2=up(ps.idx2), pair_row=up(ps.pair_row),
            pair_col=up(ps.pair_col), up_idx=up(ps.up_idx),
            lo_idx=up(ps.lo_idx))


@dataclass(frozen=True)
class CamStripsIndex:
    """Device copy of bucketing.CamStrips with each bucket's groups
    collapsed (as PairStripsIndex): per bucket that has groups, the slot
    ids of its slots in the groups' order; the leftover stream's flat
    obs indices (pad = O); idx2 [N, vmax]."""

    bucket_ids: Tuple[int, ...]
    slot: Tuple[torch.Tensor, ...]
    wi_idx: torch.Tensor  # [Rl, width] int32
    idx2: torch.Tensor

    @property
    def has_leftover(self) -> bool:
        return self.wi_idx.shape[0] > 0

    @staticmethod
    def from_host(cs, buckets, device) -> "CamStripsIndex":
        def up(a, dt=np.int64):
            return torch.as_tensor(np.asarray(a, dt), device=device)

        sizes = np.array([x.size for x in cs.lm_idx], np.int64)
        gi = np.asarray(cs.group_i, np.int32)
        ids, per = _collapse_groups(
            buckets, cs.group_bucket, cs.lm_idx,
            lambda g: (np.repeat(gi[g], sizes[g]),))
        return CamStripsIndex(
            bucket_ids=ids, slot=tuple(up(s[0], np.int32) for s in per),
            wi_idx=up(cs.wi_idx, np.int32), idx2=up(cs.idx2))


def build_pair_index(buckets, num_cameras: int, pair_gather: str, device,
                     min_group: int = 16384, grid_n: Optional[int] = None,
                     dense_grid: bool = True):
    """The explicit system's strict-pair index in the gather formulation
    `pair_gather` names ("stream", "strips" or "obs"), with the matching
    per-camera index (None for "obs": its per-camera sums go through the
    camera CSR), from the host buckets. grid_n pads the dense block maps
    to K3's camera grid; dense_grid=False skips them (BSR mode). Returns
    (pair index, camera index, host pair index -- for "stream" its host
    pair list, pair_stream.PairList -- whose pair list feeds the BSR
    index). The stream index is built on `device`; the others on
    the host, then uploaded."""
    from rootba_tpu_torch.bal import bucketing
    from rootba_tpu_torch.solver import pair_stream

    grid = dict(grid_n=grid_n, dense_grid=dense_grid)
    N = num_cameras
    with trace.span("prep.build.pair_index"):
        if pair_gather == "stream":
            with trace.span("prep.build.pair_stream"):
                pairs, host = pair_stream.build_pair_stream_index(
                    buckets, N, device, **grid)
            with trace.span("prep.build.cam_stream"):
                cams = CamStreamIndex.from_host(bucketing.build_cam_stream(
                    buckets, N), buckets, device)
            return pairs, cams, host
        if pair_gather == "strips":
            with trace.span("prep.build.pair_strips"):
                host = bucketing.build_pair_strips(
                    buckets, N, min_group=min_group, **grid)
                pairs = PairStripsIndex.from_host(host, buckets, device)
            with trace.span("prep.build.cam_strips"):
                cams = CamStripsIndex.from_host(bucketing.build_cam_strips(
                    buckets, N, min_group=min_group), buckets, device)
            return pairs, cams, host
        with trace.span("prep.build.pair_csr"):
            host = bucketing.build_pair_csr(buckets, N, **grid)
            return PairCsrIndex.from_host(host, device), None, host


def cam_parts_mode(cam_strips) -> bool:
    """True when the per-camera reducers take per-bucket tables
    (leftover-free CamStrips, or a CamStream index)."""
    if cam_strips is None:
        return False
    if isinstance(cam_strips, CamStreamIndex):
        return True
    return not cam_strips.has_leftover


def pair_parts_mode(pairs) -> bool:
    """True when the pair reducer takes per-bucket tables."""
    if isinstance(pairs, PairStreamIndex):
        return True
    return isinstance(pairs, PairStripsIndex) and not pairs.has_leftover


def pair_slots(pairs) -> int:
    """The slots, padding included, that one strict-pair reduction over
    `pairs` gathers and folds, from the index's shapes (no device
    read)."""
    if isinstance(pairs, PairStreamIndex):
        return sum(wi.numel() for t in pairs.wi_idx for wi in t)
    if isinstance(pairs, PairStripsIndex):
        return sum(f.numel() for f in pairs.first) + pairs.wi_idx.numel()
    return pairs.wi_idx.numel()


def _no_leftover_parts(parts: bool) -> None:
    if parts:
        raise ValueError("per-bucket strip tables require an index built "
                         "with min_group=0 (no per-obs leftover stream)")


def csr_pair_outer_strips(strip_a, strip_b, buckets,
                          strips) -> torch.Tensor:
    """Strict-pair block-product reduction over a PairStripsIndex, with
    csr_pair_outer's semantics (`first` the observation on the pair's
    lower-id camera):

        out[p, a*9+b] = sum over obs pairs of camera pair p of
                        sum_k strip_a[first, k, a] strip_b[second, k, b]

    strip_a/strip_b are flat [O, K, 9] arrays or per-bucket tuples of
    [L_b, n_b*K*9] tables (those need a leftover-free index). Per
    bucket, both sides' slot rows are gathered from the bucket's slot
    table and folded by K1 at width 64, chunk by chunk; the leftover
    stream gathers flat rows the same way. A PairStreamIndex routes to
    pair_outer_stream."""
    same = strip_a is strip_b
    ta = split_flat_by_bucket(strip_a, buckets)
    tb = ta if same else split_flat_by_bucket(strip_b, buckets)
    if isinstance(strips, PairStreamIndex):
        return pair_outer_stream(ta, tb, buckets, strips)
    if strips.has_leftover:
        _no_leftover_parts(isinstance(strip_a, (tuple, list)))

    def rows():
        for bi, s1, s2 in zip(strips.bucket_ids, strips.first,
                              strips.second):
            n = buckets[bi].cam_idx.shape[1]
            fa = _slot_table(ta[bi], n)
            fb = fa if same else _slot_table(tb[bi], n)
            yield from _fold_gathered(fa, fb, s1, s2, PAIR_WIDTH)
        if strips.has_leftover:
            fa = _flat_ext(strip_a)
            fb = fa if same else _flat_ext(strip_b)
            yield from _fold_gathered(fa, fb, strips.wi_idx.reshape(-1),
                                      strips.wj_idx.reshape(-1),
                                      strips.wi_idx.shape[1])

    return _sum_runs(rows(), _num_runs(strips.first, strips.wi_idx),
                     strips.idx2, _first_table(ta), 81)  # [P, 81]


def _strip_run_rows(buckets, strips: CamStripsIndex, flat_tables, row_fn,
                    out_width, row_fn_runs=None) -> torch.Tensor:
    """Shared two-level skeleton of the camera-strip reducers: per
    bucket, gather each table's slot rows at the bucket's slot ids
    (chunked), hand them to row_fn -> [rows, out_width] and sum runs of
    64 (or row_fn_runs(slices, width) -> [rows/width, out_width], which
    folds the runs itself, by K1); the leftover stream gathers flat rows
    the same way. Returns the [N, out_width] per-camera totals via
    idx2. Each flat_tables entry is a flat [O, ...] array or a
    per-bucket tuple of [L_b, n_b*K] tables (those need a leftover-free
    index)."""
    tabs = [split_flat_by_bucket(f, buckets) for f in flat_tables]

    def runs(slices, width):
        if row_fn_runs is not None:
            return row_fn_runs(slices, width)
        return row_fn(slices).reshape(-1, width, out_width).sum(dim=1)

    def gather_runs(tables, idx, width):
        step = _chunk_slots(sum(t.shape[1] * t.element_size()
                                for t in tables), width)
        for a in range(0, idx.shape[0], step):
            yield runs([t.index_select(0, idx[a:a + step])
                        for t in tables], width)

    if strips.has_leftover:
        _no_leftover_parts(any(isinstance(f, (tuple, list))
                               for f in flat_tables))

    def rows():
        for bi, slot in zip(strips.bucket_ids, strips.slot):
            n = buckets[bi].cam_idx.shape[1]
            yield from gather_runs([_slot_table(t[bi], n) for t in tabs],
                                   slot, PAIR_WIDTH)
        if strips.has_leftover:
            yield from gather_runs([_flat_ext(f) for f in flat_tables],
                                   strips.wi_idx.reshape(-1),
                                   strips.wi_idx.shape[1])

    return _sum_runs(rows(), _num_runs(strips.slot, strips.wi_idx),
                     strips.idx2, _first_table(tabs[0]), out_width)


def cam_reduce_strips(flat, buckets, strips) -> torch.Tensor:
    """Per-camera sum of per-obs-slot contribution rows over a
    CamStripsIndex (csr_cam_reduce's semantics): `flat` is an [O, F]
    array or a per-bucket tuple of [L_b, n_b*F] tables. A CamStreamIndex
    routes to cam_reduce_stream."""
    if isinstance(strips, CamStreamIndex):
        return cam_reduce_stream(split_flat_by_bucket(flat, buckets),
                                 buckets, strips)
    if isinstance(flat, (tuple, list)):
        F = flat[0].shape[1] // buckets[0].cam_idx.shape[1]
    else:
        F = flat.shape[1]
    return _strip_run_rows(buckets, strips, [flat], lambda s: s[0], F)


def cam_gram_strips(terms, buckets, strips) -> torch.Tensor:
    """Per-camera gram blocks sum_obs sum_k A[o,k,a] B[o,k,b] as [N, 81]
    rows, each run folded by K1: terms = [(A, B, sign)], each side a
    flat [O, K, 9] array or a per-bucket tuple of [L_b, n_b*K*9] tables;
    a table shared between terms or sides is gathered once. A
    CamStreamIndex routes to cam_gram_stream."""
    if isinstance(strips, CamStreamIndex):
        seen = {}

        def as_parts(M):
            if id(M) not in seen:
                seen[id(M)] = split_flat_by_bucket(M, buckets)
            return seen[id(M)]

        return cam_gram_stream([(as_parts(A), as_parts(B), sign)
                                for A, B, sign in terms], buckets, strips)
    tabs = []
    ids = {}
    term_ix = []
    for A, B, sign in terms:
        for M in (A, B):
            if id(M) not in ids:
                ids[id(M)] = len(tabs)
                tabs.append(M if isinstance(M, (tuple, list))
                            else M.reshape(M.shape[0], -1))
        term_ix.append((ids[id(A)], ids[id(B)], sign))

    def row_fn_runs(slices, width):
        out = None
        for ia, ib, sign in term_ix:
            prod = fold.outer81_fold(slices[ia], slices[ib], width)
            prod = prod if sign == 1.0 else sign * prod
            out = prod if out is None else out + prod
        return out

    return _strip_run_rows(buckets, strips, tabs, None, 81,
                           row_fn_runs=row_fn_runs)


def _ww_sandwich_U(q1, q2, p1):
    """Per-slot U = (q1 q2')' p1 for the W'W sandwich (see
    sqrt_ww_pair_strips): q1/q2 [rows, 6] Q1h slot rows (2 residual rows
    x 3 landmark cols, r-major), p1 [rows, 18] Jp slot rows (2 rows x 9,
    r-major). Returns [rows, 18] with u_s = sum_r M[r, s] p1_r,
    M = q1 q2' (2x2)."""
    m00 = torch.sum(q1[:, :3] * q2[:, :3], dim=1)[:, None]
    m01 = torch.sum(q1[:, :3] * q2[:, 3:], dim=1)[:, None]
    m10 = torch.sum(q1[:, 3:] * q2[:, :3], dim=1)[:, None]
    m11 = torch.sum(q1[:, 3:] * q2[:, 3:], dim=1)[:, None]
    u0 = m00 * p1[:, :9] + m10 * p1[:, 9:]
    u1 = m01 * p1[:, :9] + m11 * p1[:, 9:]
    return torch.cat([u0, u1], dim=1)


def sqrt_ww_pair_strips(q_tabs, jp_tabs, buckets,
                        strips: PairStripsIndex) -> torch.Tensor:
    """Pair blocks sum W_i' W_j of the sqrt RCS without the W tables:
    per pair slot W_i' W_j = Jp_i' (Q1h_i Q1h_j') Jp_j, a 2x2 sandwich
    M = Q1h_i Q1h_j', then K1 folds U = M' Jp_i against Jp_j. Trades a
    second gather per slot (the Q1h and Jp rows instead of one W row)
    for never holding the [sum L, n*27] W tables. q_tabs / jp_tabs:
    per-bucket [L, n*6] / [L, n*18] tables (the index must be
    leftover-free). Returns [P, 81] in csr_pair_outer_strips' order."""
    if strips.has_leftover:
        raise ValueError("sqrt_ww_pair_strips requires a leftover-free "
                         "strips index (min_group=0)")

    def rows():
        for bi, s1, s2 in zip(strips.bucket_ids, strips.first,
                              strips.second):
            n = buckets[bi].cam_idx.shape[1]
            tq = _slot_table(q_tabs[bi], n)
            tj = _slot_table(jp_tabs[bi], n)
            step = _chunk_slots((tq.shape[1] + tj.shape[1])
                                * tq.element_size(), PAIR_WIDTH)
            for a in range(0, s1.shape[0], step):
                i1, i2 = s1[a:a + step], s2[a:a + step]
                U = _ww_sandwich_U(tq.index_select(0, i1),
                                   tq.index_select(0, i2),
                                   tj.index_select(0, i1))
                yield fold.outer81_fold(U, tj.index_select(0, i2),
                                        PAIR_WIDTH)

    return _sum_runs(rows(), _num_runs(strips.first, strips.wi_idx),
                     strips.idx2, q_tabs[0], 81)


def sqrt_ww_diag_strips(q_tabs, jp_tabs, buckets,
                        strips: CamStripsIndex) -> torch.Tensor:
    """Per-camera diagonal blocks Jp'Jp - W'W of the sqrt RCS without the
    W tables (sqrt_ww_pair_strips' sandwich with i = j): [N, 81]."""

    def row_fn_runs(slices, width):
        q, p = slices
        U = _ww_sandwich_U(q, q, p)
        return (fold.outer81_fold(p, p, width)
                - fold.outer81_fold(U, p, width))

    return _strip_run_rows(buckets, strips, [q_tabs, jp_tabs], None, 81,
                           row_fn_runs=row_fn_runs)


def _pair_rows(strip_a, strip_b, pairs, buckets, pair_rows):
    """The [P, 81] strict-pair rows of an assembly: given (the W-free
    sandwich's), else by the pair index's reducer."""
    if pair_rows is not None:
        return pair_rows
    if isinstance(pairs, (PairStripsIndex, PairStreamIndex)):
        return csr_pair_outer_strips(strip_a, strip_b, buckets, pairs)
    return csr_pair_outer(strip_a, strip_b, pairs)


def _diag_rows(terms, buckets, num_cameras: int, csr, cam_strips):
    """The [N, 81] per-camera rows sum_terms sign * A' B of an assembly:
    through the camera strips or stream, else the camera CSR
    (_SelfPairView), else per-observation products (K1 at width 1) and
    a segment sum."""
    if cam_strips is not None:
        return cam_gram_strips(terms, buckets, cam_strips)
    if csr is not None:
        view = _SelfPairView.of(csr)
        out = None
        for A, B, sign in terms:
            g = sign * csr_pair_outer(A, B, view)
            out = g if out is None else out + g
        return out
    O = terms[0][0].shape[0]
    dcon = None
    for A, B, sign in terms:
        g = sign * fold.outer81_fold(A.reshape(O, -1), B.reshape(O, -1), 1)
        dcon = g if dcon is None else dcon + g
    cam_flat = torch.cat([b.cam_idx.reshape(-1) for b in buckets])
    return segment_sum(dcon, cam_flat, num_cameras)


def assemble_rcs_dense(strip_a, strip_b, pairs, lam, num_cameras: int,
                       buckets, pose_scale, diag81, diag_terms=None,
                       csr=None, cam_strips=None,
                       pair_rows=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense reduced camera system from per-slot factors:

        H = sum_terms sign * A_i' B_i on the block diagonal
            - strip_a_i' strip_b_j at off-diagonal camera pairs + lam I

    with the deferred jacobi pose scale applied at the [P, 81] / [N, 81]
    level (pose_scale None: factors already scaled, the SC solvers').
    The pair rows come from pair_rows when given (the W-free sandwich),
    else from the reducer of `pairs` (a stream, strips or obs index);
    the [N, 81] diagonal rows from diag81 when given (SQUARE_ROOT's
    cached Jp gram less W'W), else from diag_terms [(A, B, sign)]
    through cam_strips, else the camera CSR, else a segment sum.
    Returns (Hz, diag): Hz the feature-major ("z-space") dense matrix
    Hz[a*G+i, b*G+j] = block(i,j)[a,b] on the (possibly padded) [G, G]
    camera grid of the pair index, diag the [N,9,9] diagonal blocks (the
    SCHUR_JACOBI preconditioner, free)."""
    P9 = POSE_SIZE
    N = num_cameras
    Hup = _pair_rows(strip_a, strip_b, pairs, buckets, pair_rows)
    if diag81 is None:
        diag81 = _diag_rows(diag_terms, buckets, N, csr, cam_strips)
    if pose_scale is not None:
        Hup = Hup * _pair_scale(pose_scale, pairs.pair_row, pairs.pair_col)
        diag81 = diag81 * (pose_scale.repeat_interleave(P9, dim=1)
                           * pose_scale.repeat(1, P9))

    zero = Hup.new_zeros((1, P9 * P9))
    up = torch.cat([-Hup, zero], dim=0)
    lo = torch.cat([-Hup[:, _block_transpose(Hup.device)], zero], dim=0)
    G = int(round(float(np.sqrt(pairs.up_idx.shape[0]))))
    dense81 = up[pairs.up_idx] + lo[pairs.lo_idx]  # [G*G, 81]
    diag_ids = torch.arange(N, device=Hup.device) * (G + 1)
    dense81.index_add_(0, diag_ids, diag81)
    Hz = dense81.T.reshape(P9, P9, G, G).permute(0, 2, 1, 3).reshape(
        G * P9, G * P9)
    # + lam I in place on the diagonal (no [9G, 9G] identity temporary)
    Hz.diagonal().add_(lam)
    eye = torch.eye(P9, dtype=Hz.dtype, device=Hz.device)
    diag = diag81.reshape(N, P9, P9) + lam * eye
    return Hz, diag


# ---------------------------------------------------------------------------
# The block-sparse reduced camera system (sqrt_rcs_mode="bsr"): the same
# pair and camera reductions as assemble_rcs_dense without the densify,
# for camera counts whose dense [9N, 9N] matrix is too large. Every
# reduction here is a gather and a sum in a fixed order (no scatter-add),
# so the CG operator is deterministic on the card.

# per-chunk gather budget of _level2_reduce (module global so tests can
# shrink it and force the chunked path on toy problems)
_LEVEL2_CHUNK_BYTES = 16 << 20
# rows per chunk of the [P, 81] / [E, 81] table fills (module global so
# tests can force several chunks and a tail): one chunk's transients
# live at a time next to the one resident table
_FILL_CHUNK_ROWS = (1 << 23) // 81
# block entries per chunk of a matvec: its [chunk, 81] product
# transient is the largest buffer a matvec allocates
_MATVEC_CHUNK_ENTRIES = 512 << 10


def _block_transpose(device) -> torch.Tensor:
    """The column permutation of a [*, 81] table that transposes each
    row-major 9x9 block."""
    P9 = POSE_SIZE
    return torch.arange(P9 * P9, device=device).reshape(P9, P9).T.reshape(-1)


def _take_fill(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table rows at idx, zero rows where idx is past the table's end:
    the reference's take(..., mode="fill") for a table too large to
    copy with an appended zero row (idx >= 0)."""
    n = table.shape[0]
    if n == 0:
        return table.new_zeros((idx.shape[0],) + tuple(table.shape[1:]))
    rows = table.index_select(0, idx.clamp(max=n - 1))
    return rows.masked_fill_((idx >= n)[:, None], 0)


def _level2_reduce(rows: torch.Tensor, idx2: torch.Tensor) -> torch.Tensor:
    """Second-level run reduction: out[s] = sum_v rows[idx2[s, v]], idx2
    padded with the dump row, which the caller appends to `rows` as a
    zero row. Chunked over the segment axis so that one [chunk, vmax, F]
    gather lives at a time."""
    S, V = idx2.shape
    F = rows.shape[1]
    chunk = max(1, min(S, _LEVEL2_CHUNK_BYTES // max(V * F * 4, 1)))
    out = rows.new_empty((S, F))
    for a in range(0, S, chunk):
        ic = idx2[a:a + chunk]
        out[a:a + ic.shape[0]] = rows.index_select(
            0, ic.reshape(-1)).reshape(-1, V, F).sum(dim=1)
    return out


@dataclass(frozen=True)
class BsrMatvecIndex:
    """Device copy of bucketing.BsrMatvec: blk_idx / col_idx flat
    [R*width] (pads 2P and N), idx2 [N, vmax] (pad R); int32, as on the
    host, so that each matvec reads half the index bytes of int64."""

    blk_idx: torch.Tensor
    col_idx: torch.Tensor
    idx2: torch.Tensor
    width: int

    @property
    def shape2d(self) -> Tuple[int, int]:
        return (self.blk_idx.shape[0] // self.width, self.width)

    @staticmethod
    def from_host(bm, device) -> "BsrMatvecIndex":
        def up(a):
            return torch.as_tensor(np.asarray(a, np.int32), device=device)

        return BsrMatvecIndex(
            blk_idx=up(bm.blk_idx).reshape(-1),
            col_idx=up(bm.col_idx).reshape(-1), idx2=up(bm.idx2),
            width=int(np.asarray(bm.blk_idx).shape[1]))


def _pair_scale(pose_scale, pair_row, pair_col):
    """Row scales S_i x S_j of the [*, 81] blocks of pairs (i, j)."""
    P9 = POSE_SIZE
    Sp = pose_scale[pair_row]
    Sc = pose_scale[pair_col]
    return Sp.repeat_interleave(P9, dim=1) * Sc.repeat(1, P9)


def _scale_neg_chunked(Hup, pose_scale, pair_row, pair_col):
    """-S_i Hup S_j IN PLACE over the [P, 81] pair table, chunk by chunk:
    a whole-table scale tensor would double the table's footprint
    (pose_scale None: -Hup)."""
    if pose_scale is None:
        return Hup.neg_()
    P = Hup.shape[0]
    for a in range(0, P, _FILL_CHUNK_ROWS):
        b = min(P, a + _FILL_CHUNK_ROWS)
        Hup[a:b].mul_(_pair_scale(pose_scale, pair_row[a:b],
                                  pair_col[a:b])).neg_()
    return Hup


def assemble_rcs_bsr(strip_a, strip_b, pairs, lam, num_cameras: int,
                     buckets, pose_scale, diag81, symmetric: bool = False,
                     diag_terms=None, csr=None, cam_strips=None,
                     pair_rows=None):
    """Block-sparse RCS assembly: the pair and camera reductions of
    assemble_rcs_dense without the densify. Returns (blocks, diag):

      blocks [2P, 81] = [-H_up; -H_up'] (the transpose as a column
        permutation, done here once per stage2), or with symmetric=True
        the [P, 81] strict-pair half table -H_up, which the matvecs and
        bsr_pack_from_half read in both directions;
      diag [N, 9, 9] = per-camera diagonal blocks + lam I (also the
        SCHUR_JACOBI preconditioner).

    The deferred jacobi pose scale is applied at the [P, 81] level
    (None: unit, the SC solvers'); the pair and diagonal rows as in
    assemble_rcs_dense."""
    P9 = POSE_SIZE
    N = num_cameras
    Hup = _pair_rows(strip_a, strip_b, pairs, buckets, pair_rows)
    if diag81 is None:
        diag81 = _diag_rows(diag_terms, buckets, N, csr, cam_strips)
    if pose_scale is not None:
        diag81 = diag81 * (pose_scale.repeat_interleave(P9, dim=1)
                           * pose_scale.repeat(1, P9))
    eye = torch.eye(P9, dtype=diag81.dtype, device=diag81.device)
    diag = diag81.reshape(N, P9, P9) + lam * eye
    if symmetric:
        return _scale_neg_chunked(Hup, pose_scale, pairs.pair_row,
                                  pairs.pair_col), diag
    P = Hup.shape[0]
    perm_t = _block_transpose(Hup.device)
    blocks2 = Hup.new_empty((2 * P, P9 * P9))
    for a in range(0, P, _FILL_CHUNK_ROWS):
        b = min(P, a + _FILL_CHUNK_ROWS)
        rows = Hup[a:b]
        if pose_scale is not None:
            rows = rows * _pair_scale(pose_scale, pairs.pair_row[a:b],
                                      pairs.pair_col[a:b])
        blocks2[a:b] = -rows
        blocks2[P + a:P + b] = -rows[:, perm_t]
    return blocks2, diag


def bsr_pack_from_half(half: torch.Tensor,
                       bsr: BsrMatvecIndex) -> torch.Tensor:
    """Run-major packed [R*W, 81] table from the strict-pair half table
    [P, 81]: entries with blk_idx >= P take the same pair's block
    transposed (a column permutation), pad entries (blk_idx = 2P) zeros.
    Filled chunk by chunk into one preallocated output."""
    P = half.shape[0]
    E = bsr.blk_idx.shape[0]
    perm_t = _block_transpose(half.device)
    out = half.new_empty((E, POSE_SIZE * POSE_SIZE))
    for a in range(0, E, _FILL_CHUNK_ROWS):
        b = min(E, a + _FILL_CHUNK_ROWS)
        bi = bsr.blk_idx[a:b]
        tr = bi >= P
        rows = _take_fill(half, torch.where(tr, bi - P, bi))
        out[a:b] = torch.where(tr[:, None], rows[:, perm_t], rows)
    return out


def bsr_symmetric_fits(bsr: BsrMatvecIndex, itemsize: int,
                       max_pack_bytes: int) -> bool:
    """True when the packed run-major table would exceed the byte
    budget: stage2 then keeps the [P, 81] half table and CG runs
    bsr_matvec_sym. Decided once, from the index's shape."""
    return bsr.blk_idx.shape[0] * 81 * itemsize > max_pack_bytes


def bsr_build_table(half: torch.Tensor, bsr: BsrMatvecIndex,
                    symmetric: bool) -> torch.Tensor:
    """stage2's BSR table: the half table itself in the symmetric regime,
    its packed run-major expansion otherwise (once per stage2, so the
    [2P, 81] both-direction form never exists)."""
    return half if symmetric else bsr_pack_from_half(half, bsr)


def _bsr_apply(diag, bsr: BsrMatvecIndex, x, chunk_products):
    """y = diag x + the off-diagonal sum: chunk_products(a, b, xg) gives
    the [(b-a)*W, 9] block products of the entries of runs a..b against
    their gathered x rows xg; runs sum over their W entries, cameras
    over their runs (idx2)."""
    P9 = POSE_SIZE
    R, W = bsr.shape2d
    chunk = max(1, min(R, _MATVEC_CHUNK_ENTRIES // W))
    # the zero rows that the pads read: col_idx = N, idx2 = R
    xe = torch.cat([x, x.new_zeros((1, P9))], dim=0)
    rsum = x.new_zeros((R + 1, P9))
    for a in range(0, R, chunk):
        b = min(R, a + chunk)
        xg = xe.index_select(0, bsr.col_idx[a * W:b * W])
        rsum[a:b] = chunk_products(a, b, xg).reshape(b - a, W, P9).sum(
            dim=1)
    y_off = _level2_reduce(rsum, bsr.idx2)
    return torch.sum(diag * x[:, None, :], dim=2) + y_off


def bsr_matvec_packed(packed: torch.Tensor, diag: torch.Tensor,
                      bsr: BsrMatvecIndex, x: torch.Tensor) -> torch.Tensor:
    """y = H x with the packed run-major table: each chunk of runs reads
    its table rows as a slice (no block gather), multiplies them with
    the gathered x rows, and sums."""
    P9 = POSE_SIZE
    W = bsr.width

    def products(a, b, xg):
        Hb = packed[a * W:b * W].reshape(-1, P9, P9)
        return torch.sum(Hb * xg[:, None, :], dim=2)

    return _bsr_apply(diag, bsr, x, products)


def bsr_matvec_sym(half: torch.Tensor, diag: torch.Tensor,
                   bsr: BsrMatvecIndex, x: torch.Tensor) -> torch.Tensor:
    """y = H x against the half table [P, 81]: entries with blk_idx >= P
    are the transpose direction and contract the gathered block
    transposed. The same gathered bytes as the [2P, 81] table, twice the
    products, half the resident table."""
    P9 = POSE_SIZE
    P = half.shape[0]
    W = bsr.width

    def products(a, b, xg):
        bi = bsr.blk_idx[a * W:b * W]
        tr = bi >= P
        Hm = _take_fill(half, torch.where(tr, bi - P, bi)).reshape(
            -1, P9, P9)
        prod_s = torch.sum(Hm * xg[:, None, :], dim=2)  # H x
        prod_t = torch.sum(Hm * xg[:, :, None], dim=1)  # H' x
        return torch.where(tr[:, None], prod_t, prod_s)

    return _bsr_apply(diag, bsr, x, products)


def bsr_table_matvec(table: torch.Tensor, diag: torch.Tensor,
                     bsr: BsrMatvecIndex, symmetric: bool):
    """The CG operator over a bsr_build_table result."""
    if symmetric:
        return lambda x: bsr_matvec_sym(table, diag, bsr, x)
    return lambda x: bsr_matvec_packed(table, diag, bsr, x)


# ---------------------------------------------------------------------------
# The bucket layout of the SC/PoBA solvers: per bucket, Jp [L, n, 2, 9],
# Jl [L, n, 2, 3] and r [L, n, 2] (the flat SQUARE_ROOT path keeps its
# own 2-D tables, sqrt_flat.FlatLin).


class LinBucket(NamedTuple):
    """Linearized (stage-1) data of one bucket."""

    Jp: torch.Tensor  # [L,n,2,9] sqrt-weighted, masked, maybe pose-scaled
    Jl: torch.Tensor  # [L,n,2,3] sqrt-weighted, masked, Jl-col-scaled
    r: torch.Tensor  # [L,n,2]
    Jl_scale: torch.Tensor  # [L,3] (1/(eps+||col||))


def linearize_bucket(cams: CamState, lm_p: torch.Tensor, bucket: BucketIndex,
                     robust_norm: int, huber_parameter: float,
                     use_valid_projections_only: bool):
    """Linearize one bucket over flat [O = L*n] component planes (the
    flat path's ops.planar.snavely_planes). Returns (LinBucket without
    the Jl scaling yet, number of numerical failures)."""
    from rootba_tpu_torch.ops.planar import robust_sqrt_weight, snavely_planes

    L, n = bucket.cam_idx.shape
    cam_planes = gather_cam_planes(packed_cam_table(cams),
                                   bucket.cam_idx.reshape(-1))
    X, Y, Z = _broadcast_lm(lm_p, n)
    res_u, res_v, valid, Jp_planes, Jl_planes = snavely_planes(
        *cam_planes, X, Y, Z, bucket.obs_uv[..., 0].reshape(-1),
        bucket.obs_uv[..., 1].reshape(-1))
    sw, use_mask = robust_sqrt_weight(
        res_u, res_v, valid, bucket.mask.reshape(-1), robust_norm,
        huber_parameter, use_valid_projections_only)
    # numerical validity over used slots (reference
    # landmark_block_base.ipp:120-125): any non-finite J/res is failure
    finite = torch.isfinite(res_u) & torch.isfinite(res_v)
    for v in Jp_planes + Jl_planes:
        finite = finite & torch.isfinite(v)
    num_failures = (use_mask & ~finite).sum()
    Jp = torch.stack([sw * v for v in Jp_planes],
                     dim=-1).reshape(L, n, 2, POSE_SIZE)
    Jl = torch.stack([sw * v for v in Jl_planes], dim=-1).reshape(L, n, 2, 3)
    r = torch.stack([sw * res_u, sw * res_v], dim=-1).reshape(L, n, 2)
    return LinBucket(Jp=Jp, Jl=Jl, r=r, Jl_scale=Jp.new_zeros(())), \
        num_failures


def scale_jl_cols(lin: LinBucket, jacobi_scaling_eps: float) -> LinBucket:
    """Landmark-Jacobian column scaling 1/(eps + ||col||) (reference
    landmark_block_base.ipp:572-587), per landmark over its 2n rows."""
    L, n = lin.Jl.shape[0], lin.Jl.shape[1]
    cols = lin.Jl.reshape(L, 2 * n, 3)
    scale = 1.0 / (jacobi_scaling_eps + torch.linalg.vector_norm(cols, dim=1))
    Jl = (cols * scale[:, None, :]).reshape(lin.Jl.shape)
    return lin._replace(Jl=Jl, Jl_scale=scale)


def jp_diag2(lin: LinBucket, cam_idx: torch.Tensor, num_cameras: int):
    """Per-camera column squared norms of Jp (add_Jp_diag2), as a
    segment sum."""
    contrib = torch.sum(lin.Jp * lin.Jp, dim=-2)  # [L,n,9]
    return segment_sum(contrib.reshape(-1, POSE_SIZE), cam_idx.reshape(-1),
                       num_cameras)


def jp_t_jp_blockdiag(lin: LinBucket, cam_idx: torch.Tensor,
                      num_cameras: int):
    """Per-camera 9x9 Gram blocks of Jp (add_Jp_T_Jp_blockdiag)."""
    blocks = torch.einsum("lnri,lnrj->lnij", lin.Jp, lin.Jp)
    return segment_sum(blocks.reshape(-1, POSE_SIZE, POSE_SIZE),
                       cam_idx.reshape(-1), num_cameras)


def scale_jp_cols(lin: LinBucket, cam_idx: torch.Tensor,
                  pose_scale: torch.Tensor) -> LinBucket:
    """Apply the per-camera jacobi scaling to the Jp columns
    (scale_Jp_cols, landmark_block_base.ipp:589-614)."""
    s = pose_scale[cam_idx]  # [L,n,9]
    return lin._replace(Jp=lin.Jp * s[..., None, :])
