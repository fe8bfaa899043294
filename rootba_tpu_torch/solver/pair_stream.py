"""The stream route's pair index (`PairStreamIndex`), built on the device
that the solve runs on.

bal.bucketing.build_pair_stream builds the same index on the host in
numpy and PairStreamIndex.from_host uploads it; that pair stays as the
plain twin the tests hold this build against. Here the same algorithm
runs in torch ops on the index's device, the CPU included, one
sub-stream at a time, and gives the same tensors (value, dtype and
shape), so the reducers sum in the same order and every solve repeats
bit for bit:

  1. the pair code min*N + max of every valid slot pair of each bucket's
     triu(n, 1) columns; a [N*N + 1] byte map of the codes present gives
     the P pairs in order (9.4 MB at 3,068 cameras);
  2. per sub-stream (the host's tiling, bucketing._stream_tiles, and its
     u16 rule), the slots sorted by code with a stable sort, their pair
     ids by searchsorted, the canonical swap applied;
  3. per bucket, the run width of the host's cost model over the
     sub-streams' per-pair slot counts;
  4. the slots padded to width-aligned runs of one pair and scattered
     straight into bucket-global slot ids ([R*W], fill L*n), the [R]
     pair of each run (pad P);
  5. where a pair has several runs, the sub-stream's run tree
     (bucketing.build_run_tree) in RunTreeIndex's layout;
  6. the dense block maps over grid_n.

Each sub-stream is sorted twice (its counts, then its runs) so that one
sub-stream's temporaries live at a time. The host reads sizes only, each
inside trace.sync("pair_stream"): the pair list's length and the slot
total, each bucket's per-sub-stream counts, each run tree's pass sizes,
and, once, the pair list itself (`PairList`, which the BSR index is
built from).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from rootba_tpu_torch.bal import bucketing
from rootba_tpu_torch.log import trace
from rootba_tpu_torch.solver.linearization import (
    PairStreamIndex,
    RunTreeIndex,
)

SYNC = "pair_stream"
# the host's candidate run widths, in the order its cost model tries them
_WIDTHS = (16, 8, 4, 2)
# per sub-stream statistics of _tile_stats: valid slots, distinct pairs,
# the largest pair's slots, then the runs at each of _WIDTHS
_M, _U, _MAXC, _RUNS = 0, 1, 2, 3


class PairList(NamedTuple):
    """Host copy of the index's pair list (int32, pair_row <= pair_col),
    from which the BSR index is built."""

    pair_row: np.ndarray
    pair_col: np.ndarray


class _Bucket(NamedTuple):
    L: int
    n: int
    cam: torch.Tensor  # [L, n] int64
    mask: torch.Tensor  # [L, n] bool
    iu: torch.Tensor  # [n(n-1)/2] first column of each slot pair
    ju: torch.Tensor  # second column


def _slot_codes(b: _Bucket, l0: int, l1: int, N: int):
    """Pair code min*N + max of every slot pair of landmark rows
    [l0, l1), raveled row-major over (row, pair) as the host ravels them,
    N*N (above every code) at invalid slots; and whether the first
    camera of each is the larger (the canonical swap)."""
    cam = b.cam[l0:l1]
    ci, cj = cam[:, b.iu], cam[:, b.ju]
    mask = b.mask[l0:l1]
    valid = mask[:, b.iu] & mask[:, b.ju]
    code = torch.where(valid, torch.minimum(ci, cj) * N
                       + torch.maximum(ci, cj), N * N)
    return code.reshape(-1), (ci > cj).reshape(-1)


def _groups(key: torch.Tensor, size: int, weight: torch.Tensor):
    """For a sorted key: each entry's group (a run of equal keys) and the
    [size] per-group sum of `weight`."""
    first = torch.ones_like(key, dtype=torch.bool)
    first[1:] = key[1:] != key[:-1]
    grp = torch.cumsum(first, 0) - 1
    cnt = key.new_zeros(size).index_add_(0, grp, weight)
    return grp, cnt


def _tile_stats(b: _Bucket, l0: int, l1: int, N: int) -> torch.Tensor:
    """[3 + len(_WIDTHS)] counts of one sub-stream (the order of _M,
    _U, _MAXC, _RUNS)."""
    code, _ = _slot_codes(b, l0, l1, N)
    code = torch.sort(code, stable=True).values
    valid = (code < N * N).long()
    _, cnt = _groups(code, code.numel(), valid)
    return torch.stack([valid.sum(), (cnt > 0).sum(), cnt.max()]
                       + [((cnt + w - 1) // w).sum() for w in _WIDTHS])


def _run_width(stats) -> int:
    """The host's cost model (bucketing.build_pair_stream): the width of
    least padded-gather plus run-scatter cost, the first on ties."""
    best_w, best_cost = None, None
    for k, w in enumerate(_WIDTHS):
        runs = sum(st[_RUNS + k] for st in stats)
        cost = runs * w * 2 + runs * 10
        if best_cost is None or cost < best_cost:
            best_cost, best_w = cost, w
    return best_w


def _run_tree(rstart: torch.Tensor, runs: torch.Tensor, target: torch.Tensor,
              max_runs: int) -> RunTreeIndex:
    """bucketing.build_run_tree of one sub-stream whose pair g owns the
    runs [rstart[g], rstart[g] + runs[g]) and has `target[g]`, as
    RunTreeIndex.from_host lays it out: int32 views of one tensor, the
    heads, their targets, then each pass's (dst, src)."""
    steps = []
    step = 1
    while max_runs > step:
        steps.append(step)
        step *= 2
    # ranks r = 2 k step with r + step < runs, per pair
    per = [torch.where(runs > s, (runs + s - 1) // (2 * s), 0)
           for s in steps]
    with trace.sync(SYNC):
        sizes = torch.stack([p.sum() for p in per]).tolist()
    parts = [rstart, target]
    for s, k_per, size in zip(steps, per, sizes):
        off = torch.cumsum(k_per, 0) - k_per
        k = torch.arange(size, device=runs.device) - torch.repeat_interleave(
            off, k_per, output_size=size)
        dst = torch.repeat_interleave(rstart, k_per, output_size=size) \
            + 2 * s * k
        parts += [dst, dst + s]
    views = torch.split(torch.cat(parts).to(torch.int32),
                        [p.numel() for p in parts])
    return RunTreeIndex(passes=tuple(zip(views[2::2], views[3::2])),
                        head=views[0], head_target=views[1])


def _sub_stream(b: _Bucket, s: int, rows_sub: int, st, unique: torch.Tensor,
                N: int, width: int, R: int):
    """One sub-stream's [R*width] bucket-global slot ids of both sides,
    and its [R] run pairs (pad P) or its run tree (None the other)."""
    P = unique.numel()
    dev = unique.device
    fill = b.L * b.n
    wi_out = torch.full((R * width,), fill, dtype=torch.int64, device=dev)
    wj_out = wi_out.clone()
    m, U = st[_M], st[_U]
    max_runs = -(-st[_MAXC] // width)
    if m == 0:
        return wi_out, wj_out, torch.full((R,), P, device=dev), None
    l0 = s * rows_sub
    code, swap = _slot_codes(b, l0, min(b.L, l0 + rows_sub), N)
    code, order = torch.sort(code, stable=True)
    code, order = code[:m], order[:m]  # the valid slots sort first
    pid = torch.searchsorted(unique, code)
    del code
    grp, cnt = _groups(pid, U, torch.ones_like(pid))
    gstart = torch.cumsum(cnt, 0) - cnt  # each pair's first sorted slot
    runs = (cnt + width - 1) // width
    rstart = torch.cumsum(runs, 0) - runs  # each pair's first run
    dst = (rstart * width - gstart)[grp] + torch.arange(m, device=dev)
    del grp, cnt
    # the slots' own columns, made bucket-global, canonical side first
    npairs = b.iu.numel()
    row, col = order // npairs, order % npairs
    base = (row + l0) * b.n
    oi, oj = base + b.iu[col], base + b.ju[col]
    sw = swap[order]
    del row, col, base, order, swap
    wi_out[dst] = torch.where(sw, oj, oi)
    wj_out[dst] = torch.where(sw, oi, oj)
    del oi, oj, sw, dst
    target = pid[gstart]
    if max_runs > 1:
        return wi_out, wj_out, None, _run_tree(rstart, runs, target,
                                               max_runs)
    # one run per pair: the runs are the pairs, in order
    run_pair = torch.full((R,), P, device=dev)
    run_pair[:U] = target
    return wi_out, wj_out, run_pair, None


def build_pair_stream_index(buckets, num_cameras: int, device,
                            grid_n: Optional[int] = None,
                            dense_grid: bool = True,
                            slot_cap: int = 196_608
                            ) -> Tuple[PairStreamIndex, PairList]:
    """PairStreamIndex.from_host(bucketing.build_pair_stream(buckets,
    num_cameras, grid_n=grid_n, dense_grid=dense_grid, slot_cap=slot_cap),
    buckets, device),
    built on `device` from the host buckets' cam_idx and mask (uploaded
    once), and the host copy of its pair list."""
    N = num_cameras
    G = grid_n if grid_n is not None else N
    bks = {}
    for bi, b in enumerate(buckets):
        L, n = b.cam_idx.shape
        if L == 0 or n < 2:
            continue
        iu, ju = torch.triu_indices(n, n, 1, device=device)
        bks[bi] = _Bucket(
            L, n, torch.as_tensor(b.cam_idx, device=device).long(),
            torch.as_tensor(b.mask, device=device), iu, ju)

    def tiles(b: _Bucket, cap: int):
        rows = bucketing._stream_tiles(b.L, b.n, cap, b.iu.numel())
        return rows, [(l0, min(b.L, l0 + rows))
                      for l0 in range(0, b.L, rows)]

    # pass 1: the pairs present, and the slot total of the u16 rule
    present = torch.zeros(N * N + 1, dtype=torch.bool, device=device)
    total = torch.zeros((), dtype=torch.int64, device=device)
    for b in bks.values():
        for l0, l1 in tiles(b, slot_cap)[1]:
            code, _ = _slot_codes(b, l0, l1, N)
            present.index_fill_(0, code, True)  # no host scalar to copy
            total += (code < N * N).sum()
            del code
    with trace.sync(SYNC):
        unique = torch.nonzero(present[:N * N]).reshape(-1)
    del present
    P = unique.numel()
    with trace.sync(SYNC):
        total_slots = int(total)
    # the host's u16 tables: smaller sub-streams (the device copies are
    # int64 either way)
    if total_slots > bucketing._U16_SLOT_THRESHOLD and slot_cap > 65_535:
        slot_cap = 65_535

    widths, stream_bucket, rows_subs = [], [], []
    wi_idx, wj_idx, run_pair, run_tree = [], [], [], []
    for bi, b in bks.items():
        rows_sub, bounds = tiles(b, slot_cap)
        stats = torch.stack([_tile_stats(b, l0, l1, N)
                             for l0, l1 in bounds])
        with trace.sync(SYNC):
            stats = stats.tolist()
        bw = _run_width(stats)
        k = _WIDTHS.index(bw)
        R = max([st[_RUNS + k] for st in stats] + [1])
        subs = [_sub_stream(b, s, rows_sub, st, unique, N, bw, R)
                for s, st in enumerate(stats)]
        widths.append(bw)
        stream_bucket.append(bi)
        rows_subs.append(rows_sub)
        wi_idx.append(tuple(x[0] for x in subs))
        wj_idx.append(tuple(x[1] for x in subs))
        run_pair.append(tuple(x[2] for x in subs))
        run_tree.append(tuple(x[3] for x in subs))

    rows, cols = unique // N, unique % N
    if dense_grid:
        ids = torch.arange(P, device=device)
        up_idx = torch.full((G * G,), P, device=device)
        up_idx[rows * G + cols] = ids
        lo_idx = torch.full((G * G,), P, device=device)
        lo_idx[cols * G + rows] = ids
    else:
        up_idx = lo_idx = torch.zeros(0, dtype=torch.int64, device=device)
    with trace.sync(SYNC):
        host = torch.stack([rows, cols]).to(torch.int32).cpu().numpy()
    index = PairStreamIndex(
        widths=tuple(widths), stream_bucket=tuple(stream_bucket),
        rows_sub=tuple(rows_subs), wi_idx=tuple(wi_idx),
        wj_idx=tuple(wj_idx), run_pair=tuple(run_pair),
        run_tree=tuple(run_tree), pair_row=rows, pair_col=cols,
        up_idx=up_idx, lo_idx=lo_idx)
    return index, PairList(pair_row=host[0], pair_col=host[1])
