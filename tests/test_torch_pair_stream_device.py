"""The stream route's pair index built on the device
(solver.pair_stream.build_pair_stream_index), here on the CPU, held
tensor for tensor to its host twin, the numpy build uploaded
(PairStreamIndex.from_host(bucketing.build_pair_stream(...))): value,
dtype and shape of every field, and the host pair list that the BSR
index reads. Then whole solves, dense and BSR, whose per-iteration costs
equal bit for bit those of solves on the host build. Needs no JAX.
"""

import copy

import numpy as np
import pytest
import torch

from rootba_tpu_torch.bal import bucketing
from rootba_tpu_torch.bal.synthetic import generate_synthetic_bal
from rootba_tpu_torch.config.options import SolverOptions
from rootba_tpu_torch.log.summary import SolverSummary
from rootba_tpu_torch.solver import linearization as tlz
from rootba_tpu_torch.solver import pair_stream
from rootba_tpu_torch.solver import sqrt_flat
from rootba_tpu_torch.solver.lm import bundle_adjust

torch.set_num_threads(1)

CPU = torch.device("cpu")


def _problem(num_cams, num_lms, mean_obs, seed):
    p = generate_synthetic_bal(num_cams=num_cams, num_lms=num_lms,
                               mean_obs_per_lm=mean_obs, seed=seed)
    p.normalize(100.0)
    p.perturb(0.0, 0.01, 0.01, 38401)
    p.filter_obs(0.1)
    return p


def _buckets(num_cams, num_lms, mean_obs, seed):
    return bucketing.bucketize(_problem(num_cams, num_lms, mean_obs,
                                        seed)).buckets


def _with_edge_buckets(buckets):
    """The buckets, the first with 24 fully masked rows appended (row
    padding: with few rows per sub-stream, trailing sub-streams without
    a slot), then a bucket with no rows and one with one obs column,
    which build no stack."""
    b = buckets[0]
    L, n = b.cam_idx.shape
    pad = dict(
        obs_uv=np.concatenate([b.obs_uv, np.zeros((24, n, 2))]),
        cam_idx=np.concatenate([b.cam_idx, np.zeros((24, n), np.int32)]),
        mask=np.concatenate([b.mask, np.zeros((24, n), bool)]),
        lm_mask=np.concatenate([b.lm_mask, np.zeros(24, bool)]),
        lm_id=np.concatenate([b.lm_id, np.full(24, -1, np.int32)]))
    empty = bucketing.Bucket(
        n_obs=3, num_real=0, obs_uv=np.zeros((0, 3, 2)),
        cam_idx=np.zeros((0, 3), np.int32), mask=np.zeros((0, 3), bool),
        lm_mask=np.zeros(0, bool), lm_id=np.zeros(0, np.int32))
    single = bucketing.Bucket(
        n_obs=1, num_real=8, obs_uv=np.zeros((8, 1, 2)),
        cam_idx=np.arange(8, dtype=np.int32)[:, None],
        mask=np.ones((8, 1), bool), lm_mask=np.ones(8, bool),
        lm_id=np.arange(8, dtype=np.int32))
    return (b._replace(**pad),) + tuple(buckets[1:]) + (empty, single)


def _wide_bucket(L, n, num_cams, seed):
    """One bucket of L landmark rows, each seen by n distinct cameras of
    num_cams, and the last slot of every third row masked."""
    rng = np.random.default_rng(seed)
    cam = np.argsort(rng.random((L, num_cams)), axis=1)[:, :n]
    mask = np.ones((L, n), bool)
    mask[::3, -1] = False
    return (bucketing.Bucket(
        n_obs=n, num_real=L, obs_uv=np.zeros((L, n, 2)),
        cam_idx=cam.astype(np.int32), mask=mask, lm_mask=np.ones(L, bool),
        lm_id=np.arange(L, dtype=np.int32)),)


# name: (cameras, the buckets, builder arguments, module globals of
# bucketing to set, extra checks)
CASES = {
    "dense_grid_padded": (12, lambda: _buckets(12, 200, 4.5, 3),
                          dict(grid_n=16), {}, {}),
    "bsr": (12, lambda: _buckets(12, 200, 4.5, 3), dict(dense_grid=False),
            {}, {}),
    "dense_unpadded": (20, lambda: _buckets(20, 600, 6.0, 4), dict(), {},
                       {}),
    # a small slot cap: many sub-streams per bucket, most without a tree
    "slot_cap": (20, lambda: _buckets(20, 600, 6.0, 4), dict(slot_cap=48),
                 {}, dict(min_subs=40, trees_and_pairs=True)),
    # the tiling forced, independent of the slot cap
    "tiles_forced": (20, lambda: _buckets(20, 600, 6.0, 4),
                     dict(dense_grid=False),
                     {"_stream_tiles": lambda L, n, cap, hint: 7},
                     dict(min_subs=40)),
    # few cameras, many landmarks: pairs with several runs in one
    # sub-stream, trees of several passes
    "run_trees": (6, lambda: _buckets(6, 800, 4.0, 5), dict(grid_n=8), {},
                  dict(min_passes=3)),
    "edge_buckets": (12, lambda: _with_edge_buckets(
        _buckets(12, 200, 4.5, 3)), dict(slot_cap=30), {},
        dict(edge=True, empty_subs=True)),
    # the u16 rule: above _U16_SLOT_THRESHOLD pair slots the slot cap
    # drops to 65,535, which splits this bucket's 96,000 slots in two
    "u16_tiling": (10, lambda: _wide_bucket(12_000, 8, 10, 6),
                   dict(dense_grid=False), {"_U16_SLOT_THRESHOLD": 0},
                   dict(u16=True)),
}


def _equal(got, ref, what):
    if isinstance(ref, torch.Tensor):
        assert isinstance(got, torch.Tensor), what
        assert got.dtype == ref.dtype, (what, got.dtype, ref.dtype)
        assert got.shape == ref.shape, (what, got.shape, ref.shape)
        assert torch.equal(got, ref), what
    elif ref is None:
        assert got is None, what
    elif isinstance(ref, tlz.RunTreeIndex):
        assert isinstance(got, tlz.RunTreeIndex), what
        _equal(got.head, ref.head, what + ".head")
        _equal(got.head_target, ref.head_target, what + ".head_target")
        _equal(got.passes, ref.passes, what + ".passes")
    elif isinstance(ref, tuple):
        assert isinstance(got, tuple) and len(got) == len(ref), what
        for k, (g, r) in enumerate(zip(got, ref)):
            _equal(g, r, f"{what}[{k}]")
    else:
        assert type(got) is type(ref) and got == ref, (what, got, ref)


@pytest.mark.parametrize("case", sorted(CASES))
def test_device_build_equals_host_build(case, monkeypatch):
    cams, make_buckets, kw, globs, checks = CASES[case]
    for name, value in globs.items():
        monkeypatch.setattr(bucketing, name, value)
    buckets = make_buckets()
    host = bucketing.build_pair_stream(buckets, cams, **kw)
    ref = tlz.PairStreamIndex.from_host(host, buckets, CPU)
    got, pairs = pair_stream.build_pair_stream_index(buckets, cams, CPU,
                                                     **kw)
    for field in tlz.PairStreamIndex.__dataclass_fields__:
        _equal(getattr(got, field), getattr(ref, field), field)
    for name in ("pair_row", "pair_col"):
        a, b = getattr(pairs, name), getattr(host, name)
        assert a.dtype == b.dtype == np.int32 and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)

    # the case reaches what it is there for
    P = got.num_pairs
    assert P > 0
    subs = sum(len(s) for s in got.wi_idx)
    trees = [t for st in got.run_tree for t in st if t is not None]
    assert subs >= checks.get("min_subs", 1)
    if checks.get("trees_and_pairs"):
        assert trees and any(r is not None for st in got.run_pair
                             for r in st)
    if "min_passes" in checks:
        assert max(len(t.passes) for t in trees) >= checks["min_passes"]
    if checks.get("edge"):
        assert len(got.stream_bucket) == len(buckets) - 2
    if checks.get("empty_subs"):
        fill = buckets[0].cam_idx.size
        assert bool((got.wi_idx[0][-1] == fill).all())
        assert bool((got.run_pair[0][-1] == P).all())
    if checks.get("u16"):
        assert host.wi_idx[0].dtype == np.uint16
        assert got.rows_sub == (65_535 // 8,) and len(got.wi_idx[0]) == 2
        for rows_sub, bi in zip(got.rows_sub, got.stream_bucket):
            assert rows_sub * buckets[bi].cam_idx.shape[1] <= 65_535
    if kw.get("dense_grid", True):
        G = kw.get("grid_n") or cams
        assert got.up_idx.shape == (G * G,)


def _host_build_pair_index(buckets, num_cameras, pair_gather, device,
                           min_group=16384, grid_n=None, dense_grid=True):
    """build_pair_index's stream route as it was: the numpy build, then
    the upload."""
    assert pair_gather == "stream"
    host = bucketing.build_pair_stream(buckets, num_cameras, grid_n=grid_n,
                                       dense_grid=dense_grid)
    cams = tlz.CamStreamIndex.from_host(
        bucketing.build_cam_stream(buckets, num_cameras), buckets, device)
    return tlz.PairStreamIndex.from_host(host, buckets, device), cams, host


@pytest.mark.parametrize("mode", ["dense", "bsr"])
def test_solve_on_the_device_build_repeats_the_host_builds(mode,
                                                           monkeypatch):
    """Per-iteration costs and CG counts of an f32 solve on the device
    build equal, bit for bit, those of the same solve on the host build;
    the dense f32 route pads the block maps to K3's grid."""
    problem = _problem(12, 200, 4.5, 3)
    options = SolverOptions(verbosity_level=0, max_num_iterations=4,
                            use_double=False, pair_gather="stream")
    if mode == "bsr":
        options.dense_rcs_max_cameras = 0
    calls = []
    real = pair_stream.build_pair_stream_index

    def spy(*a, **kw):
        calls.append(kw)
        return real(*a, **kw)

    def run():
        summary = SolverSummary()
        bundle_adjust(copy.deepcopy(problem), copy.deepcopy(options),
                      summary, device="cpu")
        return [(it.cost.all.error, it.cost.valid.error,
                 it.linear_solver_iterations) for it in summary.iterations]

    monkeypatch.setattr(pair_stream, "build_pair_stream_index", spy)
    new = run()
    assert len(calls) == 1
    if mode == "dense":
        assert calls[0]["grid_n"] is not None
    else:
        assert calls[0]["dense_grid"] is False
    monkeypatch.setattr(sqrt_flat, "build_pair_index",
                        _host_build_pair_index)
    old = run()
    assert len(calls) == 1
    assert len(new) == 5 and new == old
