#!/usr/bin/env python3
"""Sizes of BSR mode's block tables for the BAL "final" twins.

    python3 scripts/bsr_table_sizes.py [NAME ...] [--out OUT.json]

For each named twin (default: final3068 final4585 final13682) it
generates the seeded synthetic twin that chip_smoke.py would (seed 17,
pixel noise 1.0, benchmarks/scale_bench.py's sizes and covisibility
knobs), normalizes it and drops observations at depth < 0.1 (bench.py's
preprocessing without the 0.01 state perturbation, whose per-landmark
loop takes minutes at final-13682; the counts may differ from a solve's
by the few observations it moves across the filter), buckets it as the
solver does, collects the unique
camera pairs as pass 1 of bucketing.build_pair_stream does (bucket by
bucket, in row chunks, so that final-13682 fits the host), and builds
the BSR index (bucketing.build_bsr_matvec). It prints one JSON object
per twin: cameras, landmarks and observations after the filter, unique
pairs P, the index's entries E and run width, the packed run-major
table (E x 81) and the half table (P x 81) in GB for float32 and
float64, which regime bsr_pack_max_gb's default of 4 GB picks, and
whether the problem is above fused_obs_threshold (2M observations: the
host LM driver's route). For final3068 it also checks P against
build_pair_stream itself. Host work only: it needs no card, but
generates full-size problems (final-13682: 29M observations).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

# benchmarks/scale_bench.py's SIZES and STRUCTURE for final-13682,
# copied (nothing of the JAX package is imported); final3068 and
# final4585 are chip_smoke's twins
TWINS = dict(cs.TWINS)
TWINS["final13682"] = dict(num_cams=13682, num_lms=4456117,
                           num_obs=28987644, structure="clustered",
                           track_sigma=1.1, window_stretch=3.0, p_far=0.03,
                           max_window_frac=0.05)
PACK_MAX_GB = 4.0  # options.bsr_pack_max_gb's default
FUSED_OBS_THRESHOLD = 2_000_000  # options.fused_obs_threshold's default
CHUNK_ENTRIES = 1 << 26  # pair codes per chunk of bucket rows


def unique_pairs(buckets, N: int) -> np.ndarray:
    """Sorted unique pair codes min*N + max over every two valid slots
    of a landmark row: build_pair_stream's pass 1, chunked over rows."""
    uniques = []
    for b in buckets:
        L, n = b.cam_idx.shape
        if L == 0 or n < 2:
            continue
        iu, ju = np.triu_indices(n, k=1)
        step = max(1, CHUNK_ENTRIES // iu.size)
        for a in range(0, L, step):
            ci = b.cam_idx[a:a + step, iu].astype(np.int64)
            cj = b.cam_idx[a:a + step, ju].astype(np.int64)
            valid = b.mask[a:a + step, iu] & b.mask[a:a + step, ju]
            code = np.minimum(ci, cj) * N + np.maximum(ci, cj)
            uniques.append(np.unique(code[valid]))
            del ci, cj, valid, code
        uniques = [np.unique(np.concatenate(uniques))]
    return (np.unique(np.concatenate(uniques)) if uniques
            else np.zeros(0, np.int64))


def sizes(name: str) -> dict:
    from rootba_tpu_torch.bal.bucketing import (
        build_bsr_matvec,
        build_pair_stream,
        bucketize,
    )
    from rootba_tpu_torch.bal.synthetic import generate_synthetic_bal

    t = dict(TWINS[name])
    cams, lms, obs = t.pop("num_cams"), t.pop("num_lms"), t.pop("num_obs")
    secs = {}
    t0 = time.monotonic()
    p = generate_synthetic_bal(num_cams=cams, num_lms=lms,
                               mean_obs_per_lm=obs / lms, pixel_noise=1.0,
                               seed=17, **t)
    p.quiet = True
    secs["generate"] = time.monotonic() - t0
    t0 = time.monotonic()
    p.normalize(100.0)
    p.filter_obs(0.1)
    secs["preprocess"] = time.monotonic() - t0
    t0 = time.monotonic()
    bp = bucketize(p, pow2_from=9)
    secs["bucketize"] = time.monotonic() - t0
    N = p.num_cameras
    t0 = time.monotonic()
    code = unique_pairs(bp.buckets, N)
    secs["pairs"] = time.monotonic() - t0
    P = int(code.size)
    out = dict(name=name, cameras=N, landmarks=p.num_landmarks,
               observations=p.num_observations, pairs=P,
               pair_share=P / (N * (N - 1) / 2))
    if name == "final3068":
        ps = build_pair_stream(bp.buckets, N, grid_n=None, dense_grid=False)
        cs.check(int(ps.pair_row.size) == P
                 and np.array_equal(ps.pair_row.astype(np.int64) * N
                                    + ps.pair_col, code),
                 f"{name}: {ps.pair_row.size} pairs by build_pair_stream, "
                 f"{P} here")
        out["pairs_equal_build_pair_stream"] = True
    t0 = time.monotonic()
    bm = build_bsr_matvec((code // N).astype(np.int32),
                          (code % N).astype(np.int32), N)
    secs["bsr_index"] = time.monotonic() - t0
    E = int(bm.blk_idx.size)
    gb = {f"{k}_{dt}": n * 81 * s / 1e9
          for k, n in (("packed_gb", E), ("half_gb", P))
          for dt, s in (("f32", 4), ("f64", 8))}
    out.update(entries=E, width=int(bm.blk_idx.shape[1]), **gb,
               regime_f32=("packed" if E * 81 * 4 <= PACK_MAX_GB * (1 << 30)
                           else "half"),
               regime_f64=("packed" if E * 81 * 8 <= PACK_MAX_GB * (1 << 30)
                           else "half"),
               host_driver=p.num_observations > FUSED_OBS_THRESHOLD,
               host_seconds=secs)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("names", nargs="*",
                    default=["final3068", "final4585", "final13682"])
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    rows = []
    for name in args.names:
        rows.append(sizes(name))
        print(json.dumps(rows[-1]), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(rows, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
