#!/usr/bin/env python3
"""Host seconds of the pair and camera index builders at the final-3068
twin, and one float32 LM iteration with strip_min_group=0 on the card.

    python3 scripts/strips_build.py [OUT.json]

Loads and bucketizes chip_smoke's final-3068 twin as the CLI does,
then times, one after the other, the stream, strips (min_group 16384,
the auto value there, and 0), obs and BSR index builders of
bal/bucketing.py and the device uploads of the strips indices
(linearization.PairStripsIndex / CamStripsIndex, which collapse each
bucket's groups into one slot list). Then solves one f32 LM iteration
with pair_gather="strips", strip_min_group=0 on the card on the same
builds (BSR, packed table) and prints its seconds per iteration, stage2
time and peak device memory. Host work is full size: run it on the
card's machine.
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def main(argv) -> int:
    import torch

    import chip_smoke as cs
    from rootba_tpu_torch.bal import bucketing
    from rootba_tpu_torch.solver import linearization as lz

    if not torch.cuda.is_available():
        print("strips_build: no CUDA device available", file=sys.stderr)
        return 2
    cs.WORK.mkdir(parents=True, exist_ok=True)
    smi = cs.smi_line()
    setup = cs.SharedSetup(cs.write_twin("final3068"))
    bp = setup.bp
    N = bp.num_cameras
    out = dict(card=smi, load_s=setup.load_s, bucketize_s=setup.bucketize_s,
               observations=bp.num_observations)

    def timed(name, fn):
        t = time.monotonic()
        v = fn()
        out[name] = time.monotonic() - t
        print(f"[strips_build] {name}: {out[name]:.3f} s", flush=True)
        return v

    with setup:  # the solve below reuses these builds
        timed("pair_stream_s", lambda: bucketing.build_pair_stream(
            bp.buckets, N, grid_n=None, dense_grid=False))
        timed("cam_stream_s", lambda: bucketing.build_cam_stream(
            bp.buckets, N))
        for mg in (16384, 0):
            ps = timed(f"pair_strips_{mg}_s",
                       lambda: bucketing.build_pair_strips(
                           bp.buckets, N, min_group=mg, grid_n=None,
                           dense_grid=False))
            cs_ = timed(f"cam_strips_{mg}_s",
                        lambda: bucketing.build_cam_strips(
                            bp.buckets, N, min_group=mg))
            out[f"pair_groups_{mg}"] = len(ps.group_bucket)
            out[f"pair_slots_{mg}"] = int(
                sum(x.size for x in ps.lm_idx) + ps.wi_idx.size)
            out[f"leftover_runs_{mg}"] = int(ps.wi_idx.shape[0])
            out[f"cam_groups_{mg}"] = len(cs_.group_bucket)
            dev = torch.device("cuda")
            timed(f"pair_strips_{mg}_upload_s",
                  lambda: lz.PairStripsIndex.from_host(ps, bp.buckets, dev))
            timed(f"cam_strips_{mg}_upload_s",
                  lambda: lz.CamStripsIndex.from_host(cs_, bp.buckets,
                                                      dev))
            ps = cs_ = None
        pc = timed("pair_csr_s", lambda: bucketing.build_pair_csr(
            bp.buckets, N, grid_n=None, dense_grid=False))
        out["obs_csr_rows"] = int(pc.wi_idx.shape[0])
        timed("bsr_matvec_s", lambda: bucketing.build_bsr_matvec(
            pc.pair_row, pc.pair_col, N))
        pc = None
    torch.cuda.empty_cache()
    _, r = cs.timed_path("strips_build strips0 f32", lambda: setup.solve(
        pair_gather="strips", strip_min_group=0, max_num_iterations=1))
    out["strips0_solve"] = r
    print(json.dumps(out))
    if len(argv) > 1:
        Path(argv[1]).parent.mkdir(parents=True, exist_ok=True)
        Path(argv[1]).write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
