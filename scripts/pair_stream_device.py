#!/usr/bin/env python3
"""The stream route's pair index built on the card against its host
build, at the benchmark's twins, on one card.

    python3 scripts/pair_stream_device.py OUT.json [--reps K]

For trafalgar-257 (dense; and padded to K3's 384-camera grid, as
pallas_cg="on" builds it) and final-3068 (BSR), loaded as the benchmark
loads them (portbench's twin and configuration, the file in its own
order), it bucketizes once, then:

  * builds the index K times through build_pair_index(..., "stream")
    with the span recorder on: the wall of each build (ended by a
    synchronize), its prep.build.pair_stream and prep.build.cam_stream
    spans, its sync.pair_stream reads, and the transient device peak
    above what was allocated before (torch.cuda.max_memory_allocated
    after reset_peak_memory_stats) beside the index's resident bytes;
  * builds it K times the old way, bucketing.build_pair_stream on the
    host then PairStreamIndex.from_host: the host seconds and the upload;
  * holds the two tensor for tensor (value, dtype, shape of every
    field, and the host pair list).

Writes OUT.json and prints one line per case. Needs the card.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from portbench import twin  # noqa: E402

# case: (configuration file, build_pair_index arguments)
CASES = {
    "traf257.dense": ("bal-trafalgar-257", dict(grid_n=None,
                                               dense_grid=True)),
    "traf257.k3_grid": ("bal-trafalgar-257", dict(grid_n=384,
                                                 dense_grid=True)),
    "final3068.bsr": ("bal-final-3068", dict(grid_n=None,
                                            dense_grid=False)),
}


def differences(got, ref, what="") -> list:
    """The fields where two PairStreamIndex values differ."""
    from rootba_tpu_torch.solver.linearization import RunTreeIndex

    if isinstance(ref, torch.Tensor):
        same = (isinstance(got, torch.Tensor) and got.dtype == ref.dtype
                and got.shape == ref.shape and torch.equal(got, ref))
        return [] if same else [what]
    if ref is None or got is None:
        return [] if got is ref else [what]
    if isinstance(ref, RunTreeIndex):
        return (differences(got.head, ref.head, what + ".head")
                + differences(got.head_target, ref.head_target,
                              what + ".head_target")
                + differences(got.passes, ref.passes, what + ".passes"))
    if isinstance(ref, tuple):
        if not isinstance(got, tuple) or len(got) != len(ref):
            return [what]
        return [d for k, (g, r) in enumerate(zip(got, ref))
                for d in differences(g, r, f"{what}[{k}]")]
    return [] if got == ref else [what]


def load(config: str, path: Path):
    from rootba_tpu_torch.bal.problem import load_normalized_bal_problem
    from rootba_tpu_torch.config.options import BalDatasetOptions

    conf = json.loads((ROOT / "portbench" / "configs"
                       / f"{config}.json").read_text())
    tw = twin.generate(conf["num_cams"], conf["num_lms"], conf["num_obs"],
                       conf["twin_seed"], **conf["twin"])
    twin.write_bal(tw, str(path), order_seed=1)
    ds = BalDatasetOptions()
    for k, v in dict(conf["dataset"], input=str(path), quiet=True).items():
        setattr(ds, k, v)
    return load_normalized_bal_problem(ds)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("out")
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")

    from rootba_tpu_torch.bal import bucketing
    from rootba_tpu_torch.config.options import SolverOptions
    from rootba_tpu_torch.log import trace
    from rootba_tpu_torch.solver import linearization as tlz
    from rootba_tpu_torch.solver.lm import pad_rows_for_mesh
    from rootba_tpu_torch.utils.device import resolve_device

    dev = resolve_device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    out = {"card": card.strip(), "torch": torch.__version__, "cases": {}}
    work = ROOT / "build" / "pair_stream_device"
    work.mkdir(parents=True, exist_ok=True)
    problems = {}
    for name, (config, kw) in CASES.items():
        if config not in problems:
            problems.clear()
            problem = load(config, work / f"{config}.txt")
            problems[config] = bucketing.bucketize(
                problem, pow2_from=SolverOptions().bucket_pow2_from,
                row_align=pad_rows_for_mesh(1))
        bp = problems[config]
        N = bp.num_cameras
        row = {}

        def build():
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            trace.start()
            t0 = time.monotonic()
            pairs, cams, host = tlz.build_pair_index(
                bp.buckets, N, "stream", dev, **kw)
            torch.cuda.synchronize()
            wall = time.monotonic() - t0
            spans, counters = trace.stop()
            sec = {}
            for s in spans:
                sec[s[0]] = sec.get(s[0], 0.0) + s[2] - s[1]
            return (pairs, host, wall, sec, counters,
                    torch.cuda.max_memory_allocated() - base,
                    torch.cuda.memory_allocated() - base)

        build()  # first use of each op on the card
        runs = [build() for _ in range(args.reps)]
        pairs, host = runs[-1][0], runs[-1][1]
        row["device_build_index_s"] = [r[2] for r in runs]
        row["device_pair_stream_s"] = [r[3]["prep.build.pair_stream"]
                                       for r in runs]
        row["device_cam_stream_s"] = [r[3]["prep.build.cam_stream"]
                                      for r in runs]
        row["sync_pair_stream"] = [r[4].get("sync.pair_stream")
                                   for r in runs]
        row["sync_pair_stream_s"] = [r[3].get("sync.pair_stream")
                                     for r in runs]
        row["peak_above_base_bytes"] = [r[5] for r in runs]
        row["resident_after_bytes"] = [r[6] for r in runs]
        del runs

        host_s, up_s = [], []
        for _ in range(args.reps):
            t0 = time.monotonic()
            hps = bucketing.build_pair_stream(bp.buckets, N, **kw)
            t1 = time.monotonic()
            ref = tlz.PairStreamIndex.from_host(hps, bp.buckets, dev)
            torch.cuda.synchronize()
            host_s.append(t1 - t0)
            up_s.append(time.monotonic() - t1)
        row["host_build_s"] = host_s
        row["host_upload_s"] = up_s
        diff = [d for f in tlz.PairStreamIndex.__dataclass_fields__
                for d in differences(getattr(pairs, f), getattr(ref, f), f)]
        for f in ("pair_row", "pair_col"):
            a, b = getattr(host, f), getattr(hps, f)
            if a.dtype != b.dtype or not np.array_equal(a, b):
                diff.append("host." + f)
        row["differences"] = diff[:20]
        row["equal"] = not diff
        row["pairs"] = pairs.num_pairs
        row["stacks"] = len(pairs.widths)
        row["sub_streams"] = sum(len(s) for s in pairs.wi_idx)
        row["trees"] = sum(t is not None for st in pairs.run_tree
                           for t in st)
        row["index_entries"] = sum(
            x.numel() for side in (pairs.wi_idx, pairs.wj_idx)
            for st in side for x in st)
        out["cases"][name] = row
        print(json.dumps({name: {
            k: (statistics.median(v) if isinstance(v, list) and v
                and isinstance(v[0], (int, float)) else v)
            for k, v in row.items()}}), flush=True)
        del pairs, host, ref, hps
        torch.cuda.empty_cache()
    for p in work.glob("*.txt"):
        p.unlink()
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(out, indent=1))
    print(json.dumps({"ok": all(c["equal"] for c in out["cases"].values()),
                      "card": out["card"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
