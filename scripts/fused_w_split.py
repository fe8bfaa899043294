#!/usr/bin/env python3
"""Where stage2's time goes on the final-4585 twin in float64, on the
card: the BSR half table against the packed table, and the fused-W
stream factors (W rows built after each slot gather, by K2 or by the
plain elementwise build) against W tables built once by K2.

    python3 scripts/fused_w_split.py [--reps 3] [--out OUT.json]

Writes the twin (chip_smoke.py's TWINS["final4585"], seed 17, bench.py's
preprocessing) as an .npz, builds one float64 linearizer with the
default options (BSR mode, the half table: the packed table is over
bsr_pack_max_gb) and linearizes once at the initial state. Then it runs
stage2 at lambda 1e-4 in each variant (fused-W forced on or off through
sqrt_flat._FUSED_W_MIN_BYTES), one untimed call and `reps` timed
ones (device time between CUDA events around the call, the queue
drained before it), and prints each variant's median and its peak
device memory above what the linearization holds. Each variant's table
is held against the first variant's of the same regime within 1e-12 of
its largest entry (not bit for bit: `index_add_` adds the run rows in
an order that varies on the card; phase 2 of chip_smoke.py holds the
fused-W rows themselves to the CPU's bit for bit). One JSON object at
the end, also written to OUT.json when given.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

# (name, packed table?, W factors: "k2" rows, "plain" rows or "tables")
VARIANTS = (("half_fused_k2", False, "k2"),
            ("half_fused_plain", False, "plain"),
            ("half_tables", False, "tables"),
            ("packed_tables", True, "tables"),
            ("packed_fused_k2", True, "k2"))


def _plain_rows(table, idx):
    """_gather_slot_rows with the W rows built by K2's plain twin."""
    from rootba_tpu_torch.ops import fold

    if isinstance(table, tuple):
        q6, jp18 = table
        return fold.w_build_plain(q6[idx], jp18[idx], 1)
    return table[idx]


def main() -> int:
    import torch

    from rootba_tpu_torch.bal.bucketing import bucketize
    from rootba_tpu_torch.bal.problem import load_normalized_bal_problem
    from rootba_tpu_torch.cli.common import parse_bal_app_arguments
    from rootba_tpu_torch.ops import kernels
    from rootba_tpu_torch.solver import linearization, sqrt_flat
    from rootba_tpu_torch.solver.lm import create_linearizer, initial_state

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("fused_w_split: no CUDA device available", file=sys.stderr)
        return 2
    cs.WORK.mkdir(parents=True, exist_ok=True)
    kernels.build_all()
    dev = torch.device("cuda")
    big = cs.write_twin("final4585", npz=True)
    options = parse_bal_app_arguments("fused_w_split", [
        "--input", str(big), "--quiet", *cs.PREPROCESS])[0]
    problem = load_normalized_bal_problem(options.dataset)
    opts = options.solver
    opts.use_double = True
    t = time.monotonic()
    bp = bucketize(problem, pow2_from=opts.bucket_pow2_from)
    lin = create_linearizer(bp, opts, torch.float64, dev)
    setup_s = time.monotonic() - t
    st = initial_state(bp, torch.float64, dev)
    lins, _, _ = lin.stage1(st.cams, st.lm_ps)
    lam = torch.full((), 1e-4, dtype=torch.float64, device=dev)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    res = {"card": cs.smi_line(), "twin": "final4585", "dtype": "float64",
           "setup_s": setup_s, "default_packed": not lin.bsr_sym,
           "variants": {}}
    ref = {}
    for name, packed, w in VARIANTS:
        lin.bsr_sym = not packed
        with contextlib.ExitStack() as stack:
            stack.enter_context(cs.patched(sqrt_flat, _FUSED_W_MIN_BYTES=(
                1 << 62 if w == "tables" else 0)))
            if w == "plain":
                stack.enter_context(cs.patched(
                    linearization, _gather_slot_rows=_plain_rows))
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            kernels.reset_launches()
            table = lin.stage2(lins, lam)[1][0]
            torch.cuda.synchronize()
            launches = dict(kernels.LAUNCHES)
            peak = torch.cuda.max_memory_allocated() - held
            ms = []
            for _ in range(args.reps):
                del table
                torch.cuda.synchronize()
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                table = lin.stage2(lins, lam)[1][0]
                b.record()
                b.synchronize()
                ms.append(a.elapsed_time(b))
        # the reference tables wait in host memory, out of the next
        # variants' peaks
        table = table.cpu()
        regime = "packed" if packed else "half"
        if regime not in ref:
            ref[regime] = (name, table, float(table.abs().max()))
        rel = float((table - ref[regime][1]).abs().max()) / ref[regime][2]
        cs.check(rel < 1e-12, f"{name}: table {rel} from {ref[regime][0]}")
        del table
        v = dict(median_ms=statistics.median(ms), ms=ms,
                 peak_mib_above_held=peak / 2**20, launches=launches,
                 rel_diff_to=[ref[regime][0], rel])
        res["variants"][name] = v
        print(f"{name}: stage2 {v['median_ms']:.3f} ms (median of "
              f"{[round(x, 3) for x in ms]}), peak {peak / 2**20:.1f} MiB "
              f"above the {held / 2**20:.1f} MiB held, launches "
              f"{launches}, max abs diff to {ref[regime][0]} {rel:.3e} of "
              f"its largest entry", flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(res, indent=1))
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
