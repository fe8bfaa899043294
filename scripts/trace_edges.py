#!/usr/bin/env python3
"""How often a torch.profiler trace of K3 launches loses some, with and
without a margin of host time at the edges of the traced step.

    python3 scripts/trace_edges.py [OUT.json]

chip_smoke.device_ms traces a warm-up step and a measured step of 20
calls each. The profiler keeps a kernel only if the card's timestamps of
its start and end fall inside the step on the host clock; where those
timestamps sit off the host clock, the launches next to an edge are
lost. This script takes TRACES traces of 20 calls each of three K3
launches on chip_smoke.spd_system(N, 128, seed N) -- the full-row
cluster kernel at N = 49 with 0 CG iterations (about 8 us, so host
bound), the half kernel at N = 126 with 46 fixed iterations and the grid
kernel on the same system (about 0.4 and 0.5 ms) -- once with no margin
and once with chip_smoke.TRACE_MARGIN_S at both edges of each step, in
turns, and prints the launches per call each trace holds. Prints one
JSON object, and writes it to OUT.json when given.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

TRACES = 12


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("trace_edges: no CUDA device available", file=sys.stderr)
        return 2
    from rootba_tpu_torch.ops import cg_dense, kernels
    from rootba_tpu_torch.ops.block9 import chol9

    out_path = Path(sys.argv[1]).resolve() if len(sys.argv) > 1 else None
    kernels.build_all()
    dev = torch.device("cuda")
    cases = {}
    for N, kernel, iters in ((49, "cluster", 0), (126, "half", 46),
                             (126, "grid", 46)):
        Hz, blocks, b = cs.spd_system(N, 128, seed=N)
        Hz = torch.as_tensor(Hz, device=dev)
        Lp = cg_dense.chol_planes(chol9(torch.as_tensor(blocks, device=dev)),
                                  128)
        b2 = torch.zeros((9, 128), device=dev)
        b2[:, :N] = torch.as_tensor(b, device=dev).T
        kw = dict(min_iters=0, max_iters=iters, q_tol=float("-inf"),
                  r_tol=-1.0, reset_period=10)
        if kernel == "grid":
            fn = (lambda Hz=Hz, b2=b2, Lp=Lp, kw=kw, N=N:
                  cg_dense._launch_grid(Hz, b2, Lp, N, **kw))
        else:
            fn = (lambda Hz=Hz, b2=b2, Lp=Lp, kw=kw, N=N, kernel=kernel:
                  cg_dense._launch_in_cluster(kernel, Hz, b2, Lp, N, **kw))
        cases[f"{kernel} N={N} iters={iters}"] = (
            fn, cs.KERNEL_NAMES[f"pcg_dense_{kernel}"])
    res = {"card": cs.smi_line(), "traces": TRACES, "calls": 20,
           "margin_s": cs.TRACE_MARGIN_S, "cases": {}}
    for tag, (fn, name) in cases.items():
        fn()
        torch.cuda.synchronize()
        seen = {0.0: [], cs.TRACE_MARGIN_S: []}
        ms = {0.0: [], cs.TRACE_MARGIN_S: []}
        for _ in range(TRACES):
            for margin in seen:
                t, names = cs.device_ms(fn, 20, margin)
                per_call = sum(v for k, v in names.items() if name in k)
                seen[margin].append(per_call)
                if per_call == 1.0:
                    ms[margin].append(t)
        row = {}
        for margin, counts in seen.items():
            row[f"margin_{margin:g}"] = dict(
                launches_per_call=counts,
                whole_traces=sum(c == 1.0 for c in counts),
                ms_of_whole=ms[margin])
        res["cases"][tag] = row
        print(f"{tag}: " + "; ".join(
            f"margin {m:g} s: {r['whole_traces']}/{TRACES} traces whole, "
            f"launches per call {r['launches_per_call']}"
            for m, r in zip(seen, row.values())), flush=True)
    line = json.dumps(res)
    print(line)
    if out_path is not None:
        out_path.write_text(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
