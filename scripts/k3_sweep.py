#!/usr/bin/env python3
"""The grid K3 across system sizes on one card, beside pcg + GEMV.

    python3 scripts/k3_sweep.py [OUT.json] [N ...]

For each N (default SIZES) a random SPD system of N cameras on Nc lanes
(Nc = N rounded up to 128, as the dense RCS pads it;
chip_smoke.spd_system, seed N) runs ITERS fixed CG iterations (q_tol
-inf, residual reset every 10) through the grid kernel
(cg_dense._launch_grid) and through the default route's loop,
solver.cg.pcg over the z-space GEMV (chip_smoke.pcg_gemv). Per size: the
plan (CTAs, resident and streamed rows of the largest CTA, ring stages
and their rows),
the kernel's device time per call and per CG iteration (profiler trace,
chip_smoke.traced_ms), the bound on the real 9 N system and on the
padded 9 Nc one (chip_smoke.k3_bound), the rows' bytes streamed per product,
and pcg + GEMV's time per call (CUDA events: its host loop included) and
its device time. Prints one JSON object; writes it to OUT.json when
given.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

SIZES = (129, 200, 257, 264, 265, 300, 400, 512, 768, 1025, 1536, 2048)
ITERS = 30


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 2
    from rootba_tpu_torch.ops import cg_dense, kernels
    from rootba_tpu_torch.ops.block9 import chol9
    from rootba_tpu_torch.utils.device import resolve_device

    dev = resolve_device("cuda")
    kernels.build_all()
    args = sys.argv[1:]
    out = Path(args.pop(0)).resolve() if args and not args[0].isdigit() \
        else None
    sizes = tuple(int(a) for a in args) or SIZES
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    res = {"card": cs.smi_line(), "sms": sms, "iters": ITERS, "rows": []}
    for N in sizes:
        Nc = -(-N // 128) * 128
        Hz, blocks, b = cs.spd_system(N, Nc, seed=N, dev=dev)
        Hz = torch.as_tensor(Hz, device=dev)
        chol = chol9(torch.as_tensor(blocks, device=dev))
        bt = torch.as_tensor(b, device=dev)
        Lp, b2 = cs.k3_inputs(Hz, chol, bt)
        plan = cg_dense.k3_plan(N, Nc, sms)
        kw = dict(min_iters=0, max_iters=ITERS, q_tol=float("-inf"),
                  r_tol=-1.0, reset_period=10)
        x_k, st = cg_dense._launch_grid(Hz, b2, Lp, N, **kw)
        x_p, _ = cg_dense.pcg_dense_plain(Hz, b2, Lp, **kw)
        err = cs.max_abs(x_k, x_p)
        scale = max(float(x_p.abs().max()), 1e-30)
        cs.check(int(st[0]) == ITERS and err <= 2e-4 * scale,
                 f"N={N}: {int(st[0])} iterations, max abs err {err}")
        ms, names, _ = cs.traced_ms(
            lambda: cg_dense._launch_grid(Hz, b2, Lp, N, **kw),
            cs.KERNEL_NAMES["pcg_dense_grid"], reps=10)
        cs.check(ms is not None, f"N={N}: kernel not once per call {names}")
        pkw = dict(min_num_iterations=0, max_num_iterations=ITERS,
                   q_tolerance=float("-inf"), r_tolerance=-1.0)
        yard = cs.both("pcg_gemv_ms",
                       lambda: cs.pcg_gemv(Hz, chol, bt, pkw), 3, 1)
        resets = ITERS // 10
        row = dict(
            N=N, Nc=Nc, ctas=plan.ctas, resident_rows=plan.rows_per_cta,
            streamed_rows=plan.streamed, stages=plan.stages,
            stage_rows=plan.stage_rows,
            smem_bytes=plan.smem_bytes, ms=ms,
            us_per_cg_iter=1e3 * ms / ITERS,
            bound_ms=cs.k3_bound(9 * N, N, ITERS, resets)["bound_ms"],
            bound_ms_padded=cs.k3_bound(9 * Nc, Nc, ITERS,
                                        resets)["bound_ms"],
            streamed_mb_per_product=(
                4 * 9 * cg_dense.grid_lanes(N) * sum(
                    rr - plan.rows_per_cta
                    if rr > plan.rows_per_cta + plan.stages * plan.stage_rows
                    else 0
                    for rr in (9 * ((t + 1) * N // plan.ctas
                                    - t * N // plan.ctas)
                               for t in range(plan.ctas))) / 1e6),
            max_rel_err=err / scale,
            pcg_gemv_ms_per_call=yard["pcg_gemv_ms_per_call"],
            pcg_gemv_device_ms=yard["pcg_gemv_ms"])
        res["rows"].append(row)
        print(json.dumps(row), flush=True)
        del Hz, chol, bt, Lp, b2, x_k, x_p
        torch.cuda.empty_cache()
    line = json.dumps(res)
    print(line)
    if out is not None:
        out.write_text(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
