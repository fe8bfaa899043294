#!/usr/bin/env python3
"""Before/after device times of the port's K1 and K3 on one card.

    python3 scripts/kernel_ab.py OLD_CHECKOUT [OUT.json]

OLD_CHECKOUT is another checkout of the repository (say, the parent
commit, unpacked with `git archive`). Its CUDA sources are built by its
own ops/kernels.py into its own build/ directory. The script records
the main path's inputs with chip_smoke.py's Recorder -- the ladybug-49
twin's K3 call with the most CG iterations and the trafalgar-257 twin's
largest K1 call -- and times the old and this tree's kernels on them in
turns (old, new, new, old) by profiler device time (chip_smoke.device_ms,
one launch per call in the trace). K1 runs in f32 (the traced paths'
precision) and f64. It prints one JSON object, and writes it to OUT.json
when given.
"""

from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402


def old_kernels(old_root: Path):
    """The old checkout's ops/kernels.py, loaded under its own name."""
    path = old_root / "rootba_tpu_torch" / "ops" / "kernels.py"
    spec = importlib.util.spec_from_file_location("old_kernels", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def timed(name: str, fn, expect: str, reps: int = 20) -> float:
    ms, names = cs.device_ms(fn, reps)
    cs.check(sum(v for n, v in names.items() if expect in n) == 1.0,
             f"{name}: {expect} not once per call in the trace {names}")
    return ms


def main() -> int:
    import torch

    if not torch.cuda.is_available() or len(sys.argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    from rootba_tpu_torch.ops import cg_dense, fold, kernels

    old = old_kernels(Path(sys.argv[1]).resolve())
    # resolved now: the CLI runs below change the working directory
    out_path = Path(sys.argv[2]).resolve() if len(sys.argv) > 2 else None
    old.build_all()
    kernels.build_all()
    old_fold, old_cg = old.load("fold"), old.load("cg_dense")
    cs.WORK.mkdir(parents=True, exist_ok=True)
    with cs.Recorder() as rec:
        cs.run_cli(cs.write_twin("ladybug"), 20, "ab_ladybug")
    with cs.Recorder() as rec_t:
        cs.run_cli(cs.write_twin("trafalgar"), 1, "ab_trafalgar")
    stream = torch.cuda.current_stream().cuda_stream
    res = {"card": cs.smi_line(), "order": ["old", "new", "new", "old"]}

    # K1 at the largest trafalgar call
    _, (s1, s2, W), _ = rec_t.largest["outer81_fold"]
    M, K9 = s1.shape
    for dt, tag in ((torch.float32, "f32"), (torch.float64, "f64")):
        a, c = s1.to(dt), s2.to(dt)
        out = torch.empty((M // W, 81), dtype=dt, device=a.device)
        entry = (old_fold.rb_outer81_fold_f32 if dt == torch.float32
                 else old_fold.rb_outer81_fold_f64)

        def run_old():
            old.check(entry(a.data_ptr(), c.data_ptr(), out.data_ptr(), M,
                            K9, W, stream), "old outer81_fold")
            return out

        fns = {"old": run_old, "new": lambda: fold.outer81_fold(a, c, W)}
        diff = cs.max_abs(fns["old"]().clone(), fns["new"]())
        res[f"k1_{tag}"] = dict(
            shape=f"M={M} K={K9 // 9} W={W}", max_abs_diff=diff,
            ms=[timed(k, fns[k], "outer81_fold_kernel") for k in res["order"]])

    # K3 at the ladybug call with the most CG iterations
    _, (Hz, chol, b), kw = rec.largest["pcg_dense"]
    Lp, b2 = cs.k3_inputs(Hz, chol, b)
    N, Mz = b.shape[0], Hz.shape[0]
    ckw = dict(min_iters=kw["min_num_iterations"],
               max_iters=kw["max_num_iterations"], q_tol=kw["q_tolerance"],
               r_tol=kw["r_tolerance"], reset_period=10)
    x2 = torch.empty((9, Mz // 9), dtype=torch.float32, device=Hz.device)
    stats = torch.empty(4, dtype=torch.float32, device=Hz.device)
    work = torch.empty(3 * Mz, dtype=torch.float32, device=Hz.device)

    def k3_old():
        old.check(old_cg.rb_pcg_dense_f32(
            Hz.data_ptr(), b2.data_ptr(), Lp.data_ptr(), x2.data_ptr(),
            stats.data_ptr(), work.data_ptr(), Mz, Mz // 9, ckw["max_iters"],
            ckw["min_iters"], ckw["q_tol"], ckw["r_tol"],
            ckw["reset_period"], stream), "old pcg_dense")
        return x2, stats

    fns = {"old": k3_old,
           "new": lambda: cg_dense._launch(Hz, b2, Lp, N, **ckw)}
    names = {"old": "pcg_dense_kernel",
             "new": f"pcg_dense_{cg_dense.k3_plan(N, Mz // 9).kernel}"}
    iters = {k: int(fns[k]()[1][0]) for k in fns}
    res["k3"] = dict(shape=f"M={Mz} N={N}", cg_iters=iters,
                     ms=[timed(k, fns[k], names[k]) for k in res["order"]])
    line = json.dumps(res)
    print(line)
    if out_path is not None:
        out_path.write_text(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
