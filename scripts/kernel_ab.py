#!/usr/bin/env python3
"""Before/after device times of the port's K1 and K3 on one card.

    python3 scripts/kernel_ab.py OLD_CHECKOUT [OUT.json]

OLD_CHECKOUT is another checkout of the repository (say, the parent
commit, unpacked with `git archive`). Its CUDA sources are built by its
own ops/kernels.py into its own build/ directory. The script records
the main path's inputs with chip_smoke.py's Recorder -- the K3 call
with the most CG iterations of the ladybug-49 twin (20 LM iterations),
of the trafalgar-126 twin (5) and of the trafalgar-257 twin with
pallas_cg="on" (3: the grid kernel), and the trafalgar-257 twin's
largest K1 call -- and times the old and this tree's kernels on them in turns
(old, new, new, old) by profiler device time (chip_smoke.traced_ms: the
kernel once per call in the trace). Each tree's K3 is the kernel its own
capacity check (rb_pcg_dense_cluster_plan) chooses. K1 runs in f32 (the
traced paths' precision) and f64. It also runs the trafalgar-126 twin's
5 f32 LM iterations through the old tree's CLI, in a process of its
own, and prints that final cost beside this tree's. It prints one JSON
object, and writes it to OUT.json when given.
"""

from __future__ import annotations

import ctypes
import importlib.util
import json
import subprocess
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


# the old tree's CLI on the trafalgar-126 twin, in its own process
OLD_T126 = """
import json, sys
sys.path.insert(0, {root!r})
import chip_smoke as cs
cs.WORK.mkdir(parents=True, exist_ok=True)
d = cs.run_cli(cs.write_twin("trafalgar126"), 5, "ab_trafalgar126_old")
print(json.dumps(d["cost"]))
"""


def timed(name: str, fn, expect: str, reps: int = 20) -> float:
    """Device ms of one fn() call, from a trace that holds the kernel
    `expect` names once per call (chip_smoke.traced_ms)."""
    ms, names, tries = cs.traced_ms(fn, expect, reps)
    cs.check(ms is not None, f"{name}: {expect} not once per call in "
                             f"{tries} traces, the last {names}")
    return ms


def k3_ab(old_cg, call, order, stream) -> dict:
    """The old tree's K3 and this tree's on one recorded main-path call,
    each the kernel its own tree's plan gives: device ms in `order`, the
    CG iterations of each, and x's largest difference."""
    import torch

    from rootba_tpu_torch.ops import cg_dense

    _, (Hz, chol, b), kw = call
    Lp, b2 = cs.k3_inputs(Hz, chol, b)
    N, Mz = b.shape[0], Hz.shape[0]
    ckw = dict(min_iters=kw["min_num_iterations"],
               max_iters=kw["max_num_iterations"], q_tol=kw["q_tolerance"],
               r_tol=kw["r_tolerance"], reset_period=10)
    x2 = torch.empty((9, Mz // 9), dtype=torch.float32, device=Hz.device)
    stats = torch.empty(4, dtype=torch.float32, device=Hz.device)
    work = torch.empty(3 * Mz, dtype=torch.float32, device=Hz.device)
    rows, smem = ctypes.c_int(), ctypes.c_longlong()
    old_kernel = cg_dense.PLAN_KERNELS[old_cg.rb_pcg_dense_cluster_plan(
        N, ctypes.addressof(rows), ctypes.addressof(smem))]
    entry = cg_dense.ENTRIES[old_kernel]
    grid = old_kernel == "grid"
    args = (Mz, Mz // 9) if grid else (N, Mz // 9)
    head = (work.data_ptr(),) if grid else ()

    def k3_old():
        cs.check(getattr(old_cg, entry)(
            Hz.data_ptr(), b2.data_ptr(), Lp.data_ptr(), x2.data_ptr(),
            stats.data_ptr(), *head, *args, ckw["max_iters"],
            ckw["min_iters"], ckw["q_tol"], ckw["r_tol"],
            ckw["reset_period"], stream) == 0, f"old {entry}")
        return x2, stats

    fns = {"old": k3_old,
           "new": lambda: cg_dense._launch(Hz, b2, Lp, N, **ckw)}
    names = {k: cs.KERNEL_NAMES[f"pcg_dense_{kernel}"] for k, kernel in (
        ("old", old_kernel), ("new", cg_dense.k3_plan(N, Mz // 9).kernel))}
    outs = {k: tuple(t.clone() for t in fns[k]()) for k in fns}
    return dict(shape=f"M={Mz} N={N}", kernels=names,
                cg_iters={k: int(o[1][0]) for k, o in outs.items()},
                max_abs_diff=cs.max_abs(outs["old"][0], outs["new"][0]),
                ms=[timed(k, fns[k], names[k]) for k in order])


def main() -> int:
    import torch

    if not torch.cuda.is_available() or len(sys.argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    from rootba_tpu_torch.ops import cg_dense, fold, kernels

    old_root = Path(sys.argv[1]).resolve()
    old = old_kernels(old_root)
    # resolved now: the CLI runs below change the working directory
    out_path = Path(sys.argv[2]).resolve() if len(sys.argv) > 2 else None
    old.build_all()
    kernels.build_all()
    old_fold, old_cg = old.load("fold"), old.load("cg_dense")
    cs.WORK.mkdir(parents=True, exist_ok=True)
    with cs.Recorder() as rec:
        cs.run_cli(cs.write_twin("ladybug"), 20, "ab_ladybug")
    with cs.Recorder() as rec_m:
        new_cost = cs.run_cli(cs.write_twin("trafalgar126"), 5,
                              "ab_trafalgar126")["cost"]
    old_cost = json.loads(subprocess.run(
        [sys.executable, "-c", OLD_T126.format(root=str(old_root))],
        check=True, capture_output=True, text=True).stdout.splitlines()[-1])
    traf = cs.write_twin("trafalgar")
    with cs.Recorder() as rec_t:
        cs.run_cli(traf, 1, "ab_trafalgar")
    with cs.Recorder() as rec_on:
        cs.run_cli(traf, 3, "ab_trafalgar_on", cs.K3_ON)
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

    # K3 at the call with the most CG iterations of each path
    for tag, r in (("k3", rec), ("k3_trafalgar126", rec_m),
                   ("k3_trafalgar_on", rec_on)):
        res[tag] = k3_ab(old_cg, r.largest["pcg_dense"], res["order"],
                         stream)
    res["trafalgar126_final_cost"] = {"old": old_cost[-1],
                                      "new": new_cost[-1]}
    line = json.dumps(res)
    print(line)
    if out_path is not None:
        out_path.write_text(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
