#!/usr/bin/env python3
"""Before/after host setup and stage times of the port's SQUARE_ROOT
path on one card, and whether stage2 repeats bit for bit.

    python3 scripts/stage_ab.py OLD_CHECKOUT [--reps 5] [--out OUT.json]

OLD_CHECKOUT is another checkout of the repository (say, the parent
commit, unpacked with `git archive`). The twins (chip_smoke.py's TWINS,
seed 17) are written once as .npz files; each tree then runs, in a
process of its own and in the order old, new, new, old, these cases
with default options otherwise:

  trafalgar-257 f32 (dense RCS), final-3068 f32 (BSR, packed table),
  final-3068 f32 with sqrt_rcs_mode="implicit" (the per-camera sums of
  stage1, stage2 and the matvec through the camera CSR in a tree that
  has it), final-4585 f64 (BSR half table, fused-W rows by K2: the
  default variant of scripts/fused_w_split.py).

Per case: the load (bench.py's preprocessing), `bucketize`, the
linearizer's build (host setup; in implicit mode also the first access
to the camera CSR, which a tree with a lazy CSR builds there), then
stage1 at the initial state and stage2 at lambda 1e-4, one untimed call
each and `reps` timed ones (device time between CUDA events around the
call, the queue drained before it; medians), and whether two stage2
calls on the same linearization give bit-equal right-hand sides,
preconditioner factors and RCS tables. One JSON object at the end, also
written to OUT.json when given.
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

CASES = (("trafalgar", "float32", ()),
         ("final3068", "float32", ()),
         ("final3068", "float32", ("--sqrt-rcs-mode", "implicit")),
         ("final4585", "float64", ()))


def _tensors(x):
    """The tensors of a stage2 output, flattened in a fixed order."""
    import torch

    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (tuple, list)):
        return [t for v in x for t in _tensors(v)]
    return []


def worker(tree: str, cases: list, reps: int) -> dict:
    """Runs in a process whose rootba_tpu_torch is `tree`'s."""
    sys.path.insert(0, tree)
    import torch

    from rootba_tpu_torch.bal.bucketing import bucketize
    from rootba_tpu_torch.bal.problem import load_normalized_bal_problem
    from rootba_tpu_torch.cli.common import parse_bal_app_arguments
    from rootba_tpu_torch.ops import kernels
    from rootba_tpu_torch.solver.lm import create_linearizer, initial_state

    kernels.build_all()
    dev = torch.device("cuda")

    def timed(fn):
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out = fn()
        b.record()
        b.synchronize()
        return out, a.elapsed_time(b)

    out = []
    for name, dname, path, argv in cases:
        options = parse_bal_app_arguments("stage_ab", [
            "--input", path, "--quiet", *argv])[0]
        opts = options.solver
        opts.use_double = dname == "float64"
        dtype = torch.float64 if opts.use_double else torch.float32
        t = time.monotonic()
        problem = load_normalized_bal_problem(options.dataset)
        load_s = time.monotonic() - t
        t = time.monotonic()
        bp = bucketize(problem, pow2_from=opts.bucket_pow2_from)
        bucketize_s = time.monotonic() - t
        t = time.monotonic()
        lin = create_linearizer(bp, opts, dtype, dev)
        if opts.sqrt_rcs_mode == "implicit" and hasattr(lin, "cam_csr"):
            lin.cam_csr  # a lazy CSR builds here
        torch.cuda.synchronize()
        build_s = time.monotonic() - t
        st = initial_state(bp, dtype, dev)
        lam = torch.full((), 1e-4, dtype=dtype, device=dev)
        stage1 = lambda: lin.stage1(st.cams, st.lm_ps)  # noqa: E731
        lins = stage1()[0]
        s1 = [timed(stage1)[1] for _ in range(reps)]
        first = [t.clone() for t in _tensors(lin.stage2(lins, lam))]
        s2 = []
        for _ in range(reps):
            res, ms = timed(lambda: lin.stage2(lins, lam))
            s2.append(ms)
            again = _tensors(res)
            del res
        equal = [bool(torch.equal(a, b)) for a, b in zip(first, again)]
        rel = max((float((a - b).abs().max()) / max(float(a.abs().max()),
                                                    1e-300)
                   for a, b in zip(first, again) if a.numel()), default=0.0)
        case = dict(name=name, dtype=dname, argv=list(argv), load_s=load_s,
                    bucketize_s=bucketize_s, build_s=build_s,
                    setup_s=bucketize_s + build_s,
                    stage1_ms=statistics.median(s1), stage1_all=s1,
                    stage2_ms=statistics.median(s2), stage2_all=s2,
                    stage2_bit_equal=all(equal), stage2_tensors=len(equal),
                    stage2_max_rel_diff=rel,
                    peak_mib=torch.cuda.max_memory_allocated() / 2**20)
        print(f"[{tree}] {name} {dname} {' '.join(argv)}: setup "
              f"{case['setup_s']:.3f} s (bucketize {bucketize_s:.3f}, "
              f"linearizer {build_s:.3f}), stage1 {case['stage1_ms']:.3f} "
              f"ms, stage2 {case['stage2_ms']:.3f} ms, two stage2 calls "
              f"bit-equal: {case['stage2_bit_equal']} (max rel diff "
              f"{rel:.3e})", file=sys.stderr, flush=True)
        out.append(case)
        del lin, lins, first, again, st, bp, problem
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    return dict(tree=tree, cases=out)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("old", nargs="?")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--out", default=None)
    ap.add_argument("--worker", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--cases", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        print(json.dumps(worker(args.worker, json.loads(args.cases),
                                args.reps)))
        return 0
    import torch

    if not torch.cuda.is_available():
        print("stage_ab: no CUDA device available", file=sys.stderr)
        return 2
    if not args.old:
        ap.error("OLD_CHECKOUT is required")
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs

    cs.WORK.mkdir(parents=True, exist_ok=True)
    paths = {}
    for name, _, _ in CASES:
        if name not in paths:
            t = time.monotonic()
            paths[name] = str(cs.write_twin(name, npz=True))
            print(f"{name} twin written in {time.monotonic() - t:.1f} s",
                  file=sys.stderr, flush=True)
    cases = [(n, d, paths[n], list(a)) for n, d, a in CASES]
    # the argv of a case also carries the preprocessing of bench.py
    cases = [(n, d, p, [*cs.PREPROCESS, *a]) for n, d, p, a in cases]
    runs = []
    for tag, tree in (("old", args.old), ("new", str(ROOT)),
                      ("new", str(ROOT)), ("old", args.old)):
        r = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), "--worker",
             str(Path(tree).resolve()), "--cases", json.dumps(cases),
             "--reps", str(args.reps)], capture_output=True, text=True,
            timeout=3000)
        sys.stderr.write(r.stderr[-6000:])
        if r.returncode != 0:
            print(f"stage_ab: the {tag} tree's worker exited "
                  f"{r.returncode}", file=sys.stderr)
            return 1
        runs.append(dict(tag=tag, **json.loads(r.stdout.strip()
                                               .splitlines()[-1])))
    res = dict(card=cs.smi_line(), reps=args.reps, runs=runs)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(res, indent=1))
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
