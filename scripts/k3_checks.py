#!/usr/bin/env python3
"""Two checks behind the K3 cluster kernel's arithmetic, on one card.

    python3 scripts/k3_checks.py [OUT.txt]

1. The inline quotients of csrc/cg_dense.cu (fdiv, and quot_fast with a
   correctly rounded reciprocal) against the IEEE division, bit for bit,
   on 2^33 random pairs with exponents in [-70, 70] (inside and outside
   the fast path's range). The check kernel includes cg_dense.cu itself.
2. Where float32 CG stops at q_tol 1e-8: for the phase-2 system sizes of
   chip_smoke.py (N = 12 to 129, the half kernel's 97-128 among them) and
   seeds N, N + 1000, ..., the iteration counts of the plain twin and
   of each K3 kernel that takes the system (reset every 10 and every 3);
   where they differ, the exact (float64) zeta at the earlier stop beside
   chip_smoke's tie band; and for one system the float64 zeta of each
   iteration's x (q1 = -x.(b + r), r = b - Hx) from the twin and the
   full-row cluster kernel.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

CHECK_CU = r'''
#include "cg_dense.cu"

namespace {
__device__ uint32_t mix(uint64_t x) {
  x ^= x >> 33; x *= 0xff51afd7ed558ccdULL; x ^= x >> 33;
  x *= 0xc4ceb9fe1a85ec53ULL; x ^= x >> 33;
  return static_cast<uint32_t>(x);
}
__device__ float draw(uint32_t u) {  // sign, mantissa, exponent -70..70
  return __uint_as_float((u & 0x807fffffu) |
                         ((127u - 70u + (u >> 23) % 141u) << 23));
}
__global__ void quotient_check(unsigned long long* counts, long long n,
                               int seed) {
  unsigned long long bad_fdiv = 0, bad_quot = 0, fast = 0;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < n; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const float a = draw(mix(2 * i + seed * 1000003ULL));
    const float b = draw(mix(2 * i + 1 + seed * 1000003ULL));
    const float q = a / b;
    bad_fdiv += __float_as_uint(fdiv(a, b)) != __float_as_uint(q);
    if (quot_range(a, b)) {
      ++fast;
      bad_quot += __float_as_uint(quot_fast(a, b, 1.f / b)) !=
                  __float_as_uint(q);
    }
  }
  atomicAdd(counts, bad_fdiv);
  atomicAdd(counts + 1, bad_quot);
  atomicAdd(counts + 2, fast);
}
}  // namespace

extern "C" int rb_quotient_check(unsigned long long* counts, long long n,
                                 int seed) {
  quotient_check<<<132 * 16, 256>>>(counts, n, seed);
  return static_cast<int>(cudaGetLastError());
}
'''


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("k3_checks: no CUDA device available", file=sys.stderr)
        return 2
    from rootba_tpu_torch.ops import cg_dense, kernels
    from rootba_tpu_torch.ops.block9 import chol9

    lines = [cs.smi_line()]

    def say(s):
        print(s, flush=True)
        lines.append(s)

    build = ROOT / "build" / "k3_checks"
    build.mkdir(parents=True, exist_ok=True)
    (build / "check.cu").write_text(CHECK_CU)
    subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS,
                    "-I", str(ROOT / "rootba_tpu_torch" / "csrc"), "-o",
                    str(build / "libcheck.so"), str(build / "check.cu")],
                   check=True)
    lib = ctypes.CDLL(str(build / "libcheck.so"))
    lib.rb_quotient_check.argtypes = [ctypes.c_void_p, ctypes.c_longlong,
                                      ctypes.c_int]
    counts = torch.zeros(3, dtype=torch.int64, device="cuda")
    n = 1 << 31
    for seed in range(4):
        kernels.check(lib.rb_quotient_check(counts.data_ptr(), n, seed),
                      "quotient check")
    c = counts.tolist()
    say(f"quotients: {c[0]} of {4 * n} fdiv results differ from a / b; "
        f"{c[1]} of {c[2]} quot_fast results in its range do")

    dev = torch.device("cuda")
    ties = within = 0
    for N, Nc in cs.K3_SYSTEMS:
        plan = cg_dense.k3_plan(N, Nc)
        names = ["grid"] + (["cluster"] if plan.kernel == "cluster" else [])
        names += ["half"] if cg_dense.half_fits(N) else []
        for k in range(8):
            seed = N + 1000 * k
            Hz, blocks, b = cs.spd_system(N, Nc, seed=seed, dev=dev)
            Hz = torch.as_tensor(Hz, device=dev)
            Lp = cg_dense.chol_planes(chol9(torch.as_tensor(blocks,
                                                            device=dev)), Nc)
            b2 = torch.zeros((9, Nc), device=dev)
            b2[:, :N] = torch.as_tensor(b, device=dev).T
            counts = []
            notes = []
            for period in (10, 3):
                kw = dict(min_iters=0, max_iters=200, q_tol=1e-8,
                          r_tol=-1.0, reset_period=period)
                its = [int(cg_dense.pcg_dense_plain(Hz, b2, Lp, **kw)[1][0]),
                       int(cg_dense._launch_grid(Hz, b2, Lp, N, **kw)[1][0])]
                for name in names[1:]:
                    its.append(int(cg_dense._launch_in_cluster(
                        name, Hz, b2, Lp, N, **kw)[1][0]))
                counts.append(its)
                if len(set(its)) > 1:
                    m = min(its)
                    z = cs.zeta64(Hz, b2, Lp, kw, m)
                    ok = (max(its) - m == 1
                          and abs(z - kw["q_tol"]) <= m * cs.ZETA_BAND)
                    ties += 1
                    within += ok
                    notes.append(f"reset {period}: exact zeta at {m} "
                                 f"{z:.3e}, band {m * cs.ZETA_BAND:.3e}"
                                 f"{'' if ok else ' OUTSIDE'}")
            same = all(len(set(x)) == 1 for x in counts)
            say(f"N={N} Nc={Nc} seed={seed}: stops (twin, "
                f"{', '.join(names)}) at "
                f"q_tol 1e-8, reset 10: {counts[0]}, reset 3: {counts[1]}"
                f"{'' if same else '  <- differ: ' + '; '.join(notes)}")
    say(f"stops that differ: {ties}; one iteration apart within the tie "
        f"band: {within}")

    N = 49
    Hz, blocks, b = cs.spd_system(N, 128, seed=N)
    H64 = torch.as_tensor(Hz, dtype=torch.float64, device=dev)
    Hz = torch.as_tensor(Hz, device=dev)
    Lp = cg_dense.chol_planes(chol9(torch.as_tensor(blocks, device=dev)), 128)
    b2 = torch.zeros((9, 128), device=dev)
    b2[:, :N] = torch.as_tensor(b, device=dev).T
    b64 = b2.double().reshape(-1)
    prev = {"twin": 0.0, "cluster": 0.0}
    for k in range(1, 12):
        kw = dict(min_iters=0, max_iters=k, q_tol=float("-inf"), r_tol=-1.0,
                  reset_period=3)
        xs = {"twin": cg_dense.pcg_dense_plain(Hz, b2, Lp, **kw)[0],
              "cluster": cg_dense._launch_in_cluster("cluster", Hz, b2, Lp,
                                                     N, **kw)[0]}
        parts = []
        for name, x in xs.items():
            x = x.double().reshape(-1)
            q1 = float(-(x @ (2 * b64 - H64 @ x)))
            parts.append(f"{name} q1 {q1:.10e} zeta {k * (q1 - prev[name]) / q1:.3e}")
            prev[name] = q1
        say(f"N=49 seed=49 reset 3, iteration {k}: " + "; ".join(parts))
    if len(sys.argv) > 1:
        Path(sys.argv[1]).resolve().write_text("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
