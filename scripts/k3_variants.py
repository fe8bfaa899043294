#!/usr/bin/env python3
"""Design variants of K3's cluster kernel against the kernel as it is,
on one card.

    python3 scripts/k3_variants.py [OUT.json]

Each variant is csrc/cg_dense.cu with one text edit, built by nvcc into
build/k3_variants/:

  current      the kernel as it is: 16 CTAs, one thread per camera lane
               runs the lane's 9x9 substitution in registers, the slab
               copied by 16-byte cp.async
  cluster8     8 CTAs (each holds twice the rows)
  precond9     the loop's preconditioner spread over 9 threads per lane
               (three lanes per warp), each step's quotient broadcast to
               the lane's threads by a shuffle; r and z pass through
               shared memory
  precond_off  no preconditioner in the loop (z = r): its whole cost
  slab_tma     the slab copied by one TMA bulk copy (cp.async.bulk onto an
               mbarrier) per row segment of Np lanes

On the synthetic SPD systems of chip_smoke.spd_system (seed N) with
N = 12, 49 and 92 cameras on 128 lanes: device time (chip_smoke.device_ms,
the kernel once per call in the trace) at 0 and at 20 fixed CG iterations
(q_tol -inf, reset every 10). Per iteration: (t20 - t0) / 20; fixed cost
(launch, prologue, epilogue): t0. The variants run in turns, forward and
then backward, and each time is the mean of the two (of those whose
trace holds the kernel once per call, in at most three traces each). x
after 20 iterations is held against the twin at rtol 2e-4 / atol 2e-5,
except for precond_off (another algorithm). ptxas's register count of the kernel is
printed for each variant. Prints one JSON object, and writes it to
OUT.json when given.
"""

from __future__ import annotations

import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

BUILD = ROOT / "build" / "k3_variants"
SYSTEMS = (12, 49, 92)
ITERS = 20

PRECOND9 = r'''
// z = (L L')^-1 r with 9 threads per camera lane, three lanes per warp:
// thread c of a lane's group forms component c; at each step the
// quotient of thread i goes to the group by a shuffle.
__device__ void precond9(const float* Ls, int Np, int N, const float* rs,
                         float* zs) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane / 9;  // 3: the warp's 5 spare threads
  const int base = 9 * min(g, 2);
  for (int j0 = 0; j0 < N; j0 += 3 * kCWarps) {
    const int j = j0 + 3 * warp + g;
    const bool on = g < 3 && j < N;
    const int c = on ? lane - 9 * g : 0;
    const float* L = Ls + (on ? j : 0);
    const float dc = L[(c * D + c) * Np];
    const float ic = fdiv(1.f, dc);
    float s = on ? rs[c * Np + j] : 0.f;
    float y = 0.f;
#pragma unroll
    for (int i = 0; i < D; ++i) {
      const float yi = __shfl_sync(kFull, quot_fast(s, dc, ic), base + i);
      if (c == i) y = yi;
      if (c > i) s = __fsub_rn(s, __fmul_rn(L[(c * D + i) * Np], yi));
    }
    s = y;
    float z = 0.f;
#pragma unroll
    for (int i = D - 1; i >= 0; --i) {
      const float zi = __shfl_sync(kFull, quot_fast(s, dc, ic), base + i);
      if (c == i) z = zi;
      if (c < i) s = __fsub_rn(s, __fmul_rn(L[(i * D + c) * Np], zi));
    }
    if (on) zs[c * Np + j] = z;
  }
}

'''

LOOP_SOLVE = """    rz = 0.f;
    if (own) {
      solve9(L, Np, dv, iv, rv, zv);
"""
KERNEL_HEAD = "__global__ void __launch_bounds__(kCThreads, 1)\npcg_dense_cluster_kernel("
SMEM_TAIL = "2 * kCluster * kCWarps + 6 * kCWarps) *"
RED_LINE = "  float* red = pqb + 2 * kCluster * kCWarps;  // 2 x 3 x kCWarps\n"
SLAB_START = "  } else if (vec4) {\n    // a row's 9 segments"
SLAB_END = "  } else {\n    for (int rr = warp - kLaneWarps;"
LANE_WARP = "  const bool lane_warp = warp < kLaneWarps;\n"
SLAB_WAIT = """  // the slab, before the first GEMV (whose barrier publishes it)
  asm volatile("cp.async.wait_all;\\n" ::: "memory");
"""

VARIANTS = {
    "current": [],
    "cluster8": [("constexpr int kCluster = 16;", "constexpr int kCluster = 8;")],
    "precond9": [
        (KERNEL_HEAD, PRECOND9 + KERNEL_HEAD),
        (SMEM_TAIL, "2 * kCluster * kCWarps + 6 * kCWarps + 2 * ld) *"),
        (RED_LINE, RED_LINE + "  float* rs = red + 6 * kCWarps;\n"
                              "  float* zs = rs + ld;\n"),
        (LOOP_SOLVE, """    rz = 0.f;
    if (own) {
#pragma unroll
      for (int k = 0; k < D; ++k) rs[k * Np + j] = rv[k];
    }
    __syncthreads();
    precond9(Ls, Np, N, rs, zs);
    __syncthreads();
    if (own) {
#pragma unroll
      for (int k = 0; k < D; ++k) zv[k] = zs[k * Np + j];
"""),
    ],
    "precond_off": [(LOOP_SOLVE, """    rz = 0.f;
    if (own) {
#pragma unroll
      for (int k = 0; k < D; ++k) zv[k] = rv[k];
""")],
    "slab_tma": [
        (LANE_WARP, """  if (tid == 0) {
    mbar_init(qbar + 3);
    asm volatile("fence.mbarrier_init.release.cluster;\\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0 && vec4) mbar_expect(qbar + 3, 4 * nrows * D * Np);
  __syncthreads();
""" + LANE_WARP),
        ("SLAB", """  } else if (vec4) {
    // one bulk copy per row segment, onto the mbarrier qbar[3]
    for (int rr = warp - kLaneWarps; rr < nrows; rr += kCWarps - kLaneWarps) {
      const int f = (row0 + rr) / N;
      const int j = row0 + rr - f * N;
      if (lane < D) {
        const float* src = H + static_cast<size_t>(f * Nc + j) * Mz +
                           static_cast<size_t>(lane) * Nc;
        asm volatile(
            "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::"
            "bytes [%0], [%1], %2, [%3];\\n" ::"r"(smem_u32(Hs + rr * ld +
                                                           lane * Np)),
            "l"(src), "r"(4 * Np), "r"(smem_u32(qbar + 3))
            : "memory");
      }
    }
"""),
        (SLAB_WAIT, SLAB_WAIT + "  if (vec4) mbar_wait(qbar + 3, 0);\n"),
    ],
}


def variant_source(name: str) -> str:
    src = (ROOT / "rootba_tpu_torch" / "csrc" / "cg_dense.cu").read_text()
    for old, new in VARIANTS[name]:
        if old == "SLAB":
            a, b = src.index(SLAB_START), src.index(SLAB_END)
            src = src[:a] + new + src[b:]
            continue
        cs.check(src.count(old) == 1, f"{name}: edit target not unique: "
                                      f"{old[:60]!r}")
        src = src.replace(old, new)
    return src


def build(kernels) -> dict:
    """Every variant's library and the kernel's ptxas register count,
    one nvcc per variant, all started at once."""
    BUILD.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in VARIANTS:
        cu = BUILD / f"{name}.cu"
        cu.write_text(variant_source(name))
        so = BUILD / f"lib{name}.so"
        procs[name] = (subprocess.Popen(
            [kernels._nvcc(), *kernels.NVCC_FLAGS, "-Xptxas", "-v", "-o",
             str(so), str(cu)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), so)
    out = {}
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate()
        cs.check(proc.returncode == 0, f"nvcc failed for {name}:\n{log}")
        entry = next(c for c in log.split("Compiling entry function")[1:]
                     if "pcg_dense_cluster_kernel" in c.splitlines()[0])
        regs = int(re.search(r"Used (\d+) registers", entry).group(1))
        lib = ctypes.CDLL(str(so))
        f = lib.rb_pcg_dense_cluster_f32
        f.argtypes = list(kernels._SIGNATURES["cg_dense"][
            "rb_pcg_dense_cluster_f32"])
        f.restype = ctypes.c_int
        out[name] = (f, regs)
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("k3_variants: no CUDA device available", file=sys.stderr)
        return 2
    from rootba_tpu_torch.ops import cg_dense, kernels
    from rootba_tpu_torch.ops.block9 import chol9

    out_path = Path(sys.argv[1]).resolve() if len(sys.argv) > 1 else None
    libs = build(kernels)
    dev = torch.device("cuda")
    stream = torch.cuda.current_stream().cuda_stream
    res = {"card": cs.smi_line(), "iters": ITERS,
           "registers": {k: v[1] for k, v in libs.items()}, "systems": {}}
    print(f"{res['card']}; registers per thread: {res['registers']}",
          flush=True)
    for N in SYSTEMS:
        Nc = 128
        Hz, blocks, b = cs.spd_system(N, Nc, seed=N)
        Hz = torch.as_tensor(Hz, device=dev)
        Lp = cg_dense.chol_planes(chol9(torch.as_tensor(blocks, device=dev)),
                                  Nc)
        b2 = torch.zeros((9, Nc), device=dev)
        b2[:, :N] = torch.as_tensor(b, device=dev).T
        x2 = torch.empty((9, Nc), device=dev)
        stats = torch.empty(4, device=dev)
        names = [k for k in VARIANTS
                 if not (k == "cluster8" and -(-9 * N // 8) > 80)]

        def launch(name, iters):
            kernels.check(libs[name][0](
                Hz.data_ptr(), b2.data_ptr(), Lp.data_ptr(), x2.data_ptr(),
                stats.data_ptr(), N, Nc, iters, 0, float("-inf"), -1.0, 10,
                stream), name)
            return x2

        ref = cg_dense.pcg_dense_plain(Hz, b2, Lp, min_iters=0,
                                       max_iters=ITERS, q_tol=float("-inf"),
                                       r_tol=-1.0, reset_period=10)[0]
        errs = {}
        for name in names:
            got = launch(name, ITERS).clone()
            errs[name] = cs.max_abs(got, ref)
            if name != "precond_off":
                cs.check(cs.close(got, ref, 2e-4, 2e-5),
                         f"{name} N={N}: max abs err {errs[name]}")
        times = {k: {0: [], ITERS: []} for k in names}
        for order in (names, names[::-1]):
            for name in order:
                for iters in (0, ITERS):
                    # a trace that lost launches is taken again, as in
                    # chip_smoke.both; after three, the sample is missing
                    for _ in range(3):
                        ms, seen = cs.device_ms(lambda: launch(name, iters))
                        if seen.get("pcg_dense_cluster_kernel") == 1.0:
                            times[name][iters].append(ms)
                            break
                    else:
                        print(f"N={N}: {name} at {iters} iterations: the "
                              f"kernel not once per call in three traces "
                              f"{seen}", flush=True)
        rows = {}
        for name in names:
            t = times[name]
            if not (t[0] and t[ITERS]):
                rows[name] = dict(samples_ms=t)
                continue
            t0 = sum(t[0]) / len(t[0])
            tn = sum(t[ITERS]) / len(t[ITERS])
            rows[name] = dict(fixed_us=1e3 * t0, total_us=1e3 * tn,
                              us_per_iter=1e3 * (tn - t0) / ITERS,
                              samples_ms=t, max_abs_err_vs_twin=errs[name])
            print(f"N={N}: {name:11s} fixed {1e3 * t0:7.2f} us, "
                  f"{ITERS} iterations {1e3 * tn:7.2f} us, "
                  f"{rows[name]['us_per_iter']:5.2f} us per iteration, "
                  f"max abs err vs twin {errs[name]:.2e}", flush=True)
        res["systems"][N] = rows
    line = json.dumps(res)
    print(line)
    if out_path is not None:
        out_path.write_text(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
