#!/usr/bin/env python3
"""Design variants of K3's cluster kernels against the kernels as they
are, on one card.

    python3 scripts/k3_variants.py [OUT.json [NAME ...]]

Each variant is csrc/cg_dense.cu with one text edit, built by nvcc into
build/k3_variants/. Of the full-row kernel (pcg_dense_cluster_kernel):

  current      the kernel as it is: 16 CTAs, one thread per camera lane
               runs the lane's 9x9 substitution in registers, the slab
               copied by 16-byte cp.async
  exchange2    a second, dependent st.async round per iteration that
               sends every GEMV row again (the cost of the half kernel's
               extra exchange)
  stream_half  half of each CTA's slab copied again from Hz (L2) every
               iteration, after the GEMVs, awaited before the next GEMV
               (the cost of streaming the rows that do not fit)
  cluster8     8 CTAs (each holds twice the rows)
  precond9     the loop's preconditioner spread over 9 threads per lane
               (three lanes per warp), each step's quotient broadcast to
               the lane's threads by a shuffle; r and z pass through
               shared memory
  precond_off  no preconditioner in the loop (z = r): its whole cost
  slab_tma     the slab copied by one TMA bulk copy (cp.async.bulk onto an
               mbarrier) per row segment of Np lanes

and of the half kernel (pcg_dense_half_kernel):

  half              the kernel as it is
  half_inline       round 1 of the product inlined at its two calls
                    (twice the loop's code)
  half_skip         round 1's row groups branch past the chunks their
                    first row does not reach, not computing zeros
  half_g1, _g5, _g9 round 1 by groups of 1, 5 or 9 rows, not 3
  half_comb2, _comb3 round 1's column sums in two or three chains
                    of the warps (four or three stages), not four
  half_outline      round 2 and the 9x9 substitution out of line too
  half_precond_off  no preconditioner in the loop (z = r)

On the synthetic SPD systems of chip_smoke.spd_system (seed N) with
N = 12, 49 and 92 cameras (the full-row kernel) and 49, 92 and 126 (the
half kernel) on 128 lanes: device time (chip_smoke.traced_ms, the
kernel once per call in the trace) at 0 and at 20 fixed CG iterations
(q_tol -inf, reset every 10). Per iteration: (t20 - t0) / 20; fixed cost
(launch, prologue, epilogue): t0. The variants run in turns, forward and
then backward, and each time is the mean of the two (of those whose
trace holds the kernel once per call, in at most five traces each). x
after 20 iterations is held against the twin at rtol 2e-4 / atol 2e-5,
except without a preconditioner (another algorithm). ptxas's register
count of the kernel is printed for each variant. An edit applies to the
text of its kernel's own section of the source where it is found there,
else to the whole source; either way it must match once. Prints one
JSON object, and writes it to OUT.json when given. With NAMEs, only
those variants run.
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
SYSTEMS = {"cluster": (12, 49, 92), "half": (49, 92, 126)}
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
    const float dc = L[plane45(c, c) * Np];
    const float ic = fdiv(1.f, dc);
    float s = on ? rs[c * Np + j] : 0.f;
    float y = 0.f;
#pragma unroll
    for (int i = 0; i < D; ++i) {
      const float yi = __shfl_sync(kFull, quot_fast(s, dc, ic), base + i);
      if (c == i) y = yi;
      if (c > i) s = __fsub_rn(s, __fmul_rn(L[plane45(c, i) * Np], yi));
    }
    s = y;
    float z = 0.f;
#pragma unroll
    for (int i = D - 1; i >= 0; --i) {
      const float zi = __shfl_sync(kFull, quot_fast(s, dc, ic), base + i);
      if (c == i) z = zi;
      if (c < i) s = __fsub_rn(s, __fmul_rn(L[plane45(i, c) * Np], zi));
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

RESTREAM = r'''
// This warp's slab rows k >= nr / 2 copied again from Hz (16-byte
// cp.async; the inputs' rows aligned as the prologue's vec4 path has
// them).
__device__ void restream(const float* H, float* Hs, int row0, int nr, int N,
                         int Nc, int Np, int ld) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int q4 = Np / 4;
  const size_t Mz = static_cast<size_t>(D) * Nc;
  for (int k = nr / 2; k < nr; ++k) {
    const int rr = warp + k * kCWarps;
    const int f = (row0 + rr) / N;
    const int j = row0 + rr - f * N;
    const float* src = H + static_cast<size_t>(f * Nc + j) * Mz;
    float* dst = Hs + rr * ld;
    for (int c = lane; c < D * q4; c += 32) {
      const int seg = c / q4;
      const int off = 4 * (c - seg * q4);
      cp_async16(dst + seg * Np + off,
                 src + static_cast<size_t>(seg) * Nc + off);
    }
  }
}

'''
GEMV_SYNC = "    __syncthreads();\n\n    gemv_cluster(Hs, ps,"
Q_WAIT = ("    mbar_wait(qbar + pb, static_cast<uint32_t>(((i - 1) >> 1) "
          "& 1));\n")

# where the half kernel's section of the source starts
HALF_SECTION = "// the symmetric-half cluster kernel"

# name -> (the kernel it edits, its edits)
VARIANTS = {
    "current": [],
    # the cost of a second, dependent exchange per iteration: after the
    # GEMV's round, every warp sends its rows' sums again to every CTA
    # (onto a second pair of mbarriers, by parity), and the iteration goes
    # on with the second copy of q
    "exchange2": [
        ("constexpr int kCBarBytes = 32;", "constexpr int kCBarBytes = 48;"),
        (SMEM_TAIL, "2 * kCluster * kCWarps + 6 * kCWarps + 2 * ld) *"),
        (RED_LINE, RED_LINE + "  float* q2b = red + 6 * kCWarps;\n"),
        ("    mbar_init(hbar);\n", "    mbar_init(hbar);\n"
                                  "    mbar_init(qbar + 3);\n"
                                  "    mbar_init(qbar + 4);\n"),
        ("  const uint32_t r_hbar = map_rank(smem_u32(hbar), t);\n",
         "  const uint32_t r_hbar = map_rank(smem_u32(hbar), t);\n"
         "  const uint32_t r_q2 = map_rank(smem_u32(q2b), t);\n"
         "  const uint32_t r_x2bar = map_rank(smem_u32(qbar + 3), t);\n"),
        ("    if (tid == 0) mbar_expect(qbar + pb, q_bytes);\n",
         "    if (tid == 0) mbar_expect(qbar + pb, q_bytes);\n"
         "    if (tid == 0) mbar_expect(qbar + 3 + pb, h_bytes);\n"),
        (Q_WAIT, Q_WAIT + """#pragma unroll
    for (int k = 0; k < kRowsPerWarp; ++k) {
      if (k < nr && lane < C) {
        st_async(r_q2 + 4 * (pb * ld + vec[k]), q[vec[k]], r_x2bar + 8 * pb);
      }
    }
    mbar_wait(qbar + 3 + pb, static_cast<uint32_t>(((i - 1) >> 1) & 1));
    q = q2b + pb * ld;
"""),
    ],
    # the cost of streaming half of each CTA's slab from L2 every
    # iteration: each warp copies its rows k >= nr / 2 again after the
    # iteration's GEMVs (overlapping the preconditioner, the block sum and
    # the next p) and waits for them before the next GEMV
    "stream_half": [
        (KERNEL_HEAD, RESTREAM + KERNEL_HEAD),
        ("    // q1 and |r|^2 of this iteration, and already r . z of the "
         "next\n",
         "    restream(H, Hs, row0, nr, N, Nc, Np, ld);\n"
         "    // q1 and |r|^2 of this iteration, and already r . z of the "
         "next\n"),
        (GEMV_SYNC, '    asm volatile("cp.async.wait_all;\\n" ::: '
                    '"memory");\n' + GEMV_SYNC),
    ],
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


VARIANTS = {k: ("cluster", v) for k, v in VARIANTS.items()}
VARIANTS["half"] = ("half", [])
# round 1 of the product inlined at its two calls (twice the loop's code)
VARIANTS["half_inline"] = ("half", [(
    "__device__ __noinline__ void half_round1(",
    "__device__ __forceinline__ void half_round1(")])
# round 2 and the substitution out of line too (less code still)
VARIANTS["half_outline"] = ("half", [(
    "__device__ __forceinline__ void half_round2(",
    "__device__ __noinline__ void half_round2("), (
    "__device__ __forceinline__ void solve9(",
    "__device__ __noinline__ void solve9(")])
# round 1's loads pipelined by groups of 1, 5 or 9 rows, not 3 (9: a
# chunk's loads of every row go out together once its products are done)
for g in (1, 5, 9):
    VARIANTS[f"half_g{g}"] = ("half", [(
        "constexpr int kHGroup = 3;", f"constexpr int kHGroup = {g};")])
# round 1's groups skip the chunks their first row does not reach (a
# uniform branch per group and chunk), not computing zeros
VARIANTS["half_skip"] = ("half", [(
    "    r1_loads(h, row, r4, k0, 0, 4 * lane < ld);",
    "    if (r4[k0] < 128) r1_loads(h, row, r4, k0, 0, 4 * lane < ld);"), (
    "      r1_products(h, pcm, vr, s, acc[m], k0);",
    "      if (r4[k0] < 128 * m + 128) r1_products(h, pcm, vr, s, acc[m], k0);"), (
    "        r1_loads(h, row, r4, k0, m + 1, inn);",
    "        if (r4[k0] < 128 * m + 256) r1_loads(h, row, r4, k0, m + 1, inn);")])
# the warps' column sums in two or three chains (four or three stages),
# not four (two stages)
for c in (2, 3):
    VARIANTS[f"half_comb{c}"] = ("half", [(
        "constexpr int kHChains = 4;", f"constexpr int kHChains = {c};")])
VARIANTS["half_precond_off"] = ("half", [(LOOP_SOLVE, """    rz = 0.f;
    if (own) {
#pragma unroll
      for (int k = 0; k < D; ++k) zv[k] = rv[k];
""")])


def variant_source(name: str) -> str:
    src = (ROOT / "rootba_tpu_torch" / "csrc" / "cg_dense.cu").read_text()
    kernel, edits = VARIANTS[name]
    for old, new in edits:
        if old == "SLAB":
            a, b = src.index(SLAB_START), src.index(SLAB_END)
            src = src[:a] + new + src[b:]
            continue
        # the kernel's own section: the half kernel's from HALF_SECTION
        cut = src.index(HALF_SECTION)
        a, b = (cut, len(src)) if kernel == "half" else (0, cut)
        if old not in src[a:b]:
            a, b = 0, len(src)
        cs.check(src[a:b].count(old) == 1, f"{name}: edit target not "
                                           f"unique: {old[:60]!r}")
        src = src[:a] + src[a:b].replace(old, new) + src[b:]
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
        kernel = VARIANTS[name][0]
        entry = next(c for c in log.split("Compiling entry function")[1:]
                     if f"pcg_dense_{kernel}_kernel" in c.splitlines()[0])
        regs = int(re.search(r"Used (\d+) registers", entry).group(1))
        lib = ctypes.CDLL(str(so))
        f = getattr(lib, f"rb_pcg_dense_{kernel}_f32")
        f.argtypes = list(kernels._SIGNATURES["cg_dense"][
            f"rb_pcg_dense_{kernel}_f32"])
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
    if len(sys.argv) > 2:
        unknown = set(sys.argv[2:]) - set(VARIANTS)
        cs.check(not unknown, f"unknown variants {sorted(unknown)}")
        for name in list(VARIANTS):
            if name not in sys.argv[2:]:
                del VARIANTS[name]
    libs = build(kernels)
    dev = torch.device("cuda")
    stream = torch.cuda.current_stream().cuda_stream
    res = {"card": cs.smi_line(), "iters": ITERS,
           "registers": {k: v[1] for k, v in libs.items()}, "systems": {}}
    print(f"{res['card']}; registers per thread: {res['registers']}",
          flush=True)
    for N in sorted(set(SYSTEMS["cluster"]) | set(SYSTEMS["half"])):
        Nc = 128
        Hz, blocks, b = cs.spd_system(N, Nc, seed=N)
        Hz = torch.as_tensor(Hz, device=dev)
        Lp = cg_dense.chol_planes(chol9(torch.as_tensor(blocks, device=dev)),
                                  Nc)
        b2 = torch.zeros((9, Nc), device=dev)
        b2[:, :N] = torch.as_tensor(b, device=dev).T
        x2 = torch.empty((9, Nc), device=dev)
        stats = torch.empty(4, device=dev)
        names = [k for k, (kernel, _) in VARIANTS.items()
                 if N in SYSTEMS[kernel]
                 and not (k == "cluster8" and -(-9 * N // 8) > 80)]

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
            if "precond_off" not in name:
                cs.check(cs.close(got, ref, 2e-4, 2e-5),
                         f"{name} N={N}: max abs err {errs[name]}")
        times = {k: {0: [], ITERS: []} for k in names}
        for order in (names, names[::-1]):
            for name in order:
                kname = f"pcg_dense_{VARIANTS[name][0]}_kernel"
                for iters in (0, ITERS):
                    # without a trace that holds the kernel once per call
                    # (five taken), the sample is missing
                    ms, seen, _ = cs.traced_ms(lambda: launch(name, iters),
                                               kname)
                    if ms is not None:
                        times[name][iters].append(ms)
                    else:
                        print(f"N={N}: {name} at {iters} iterations: the "
                              f"kernel not once per call in five traces "
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
