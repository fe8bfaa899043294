#!/usr/bin/env python3
"""Where a CG iteration of K3's half kernel spends its time, on one card.

    python3 scripts/k3_phases.py

Builds csrc/cg_dense.cu with clock64() stamps added to the half kernel
(a text edit, as scripts/k3_variants.py makes its variants, into
build/k3_variants/) and runs it for 20 fixed CG iterations on
chip_smoke.spd_system(N, 128, seed N) at N = 49, 92 and 126. Prints, for
thread 0 of CTA 0, the cycles per iteration of each phase of the loop
(the end of the last iteration to the next's start, the p update, round
1 of the product, its wait, round 2, its wait, the rest up to the
preconditioner) and the parts of round 1 (the chunk loop over the
warp's rows with the rows' butterflies, the combine of the warps'
column sums, the sends). The stamped kernel's x is not the
twin's: its padded lanes carry the phase sums.
"""
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "scripts"))
sys.path.insert(0, str(ROOT))
import torch  # noqa: E402

import k3_variants as kv  # noqa: E402
import chip_smoke as cs  # noqa: E402
from rootba_tpu_torch.ops import cg_dense, kernels  # noqa: E402
from rootba_tpu_torch.ops.block9 import chol9  # noqa: E402

PH = "    const uint32_t phase = static_cast<uint32_t>(((i - 1) >> 1) & 1);\n"
R1 = "    half_round1(false, pb, pb,"
W1 = "    mbar_wait(bar + pb, phase);\n"
W2 = "    mbar_wait(bar + 2 + pb, phase);\n"
PC = "    float xbr = 0.f;\n    float rr2 = 0.f;\n    rz = 0.f;\n    if (own) {\n      solve9("
END = "      stats[3] = norm_r;\n    }\n  }\n}\n\n}  // namespace"
LOOP = "  while (term == kRunning && i < max_iters) {\n    ++i;\n    const bool fail_rho = rho == 0.f || isinf(rho);\n    const float beta = fdiv(rho, last_rho == 0.f ? 1.f : last_rho);\n    const bool fail_beta = i > 1 && (beta == 0.f || isinf(beta));\n    const int pb = i & 1;\n    const uint32_t phase"
edits = [
    (LOOP, "  long long tp = clock64();\n  float dph[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};\n" + LOOP),
    (PH, PH + "    { long long tn = clock64(); dph[0] += (float)(tn - tp); tp = tn; }\n"),
    (R1, "    { long long tn = clock64(); dph[1] += (float)(tn - tp); tp = tn; }\n" + R1),
    (W1, "    { long long tn = clock64(); dph[2] += (float)(tn - tp); tp = tn; }\n" + W1 + "    { long long tn = clock64(); dph[3] += (float)(tn - tp); tp = tn; }\n"),
    (W2, "    { long long tn = clock64(); dph[4] += (float)(tn - tp); tp = tn; }\n" + W2 + "    { long long tn = clock64(); dph[5] += (float)(tn - tp); tp = tn; }\n"),
    (PC, "    { long long tn = clock64(); dph[6] += (float)(tn - tp); tp = tn; }\n" + PC),
    (END, "      stats[3] = norm_r;\n    }\n  }\n  __syncthreads();\n  if (tid == 0 && rank == 0) for (int k = 0; k < 7; ++k) x_out[k * Nc + Nc - 1] = dph[k];\n}\n\n}  // namespace"),
]
G = "// Round 1 of the product H v"
TAIL = ("x_out, stats, N, Nc, pairs_per, max_iters, min_iters,\n"
        "                        q_tol, r_tol, reset_period);\n}\n")
R1_START = "  const float* row[kHRows];"
BUF = "  // chain j: the other parity's q, Hx, the other parity's receive slots\n"
SENDS = "  const uint32_t rcs = smem_u32(sm.cs + (pb * kCluster + rank) * rows_pp);\n"
FEND = "      st_async4(map_rank(rcs + 4 * (dst & 0xffff), t), a, map_rank(bar, t));\n    }\n  }\n}\n\n// Round 2"
edits += [
    (G, "__device__ unsigned long long g_ph[4];\n" + G),
    (R1_START, "  const long long c0 = clock64();\n" + R1_START),
    (BUF, "  const long long c1 = clock64();\n" + BUF),
    (SENDS, "  const long long c2 = clock64();\n" + SENDS),
    (FEND, "      st_async4(map_rank(rcs + 4 * (dst & 0xffff), t), a, map_rank(bar, t));\n    }\n  }\n  const long long c3 = clock64();\n  if (threadIdx.x == 0 && rank == 0) { atomicAdd(&g_ph[0], c1 - c0); atomicAdd(&g_ph[1], c2 - c1); atomicAdd(&g_ph[2], c3 - c2); atomicAdd(&g_ph[3], 1ull); }\n}\n\n// Round 2"),
    (TAIL, TAIL + "\nextern \"C\" int rb_read_ph(unsigned long long* out) {\n  int e = (int)cudaMemcpyFromSymbol(out, g_ph, 32);\n  unsigned long long z[4] = {0, 0, 0, 0};\n  cudaMemcpyToSymbol(g_ph, z, 32);\n  return e;\n}\n"),
]
kv.VARIANTS = {"half_clock": ("half", edits)}
src = kv.variant_source("half_clock")
libs = kv.build(kernels)
f = libs["half_clock"][0]
import ctypes  # noqa: E402
lib = ctypes.CDLL(str(kv.BUILD / "libhalf_clock.so"))
lib.rb_read_ph.argtypes = [ctypes.c_void_p]
dev = torch.device("cuda")
stream = torch.cuda.current_stream().cuda_stream
names = ["tail(precond,csum3,scalars)", "p update+sync", "round1 compute+send",
         "wait round1", "round2", "wait round2", "alpha,x,r/reset"]
for N in (49, 92, 126):
    Nc = 128
    Hz, blocks, b = cs.spd_system(N, Nc, seed=N)
    Hz = torch.as_tensor(Hz, device=dev)
    Lp = cg_dense.chol_planes(chol9(torch.as_tensor(blocks, device=dev)), Nc)
    b2 = torch.zeros((9, Nc), device=dev)
    b2[:, :N] = torch.as_tensor(b, device=dev).T
    x2 = torch.zeros((9, Nc), device=dev)
    st = torch.empty(4, device=dev)
    lib.rb_read_ph((ctypes.c_ulonglong * 4)())
    for rep in range(3):
        kernels.check(f(Hz.data_ptr(), b2.data_ptr(), Lp.data_ptr(), x2.data_ptr(),
                        st.data_ptr(), N, Nc, 20, 0, float("-inf"), -1.0, 10, stream), "clock")
    torch.cuda.synchronize()
    v = x2[:7, Nc - 1].tolist()
    ph = (ctypes.c_ulonglong * 4)()
    lib.rb_read_ph(ph)
    calls = max(ph[3], 1)
    print(f"N={N} round1 parts per call (rank 0, thread 0): chunk loop "
          f"{ph[0] / calls:.0f}, combine {ph[1] / calls:.0f}, sends "
          f"{ph[2] / calls:.0f} cycles ({ph[3]} calls)", flush=True)
    print(f"N={N} iters={int(st[0])} rank0 cycles per iteration: " + ", ".join(
        f"{n} {c / 20:.0f}" for n, c in zip(names, v)), flush=True)
