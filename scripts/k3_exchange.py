#!/usr/bin/env python3
"""The grid K3's exchange between CTAs, timed on its own on one card.

    python3 scripts/k3_exchange.py [OUT.json]

One CTA of 256 threads per SM (a cooperative launch, as the grid kernel)
runs ROUNDS exchanges; in each, every CTA publishes a float4 partial,
all CTAs wait for all, and warp 0 sums the partials in one fixed order
(csrc/cg_dense.cu grid_sum4). Four ways to wait:

  grid_sync -- cooperative_groups grid.sync() (the old grid kernel's);
  counter   -- one counter: thread 0 adds 1 with a release reduction and
               polls it with acquire loads until it reaches G e;
  flags     -- a flag per CTA: thread 0 stores e with a release store,
               warp 0 polls all G flags with acquire loads (each lane's
               acquire loads complete one after another);
  flags_relaxed -- the same flags polled with relaxed loads, then one
               acquire fence per lane.

The grid kernel takes the counter (csrc/cg_dense.cu grid_arrive_wait).

Prints one JSON object, microseconds per exchange (CUDA events over the
whole launch / ROUNDS), the card's name and power limit; writes it to
OUT.json when given. The source is compiled by nvcc into
build/k3_exchange/.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

ROUNDS = 20000
VARIANTS = ("grid_sync", "counter", "flags", "flags_relaxed")

SRC = r"""
#include <cooperative_groups.h>
#include <cuda_runtime.h>
namespace cg = cooperative_groups;

__device__ __forceinline__ unsigned ld_relaxed(const unsigned* p) {
  unsigned v;
  asm volatile("ld.relaxed.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p)
               : "memory");
  return v;
}

template <int V>
__global__ void __launch_bounds__(256, 1)
xchg(float4* part, unsigned* sync, int rounds, float* out) {
  const int G = gridDim.x, t = blockIdx.x, tid = threadIdx.x;
  float acc = 0.f;
  for (int e = 1; e <= rounds; ++e) {
    float4* buf = part + (e & 1) * G;
    if (tid == 0) buf[t] = make_float4(acc + t, 1.f, 2.f, 3.f);
    if (V == 0) {
      cg::this_grid().sync();
    } else if (V == 1) {
      __syncthreads();
      if (tid == 0) {
        asm volatile("red.release.gpu.global.add.u32 [%0], 1;" ::"l"(sync)
                     : "memory");
        while (ld_acquire(sync) < static_cast<unsigned>(G) * e) {
        }
      }
      __syncthreads();
    } else {
      __syncthreads();
      if (tid < 32) {
        if (tid == 0) {
          asm volatile("st.release.gpu.global.u32 [%0], %1;" ::"l"(sync + t),
                       "r"(e) : "memory");
        }
        bool ok;
        do {
          ok = true;
          for (int k = tid; k < G; k += 32) {
            const unsigned f = V == 2 ? ld_acquire(sync + k)
                                      : ld_relaxed(sync + k);
            ok = ok && f >= static_cast<unsigned>(e);
          }
        } while (!__all_sync(0xffffffffu, ok));
        if (V == 3) asm volatile("fence.acq_rel.gpu;" ::: "memory");
      }
    }
    if (tid < 32) {
      float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int k = tid; k < G; k += 32) {
        const float4 v = __ldcg(buf + k);
        s.x += v.x; s.y += v.y; s.z += v.z; s.w += v.w;
      }
      for (int o = 16; o > 0; o >>= 1) {
        s.x += __shfl_xor_sync(0xffffffffu, s.x, o);
      }
      acc = s.x * 1e-9f;
    }
    if (V == 1) __syncthreads();  // the next round's release follows it
  }
  if (t == 0 && tid == 0) out[0] = acc;
}

extern "C" int rb_xchg(int variant, void* part, unsigned* sync, int rounds,
                       float* out, void* stream) {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  void* fn = variant == 0 ? (void*)xchg<0>
             : (variant == 1 ? (void*)xchg<1>
                             : (variant == 2 ? (void*)xchg<2>
                                             : (void*)xchg<3>));
  cudaError_t err = cudaMemsetAsync(sync, 0, sizeof(unsigned) * sms,
                                    (cudaStream_t)stream);
  if (err != cudaSuccess) return err;
  void* args[] = {&part, &sync, &rounds, &out};
  err = cudaLaunchCooperativeKernel(fn, dim3(sms), dim3(256), args, 0,
                                    (cudaStream_t)stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}
"""


def build() -> Path:
    from rootba_tpu_torch.ops import kernels

    out = ROOT / "build" / "k3_exchange"
    out.mkdir(parents=True, exist_ok=True)
    src = out / "xchg.cu"
    src.write_text(SRC)
    lib = out / "libxchg.so"
    subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-o", str(lib),
                    str(src)], check=True)
    return lib


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("k3_exchange: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs

    lib = ctypes.CDLL(str(build()))
    lib.rb_xchg.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                            ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    lib.rb_xchg.restype = ctypes.c_int
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    part = torch.zeros(2 * sms, 4, device=dev)
    sync = torch.zeros(sms, dtype=torch.int32, device=dev)
    out = torch.zeros(1, device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    res = {"card": cs.smi_line(), "ctas": sms, "rounds": ROUNDS,
           "us_per_exchange": {}}
    for order in (VARIANTS, VARIANTS[::-1]):
        for v in order:
            def run(v=v):
                cs.check(lib.rb_xchg(VARIANTS.index(v), part.data_ptr(),
                                     sync.data_ptr(), ROUNDS,
                                     out.data_ptr(), stream) == 0,
                         f"k3_exchange {v}: launch refused")
            ms = cs.cuda_ms(run, reps=3, warmup=1)
            res["us_per_exchange"].setdefault(v, []).append(
                1e3 * ms / ROUNDS)
    line = json.dumps(res)
    print(line)
    if len(sys.argv) > 1:
        Path(sys.argv[1]).write_text(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
