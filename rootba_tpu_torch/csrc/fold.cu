// K1: run-folded 9x9 block outer products.
//
//   out[r, a*9+b] = sum_{s in run r} sum_k s1[s, k*9+a] * s2[s, k*9+b]
//
// s1, s2: [M, K*9] slot-major strips (K = 2 for Jp, 3 for W), M = R * W,
// runs of W consecutive slots; out: [R, 81].
//
// Replaces rootba_tpu/ops/pallas_fold.py:191 outer81_fold_pallas (kernel
// _fold_kernel, :159-184). The TPU kernel expands every slot row with
// 0/1 matmuls and folds runs with a 0/1 selector matmul only because
// Mosaic has no lane repeat; none of that is carried over.
//
// What bounds it on an H100: memory. It reads 2*M*K*9 values, writes
// R*81 and does 2*M*K*81 flops, about 2.25 flops per byte in f32, far
// below the card's 20 flops/byte f32 ridge (67 TFLOP/s over 3.35 TB/s).
// A kernel with one thread per output (each of its W*K FMAs fed by two
// shared-memory loads, a division by 81 and by 9 per output), scalar
// 4-byte staging loads and one tile per block is bound by shared-memory
// load issue, at about 40 % of the byte bound on an H100. This one:
// - Bulk-copy pipeline. A tile of (64 / W) runs -- 64 slots, contiguous
//   in both strips -- comes into shared memory by two 1-D TMA bulk copies
//   (cp.async.bulk, completion on an mbarrier), three stages deep, in
//   persistent blocks (as many per SM as fit) that walk over tiles: two
//   tiles' copies are in flight while a tile's products are formed. The
//   ragged last tile (and every tile, when the strips are not 16-byte
//   aligned or a tile is not a multiple of 16 bytes) comes by ordinary
//   loads.
// - Register blocking. Nine 3x3 blocks cover a run's 81 outputs; each
//   block's sums stay in registers, so each shared-memory value feeds 3
//   FMAs (against 0.5 with one output per thread) and no thread divides.
//   Up to 4 threads share a block, each over every 4th slot of the run,
//   while each keeps at least 6 (slot, k) products, and add their partial
//   sums by shuffle: a tile's products take a quarter of the latency,
//   with four times the warps to hide it.
// - Output. A tile's runs' outputs are contiguous in out; they are staged
//   in shared memory and leave by one TMA bulk store per tile, so no
//   thread waits on them. Index arithmetic is 32-bit where M*K*9 and
//   R*81 fit.
// What still holds it short of the byte bound on an H100 is not measured
// yet (PERF.md, open questions).
//
// Plain C interface for ctypes; every entry returns the CUDA error code.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kTileSlots = 64;  // slots per tile (W <= 64)
constexpr int kStages = 3;
// a tile's outputs leave by a TMA bulk store that reads its buffer after
// the tile's barrier; three buffers let the writes of tile it+1 proceed
// while the stores of tiles it and it-1 may still read theirs
constexpr int kOutBufs = 3;
constexpr int kMaxSplit = 4;     // threads that share a 3x3 output block
constexpr int kMinProducts = 6;  // (slot, k) products per thread, at least
// an 8-byte mbarrier per stage ahead of the tiles, which start 16-byte
// aligned
constexpr int kBarBytes = (8 * kStages + 15) / 16 * 16;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// A 1-D TMA bulk store of `bytes` (a multiple of 16, both ends 16-byte
// aligned) from this CTA's shared memory to global memory, committed as
// one bulk group.
__device__ __forceinline__ void bulk_store(void* dst, const void* src,
                                           uint32_t bytes) {
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
      "cp.async.bulk.commit_group;\n" ::"l"(dst),
      "r"(smem_u32(src)), "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// out[0, n) = src[0, n): 16-byte stores over the aligned middle, scalar
// stores at the ends.
template <typename T>
__device__ void store_out(const T* src, T* dst, int n) {
  constexpr int V = 16 / sizeof(T);
  const int misalign =
      static_cast<int>((reinterpret_cast<uintptr_t>(dst) & 15) / sizeof(T));
  const int head = min(n, misalign == 0 ? 0 : V - misalign);
  const int nv = (n - head) / V;
  for (int e = threadIdx.x; e < head; e += blockDim.x) dst[e] = src[e];
  for (int v = threadIdx.x; v < nv; v += blockDim.x) {
    const T* s = src + head + v * V;
    if constexpr (sizeof(T) == 4) {
      *reinterpret_cast<float4*>(dst + head + v * V) =
          make_float4(s[0], s[1], s[2], s[3]);
    } else {
      *reinterpret_cast<double2*>(dst + head + v * V) =
          make_double2(s[0], s[1]);
    }
  }
  for (int e = head + nv * V + threadIdx.x; e < n; e += blockDim.x) {
    dst[e] = src[e];
  }
}

// Shared memory: an mbarrier per stage, kStages x (s1 tile, s2 tile),
// kOutBufs output buffers of rpt*81.
template <typename T>
size_t smem_bytes(int K9, int rpt, int W) {
  return kBarBytes +
         sizeof(T) * (2 * static_cast<size_t>(kStages) * rpt * W * K9 +
                      kOutBufs * static_cast<size_t>(rpt) * 81);
}

template <typename T, int K, typename I>
__global__ void __launch_bounds__(1024)
outer81_fold_kernel(const T* __restrict__ s1, const T* __restrict__ s2,
                    T* __restrict__ out, I R, int W, int rpt, I num_tiles,
                    I bulk_tiles, int bulk_out, int split) {
  constexpr int K9 = 9 * K;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem_raw);
  const int tile_elems = rpt * W * K9;
  T* tiles = reinterpret_cast<T*>(smem_raw + kBarBytes);
  T* obuf = tiles + 2 * kStages * tile_elems;
  const uint32_t tile_bytes = static_cast<uint32_t>(tile_elems * sizeof(T));
  const int tid = threadIdx.x;
  const I G = gridDim.x;

  if (tid == 0 && bulk_tiles > 0) {
    for (int s = 0; s < kStages; ++s) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                       smem_u32(bars + s))
                   : "memory");
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  auto issue = [&](int s, I t) {
    const uint32_t bar = smem_u32(bars + s);
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                     "r"(bar),
                 "r"(2 * tile_bytes)
                 : "memory");
    bulk_load(tiles + (2 * s) * tile_elems, s1 + t * tile_elems, tile_bytes,
              bar);
    bulk_load(tiles + (2 * s + 1) * tile_elems, s2 + t * tile_elems,
              tile_bytes, bar);
  };
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      const I t = static_cast<I>(blockIdx.x) + s * G;
      if (t < bulk_tiles) issue(s, t);
    }
  }

  // thread -> (run of the tile, 3x3 block of its 81 outputs, which of
  // the `split` threads of that block: it takes slots h, h + split, ...)
  const int qb = tid / split;
  const int h = tid - qb * split;
  const int rl = qb / 9;
  const int part = qb - rl * 9;
  const int pa = part / 3;
  const int pb = part - pa * 3;
  const int rlc = min(rl, rpt - 1);  // threads past the runs read a run
  int it = 0;
  for (I t = blockIdx.x; t < num_tiles; t += G, ++it) {
    const int s = it % kStages;
    T* A = tiles + (2 * s) * tile_elems;
    T* B = A + tile_elems;
    T* O = obuf + (it % kOutBufs) * rpt * 81;
    const int runs = static_cast<int>(
        min(static_cast<I>(rpt), R - t * static_cast<I>(rpt)));
    if (t < bulk_tiles) {
      mbar_wait(smem_u32(bars + s),
                static_cast<uint32_t>((it / kStages) & 1));
    } else {
      const int ne = runs * W * K9;
      const T* g1 = s1 + t * tile_elems;
      const T* g2 = s2 + t * tile_elems;
      for (int e = tid; e < ne; e += blockDim.x) {
        A[e] = g1[e];
        B[e] = g2[e];
      }
      __syncthreads();
    }
    {
      const T* a = A + rlc * W * K9 + 3 * pa;
      const T* b = B + rlc * W * K9 + 3 * pb;
      T acc[3][3] = {};
#pragma unroll 2
      for (int w = h; w < W; w += split) {
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const int o = w * K9 + k * 9;
          const T a0 = a[o], a1 = a[o + 1], a2 = a[o + 2];
          const T b0 = b[o], b1 = b[o + 1], b2 = b[o + 2];
          acc[0][0] = fma(a0, b0, acc[0][0]);
          acc[0][1] = fma(a0, b1, acc[0][1]);
          acc[0][2] = fma(a0, b2, acc[0][2]);
          acc[1][0] = fma(a1, b0, acc[1][0]);
          acc[1][1] = fma(a1, b1, acc[1][1]);
          acc[1][2] = fma(a1, b2, acc[1][2]);
          acc[2][0] = fma(a2, b0, acc[2][0]);
          acc[2][1] = fma(a2, b1, acc[2][1]);
          acc[2][2] = fma(a2, b2, acc[2][2]);
        }
      }
      // the block's `split` partial sums sit on consecutive lanes
      for (int x = 1; x < split; x <<= 1) {
#pragma unroll
        for (int u = 0; u < 3; ++u) {
#pragma unroll
          for (int v = 0; v < 3; ++v) {
            acc[u][v] += __shfl_xor_sync(0xffffffffu, acc[u][v], x);
          }
        }
      }
      if (rl < runs && h == 0) {
        T* o = O + rl * 81 + 27 * pa + 3 * pb;
#pragma unroll
        for (int u = 0; u < 3; ++u) {
#pragma unroll
          for (int v = 0; v < 3; ++v) o[9 * u + v] = acc[u][v];
        }
      }
    }
    // O's writes, before the async proxy (the bulk store) reads them
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    // every thread is done with stage s's tiles, and O is complete
    __syncthreads();
    T* dst = out + t * static_cast<I>(rpt) * 81;
    const bool whole = bulk_out && runs == rpt;
    if (tid == 0) {
      const I tn = t + kStages * G;
      if (tn < bulk_tiles) issue(s, tn);
      if (whole) {
        bulk_store(dst, O, static_cast<uint32_t>(rpt * 81 * sizeof(T)));
        // the store of the tile before this one has read its buffer, so
        // the next tile may write that buffer's successor
        asm volatile("cp.async.bulk.wait_group.read 1;\n" ::: "memory");
      }
    }
    if (!whole) store_out(O, dst, runs * 81);
  }
  if (tid == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

template <typename T, int K, typename I>
int launch_k(const T* s1, const T* s2, T* out, long long M, int W,
             cudaStream_t stream) {
  constexpr int K9 = 9 * K;
  const long long R = M / W;
  const int rpt = W >= kTileSlots ? 1 : kTileSlots / W;
  const long long num_tiles = (R + rpt - 1) / rpt;
  // up to kMaxSplit threads per 3x3 output block while each keeps at
  // least kMinProducts (slot, k) products of its run, and the block at
  // most 1024 threads
  int split = 1;
  while (2 * split <= kMaxSplit && W * K >= 2 * split * kMinProducts &&
         rpt * 9 * 2 * split <= 1024) {
    split *= 2;
  }
  const int threads = ((rpt * 9 * split + 31) / 32) * 32;
  const size_t smem = smem_bytes<T>(K9, rpt, W);
  const size_t tile_bytes = static_cast<size_t>(rpt) * W * K9 * sizeof(T);
  const bool aligned = (reinterpret_cast<uintptr_t>(s1) & 15) == 0 &&
                       (reinterpret_cast<uintptr_t>(s2) & 15) == 0 &&
                       tile_bytes % 16 == 0;
  const long long bulk_tiles = aligned ? R / rpt : 0;
  const int bulk_out = (reinterpret_cast<uintptr_t>(out) & 15) == 0 &&
                       (rpt * 81 * sizeof(T)) % 16 == 0;
  auto kernel = outer81_fold_kernel<T, K, I>;
  // set up once per instantiation (the main path launches K1 tens of
  // times per LM attempt): the shared-memory limit at the largest size
  // any run width takes (W = 1: 64 runs of outputs), the SM count, and
  // the blocks per SM for each run width
  static int sms = 0;
  static int per_sm_by_width[kTileSlots + 1] = {};
  cudaError_t err = cudaSuccess;
  if (sms == 0) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem_bytes<T>(K9, kTileSlots, 1)));
    if (err != cudaSuccess) return static_cast<int>(err);
    int dev = 0;
    err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  int& per_sm = per_sm_by_width[W];
  if (per_sm == 0) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        threads, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  long long blocks = static_cast<long long>(sms) * per_sm;
  if (blocks > num_tiles) blocks = num_tiles;
  kernel<<<static_cast<unsigned>(blocks), threads, smem, stream>>>(
      s1, s2, out, static_cast<I>(R), W, rpt, static_cast<I>(num_tiles),
      static_cast<I>(bulk_tiles), bulk_out, split);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const T* s1, const T* s2, T* out, long long M, int K9, int W,
           cudaStream_t stream) {
  if (W < 1 || W > kTileSlots || M % W != 0 || (K9 != 18 && K9 != 27)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (M == 0) return static_cast<int>(cudaSuccess);
  // 32-bit offsets when every input and output offset fits
  const bool small = M * K9 < INT_MAX && (M / W) * 81 < INT_MAX;
  if (K9 == 18) {
    return small ? launch_k<T, 2, int>(s1, s2, out, M, W, stream)
                 : launch_k<T, 2, long long>(s1, s2, out, M, W, stream);
  }
  return small ? launch_k<T, 3, int>(s1, s2, out, M, W, stream)
               : launch_k<T, 3, long long>(s1, s2, out, M, W, stream);
}

}  // namespace

extern "C" int rb_outer81_fold_f32(const float* s1, const float* s2,
                                   float* out, long long M, int K9, int W,
                                   void* stream) {
  return launch<float>(s1, s2, out, M, K9, W,
                       static_cast<cudaStream_t>(stream));
}

extern "C" int rb_outer81_fold_f64(const double* s1, const double* s2,
                                   double* out, long long M, int K9, int W,
                                   void* stream) {
  return launch<double>(s1, s2, out, M, K9, W,
                        static_cast<cudaStream_t>(stream));
}
