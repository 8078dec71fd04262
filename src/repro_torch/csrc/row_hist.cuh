// The per-row Eq.-5 histogram of K2 (fitpdf.cu, fit_error_counts) and K4
// (hist.cu, hist_counts): one block of kHistThreads threads counts one row.
//
// What bounds it: the row's bytes, read once. What held the one-warp-a-row
// design back was the loads: one 4-byte load a lane in flight, 32 dependent
// trips for a 1,000-value row. Here the block's 128 threads issue every
// 16-byte load of their share of the row at once (kHistLoads a thread: up
// to 2,048 values a round; a scalar head and tail around the 16-byte-aligned
// body, so any n works); on a Set1 window that read takes what PyTorch's
// own row sum takes. The counts go to one histogram of int counters in
// shared memory: on an H100 the lanes of a warp that add to one shared
// counter do not serialise measurably (a row with every value in one bin
// costs no more), so the counters are not replicated. Integer atomicAdd is
// exact and order-free, so the counts equal the plain version's and do not
// depend on which thread read a value.
//
// Any L: a launch counts a chunk of the bins, C = L unless the kernel's
// route says otherwise (K4: hist_counts_route, K2: fit_error_chunk); each
// chunk's launch reads the rows again and counts only the values whose bin
// lies in it. K4 runs the chunk test for every L (one chunk costs it
// nothing measurable); K2's one-chunk route is its own instantiation
// (kChunked false, no chunk test), because its chunked code at one chunk
// took 11 % longer at L = 64 (PERF.md).
#pragma once

#include "common.cuh"

namespace {

constexpr int kHistThreads = 128;  // one row a block, four warps
constexpr int kHistWarps = kHistThreads / 32;
constexpr int kHistLoads = 4;      // 16-byte loads a thread keeps in flight
constexpr size_t kDefaultSmem = 48 * 1024;  // dynamic shared memory a block gets without opting in

// floor((x - lo) / span * L), clipped to [0, L-1] in float before the cast
// (repro/kernels/fitpdf/kernel.py:178-179, hist/kernel.py:37-38). The
// IEEE-rounded intrinsics pin each step, so the bin equals the plain
// version's.
__device__ __forceinline__ int interval_bin(float v, float lo, float span, float fl, float top) {
  const float b = floorf(__fmul_rn(__fdiv_rn(__fsub_rn(v, lo), span), fl));
  return (int)clip_nan(b, 0.0f, top);  // (int)NaN is 0 on the device
}

// Counts the values of row xr (n of them) whose bin lies in [c0, c0 + C)
// into hist[0, C) (shared ints) and leaves the counts there, visible to the
// whole block; without kChunked, C = L and c0 = 0, and every value counts.
// Every thread of the block calls it.
template <bool kChunked>
__device__ __forceinline__ void block_row_histogram(const float* __restrict__ xr, int n, float lo,
                                                    float hi, int L, int c0, int C, int* hist) {
  const int tid = threadIdx.x;
  for (int k = tid; k < C; k += kHistThreads) hist[k] = 0;
  __syncthreads();
  const float span = max_nan(hi - lo, kEps);
  const float fl = (float)L, top = (float)(L - 1);
  auto count = [&](float v) {
    const int b = interval_bin(v, lo, span, fl, top);
    if constexpr (kChunked) {
      if ((unsigned)(b - c0) < (unsigned)C) atomicAdd(hist + (b - c0), 1);  // repro: allow[DET]: int count, exact in any order
    } else {
      atomicAdd(hist + b, 1);  // repro: allow[DET]: int count, exact in any order
    }
  };

  // Scalar head up to the first 16-byte boundary, float4 body, scalar tail.
  const int head = min(n, (int)((4 - (((uintptr_t)xr >> 2) & 3)) & 3));
  const int nv = (n - head) >> 2, tail = head + 4 * nv;
  if (tid < head) count(__ldg(xr + tid));
  if (tid < n - tail) count(__ldg(xr + tail + tid));
  const float4* xv = reinterpret_cast<const float4*>(xr + head);
  for (int base = 0; base < nv; base += kHistThreads * kHistLoads) {
    float4 v[kHistLoads];
#pragma unroll
    for (int u = 0; u < kHistLoads; ++u) {
      const int j = base + u * kHistThreads + tid;
      if (j < nv) v[u] = __ldg(xv + j);
    }
#pragma unroll
    for (int u = 0; u < kHistLoads; ++u) {
      if (base + u * kHistThreads + tid < nv) {
        count(v[u].x);
        count(v[u].y);
        count(v[u].z);
        count(v[u].w);
      }
    }
  }
  __syncthreads();
}

// Lets `kernel` take `smem` bytes of dynamic shared memory: past the
// default 48 KB only after opting in.
template <class Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= kDefaultSmem) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

}  // namespace
