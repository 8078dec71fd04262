// The per-row Eq.-5 histogram of K2 (fitpdf.cu, fit_error_counts) and K4
// (hist.cu, hist_counts): one warp counts one row into L int counters in
// shared memory. Integer atomicAdd is exact and order-free, so the counts
// do not depend on the order the lanes add in.
#pragma once

#include "common.cuh"

namespace {

// floor((x - lo) / span * L), clipped to [0, L-1] in float before the cast
// (repro/kernels/fitpdf/kernel.py:178-179, hist/kernel.py:37-38). The
// IEEE-rounded intrinsics pin each step, so the bin equals the plain
// version's.
__device__ __forceinline__ int interval_bin(float v, float lo, float span, float fl, float top) {
  const float b = floorf(__fmul_rn(__fdiv_rn(__fsub_rn(v, lo), span), fl));
  return (int)clip_nan(b, 0.0f, top);  // (int)NaN is 0 on the device
}

// Zeroes hist[0, L), counts the n values of row xr into it and leaves the
// counts visible to the whole warp.
__device__ __forceinline__ void warp_row_histogram(const float* __restrict__ xr, int n, float lo,
                                                   float hi, int L, int* hist, int lane) {
  for (int k = lane; k < L; k += 32) hist[k] = 0;
  __syncwarp();
  const float span = max_nan(hi - lo, kEps);
  const float fl = (float)L, top = (float)(L - 1);
  for (int j = lane; j < n; j += 32) atomicAdd(hist + interval_bin(__ldg(xr + j), lo, span, fl, top), 1);
  __syncwarp();
}

}  // namespace
