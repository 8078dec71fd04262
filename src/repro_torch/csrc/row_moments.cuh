// The per-row moments kernel of K1 (fitpdf.cu, moments_edges_stats: stats
// and Eq.-5 edges) and K3 (moments.cu, moments_stats: stats only). One
// template, so the two compute the same stats bit for bit; K3 compiles the
// edges out.
//
// One warp owns one row, eight rows per 256-thread block. Lanes stride over
// the row (coalesced loads) and accumulate the shifted power sums s1..s4,
// min and max; a fixed __shfl_xor_sync butterfly reduces them, so every
// launch gives the same bits. The TPU kernels' sequential observation-chunk
// grid axis is this loop; the ragged tail needs no mask, since the loop
// stops at n.
#pragma once

#include "common.cuh"

namespace {

template <bool kEdges>
__global__ void __launch_bounds__(kThreads)
row_moments_kernel(const float* __restrict__ x, float* __restrict__ stats,
                   float* __restrict__ edges, int P, int n, int L) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * kRows + warp;
  if (row >= P) return;
  const float* xr = x + row * (long long)n;

  // Shift by the row's first observation: kills the float32 cancellation of
  // raw power sums (the reference kernel's formula, not the two-pass one).
  const float shift = __ldg(xr);
  float s1 = 0.0f, s2 = 0.0f, s3 = 0.0f, s4 = 0.0f;
  float mn = INFINITY, mx = -INFINITY;
  for (int j = lane; j < n; j += 32) {
    const float v = __ldg(xr + j);
    const float d = v - shift;
    const float d2 = d * d;
    const float d3 = d2 * d;
    s1 += d;
    s2 += d2;
    s3 += d3;
    s4 += d3 * d;
    mn = min_nan(mn, v);
    mx = max_nan(mx, v);
  }
  // Fixed-order butterfly: every lane ends with the same bits.
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    s1 += __shfl_xor_sync(kFull, s1, off);
    s2 += __shfl_xor_sync(kFull, s2, off);
    s3 += __shfl_xor_sync(kFull, s3, off);
    s4 += __shfl_xor_sync(kFull, s4, off);
    mn = min_nan(mn, __shfl_xor_sync(kFull, mn, off));
    mx = max_nan(mx, __shfl_xor_sync(kFull, mx, off));
  }

  // Finalize (repro/kernels/fitpdf/kernel.py:86-100, operation by operation).
  const float nf = (float)n;
  const float md = s1 / nf;
  const float e2 = s2 / nf, e3 = s3 / nf, e4 = s4 / nf;
  const float mdsq = md * md;
  const float m2 = max_nan(e2 - mdsq, 0.0f);
  const float m3 = e3 - 3.0f * md * e2 + 2.0f * (md * mdsq);
  const float m4 = e4 - 4.0f * md * e3 + 6.0f * md * md * e2 - 3.0f * (mdsq * mdsq);
  const float mean = shift + md;
  const float var = m2 * nf / max_nan(nf - 1.0f, 1.0f);
  const float sig = sqrtf(max_nan(m2, kEps));
  const float skew = m3 / (sig * (sig * sig));
  const float m2c = max_nan(m2, kEps);
  const float kurt = m4 / (m2c * m2c) - 3.0f;
  if (lane < 8) {
    const float out[8] = {mean, var, skew, kurt, mn, mx, 0.0f, 0.0f};
    stats[row * 8 + lane] = out[lane];
  }
  if constexpr (kEdges) {
    // Eq.-5 edges, vmin + span * k / L (pdf_error.interval_edges' order).
    const float span = max_nan(mx - mn, kEps);
    float* er = edges + row * (long long)(L + 1);
    for (int k = lane; k <= L; k += 32) er[k] = mn + span * (float)k / (float)L;
  }
}

}  // namespace
