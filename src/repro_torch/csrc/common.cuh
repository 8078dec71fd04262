// Shared by the row kernels of repro_torch (fitpdf.cu, moments.cu, hist.cu):
// the one-warp-per-row launch shape and NaN-propagating min/max.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kRows = 8;  // rows per block, one warp per row
constexpr int kThreads = kRows * 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kEps = 1e-12f;

// jnp.maximum / jnp.minimum / jnp.clip semantics: a NaN operand gives NaN
// (fmaxf / fminf would drop it, and the reference keeps the NaN of a
// degenerate row).
__device__ __forceinline__ float max_nan(float a, float b) {
  return (a != a || b != b) ? a + b : (a > b ? a : b);
}
__device__ __forceinline__ float min_nan(float a, float b) {
  return (a != a || b != b) ? a + b : (a < b ? a : b);
}
__device__ __forceinline__ float clip_nan(float v, float lo, float hi) {
  return min_nan(max_nan(v, lo), hi);
}

inline unsigned row_blocks(int P) { return (unsigned)((P + kRows - 1) / kRows); }

}  // namespace
