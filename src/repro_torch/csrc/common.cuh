// Shared by the row kernels of repro_torch (fitpdf.cu, moments.cu, hist.cu):
// NaN-propagating min/max and the warp's full mask.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

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

}  // namespace
