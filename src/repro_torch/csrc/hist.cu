// Hopper (sm_90a) kernel of the `kernels` fit backend: repro_torch.kernels.hist.
//
// hist_counts  replaces repro/kernels/hist/kernel.py::hist_counts (Pallas,
//              _hist_kernel): per row, the count of observations in each of
//              the L evenly split intervals of [vmin, vmax] (Eq. 5), as
//              (P, L) float32.
//
// It is K2's histogram phase (row_hist.cuh) without the CDF epilogue: one
// warp per row counts into L int counters in shared memory with integer
// atomicAdd (exact and order-free), then writes them out as float. The bin
// is computed as K2 computes it, so the counts are exact. It reads the (P, n)
// float32 window once and writes 4L bytes a row: bound by those bytes.
//
// Build and interface as fitpdf.cu.

#include "row_hist.cuh"

namespace {

__global__ void __launch_bounds__(kThreads)
hist_counts_kernel(const float* __restrict__ x, const float* __restrict__ vmin,
                   const float* __restrict__ vmax, float* __restrict__ counts,
                   int P, int n, int L) {
  extern __shared__ int smem[];  // int hist[kRows][L]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * kRows + warp;
  if (row >= P) return;  // warps are independent: only __syncwarp inside
  int* hist = smem + warp * L;
  warp_row_histogram(x + row * (long long)n, n, vmin[row], vmax[row], L, hist, lane);
  float* out = counts + row * (long long)L;
  for (int k = lane; k < L; k += 32) out[k] = (float)hist[k];
}

}  // namespace

extern "C" {

size_t hist_smem_bytes(int L) { return (size_t)kRows * (size_t)L * sizeof(int); }

int hist_counts(const float* x, const float* vmin, const float* vmax, float* counts,
                int P, int n, int L, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  hist_counts_kernel<<<row_blocks(P), kThreads, hist_smem_bytes(L), (cudaStream_t)stream>>>(
      x, vmin, vmax, counts, P, n, L);
  return (int)cudaGetLastError();
}

const char* hist_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
