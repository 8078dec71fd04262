// Hopper (sm_90a) kernel of the `kernels` fit backend: repro_torch.kernels.hist.
//
// hist_counts  replaces repro/kernels/hist/kernel.py::hist_counts (Pallas,
//              _hist_kernel): per row, the count of observations in each of
//              the L evenly split intervals of [vmin, vmax] (Eq. 5), as
//              (P, L) float32.
//
// It is K2's histogram phase (row_hist.cuh) without the CDF epilogue: one
// block of 128 threads a row, every 16-byte load of the row in flight at
// once, integer atomicAdd into one histogram of L counters in shared memory
// (exact and order-free), written out as float. The bin is computed as K2
// computes it, so the counts are exact. It reads the (P, n) float32 window
// once and writes 4L bytes a row: bound by those bytes. Its time on a Set1
// window is that read, then the bin and atomic of every value.
//
// Build and interface as fitpdf.cu.

#include "row_hist.cuh"

namespace {

__global__ void __launch_bounds__(kHistThreads)
hist_counts_kernel(const float* __restrict__ x, const float* __restrict__ vmin,
                   const float* __restrict__ vmax, float* __restrict__ counts, int n, int L) {
  extern __shared__ int hist[];  // L ints
  const long long row = blockIdx.x;
  block_row_histogram(x + row * (long long)n, n, vmin[row], vmax[row], L, hist);
  float* out = counts + row * (long long)L;
  for (int k = threadIdx.x; k < L; k += kHistThreads) out[k] = (float)hist[k];
}

}  // namespace

extern "C" {

size_t hist_smem_bytes(int L) { return (size_t)L * sizeof(int); }

int hist_counts(const float* x, const float* vmin, const float* vmax, float* counts,
                int P, int n, int L, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  hist_counts_kernel<<<(unsigned)P, kHistThreads, hist_smem_bytes(L), (cudaStream_t)stream>>>(
      x, vmin, vmax, counts, n, L);
  return (int)cudaGetLastError();
}

// attributes[0..2] = registers a thread, local memory bytes a thread
// (nonzero if it spills), dynamic shared memory bytes a block at L bins.
int hist_attributes(int L, int* attributes) {
  cudaFuncAttributes a;
  cudaError_t e = cudaFuncGetAttributes(&a, hist_counts_kernel);
  attributes[0] = a.numRegs;
  attributes[1] = (int)a.localSizeBytes;
  attributes[2] = (int)hist_smem_bytes(L);
  return (int)e;
}

const char* hist_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
