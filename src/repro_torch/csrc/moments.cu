// Hopper (sm_90a) kernel of the `kernels` fit backend: repro_torch.kernels.moments.
//
// moments_stats  replaces repro/kernels/moments/kernel.py::moments_stats
//                (Pallas, _moments_kernel): per-row shifted power sums, min
//                and max over the observation axis, finalized into the (P, 8)
//                stats [mean, var (unbiased), skew, kurt, min, max, 0, 0].
//
// It is K1's kernel (row_moments.cuh) with the Eq.-5 edges compiled out, so
// its stats equal K1's bit for bit: a warp a row, every 16-byte load of a
// lane's share in flight at once, sums in an order fixed by n alone. It reads the (P, n) float32 window once and writes 32 bytes a
// row: bound by those bytes, about ten float operations per value.
//
// Build and interface as fitpdf.cu: nvcc into a plain-C shared library,
// loaded with ctypes; the function launches on the given stream, allocates
// nothing and returns cudaGetLastError() of its launch.

#include "row_moments.cuh"

extern "C" {

int moments_stats(const float* x, float* stats, int P, int n, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  row_moments_kernel<false><<<mom_blocks(P), kMomThreads, 0, (cudaStream_t)stream>>>(
      x, stats, nullptr, P, n, 0);
  return (int)cudaGetLastError();
}

// attributes[0..2] = registers a thread, local memory bytes a thread
// (nonzero if it spills), static shared memory bytes a block.
int moments_attributes(int device, int* attributes) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  cudaFuncAttributes a;
  e = cudaFuncGetAttributes(&a, row_moments_kernel<false>);
  attributes[0] = a.numRegs;
  attributes[1] = (int)a.localSizeBytes;
  attributes[2] = (int)a.sharedSizeBytes;
  return (int)e;
}

const char* moments_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
