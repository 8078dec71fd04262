// Hopper (sm_90a) kernel of the `kernels` fit backend: repro_torch.kernels.moments.
//
// moments_stats  replaces repro/kernels/moments/kernel.py::moments_stats
//                (Pallas, _moments_kernel): per-row shifted power sums, min
//                and max over the observation axis, finalized into the (P, 8)
//                stats [mean, var (unbiased), skew, kurt, min, max, 0, 0].
//
// It is K1's kernel (row_moments.cuh) with the Eq.-5 edges compiled out, so
// its stats equal K1's bit for bit. It reads the (P, n) float32 window once
// and writes 32 bytes a row: bound by those bytes, about ten float
// operations per value.
//
// Build and interface as fitpdf.cu: nvcc into a plain-C shared library,
// loaded with ctypes; the function launches on the given stream, allocates
// nothing and returns cudaGetLastError() of its launch.

#include "row_moments.cuh"

extern "C" {

int moments_stats(const float* x, float* stats, int P, int n, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  row_moments_kernel<false><<<row_blocks(P), kThreads, 0, (cudaStream_t)stream>>>(
      x, stats, nullptr, P, n, 0);
  return (int)cudaGetLastError();
}

const char* moments_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
