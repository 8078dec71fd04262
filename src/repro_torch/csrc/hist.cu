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
// window is that read, then the bin and atomic of every value. Any L: past
// the 58,112 counters the H100 gives a block, the bins go in chunks, one
// launch each, each reading the rows again (row_hist.cuh).
//
// Build and interface as fitpdf.cu.

#include "row_hist.cuh"

namespace {

// One block a row, one chunk of the row's bins a launch: bins [c0, c0 + C)
// (all L when C = L), C int counters in shared memory.
__global__ void __launch_bounds__(kHistThreads)
hist_counts_kernel(const float* __restrict__ x, const float* __restrict__ vmin,
                   const float* __restrict__ vmax, float* __restrict__ counts, int n, int L,
                   int c0, int C) {
  extern __shared__ int hist[];  // C ints
  const long long row = blockIdx.x;
  block_row_histogram<true>(x + row * (long long)n, n, vmin[row], vmax[row], L, c0, C, hist);
  float* out = counts + row * (long long)L + c0;
  for (int k = threadIdx.x; k < C; k += kHistThreads) out[k] = (float)hist[k];
}

// How a block holds a row's L bins: a chunk of C bins (C = L in one launch)
// and the bytes of dynamic shared memory a block takes, C ints.
struct HistRoute {
  int chunk;
  size_t smem;
};

// All L bins at once if their counters fit the default 48 KB or, opted in,
// what the card gives a block (cudaDevAttrMaxSharedMemoryPerBlockOptin; the
// kernel has no static shared memory); else chunks of the largest multiple
// of 32 that fits. Counting is bound by the row's bytes, not by warps an SM
// (PERF.md), so a block takes all the shared memory it can. `forced` > 0
// takes that chunk instead: L or more is one chunk, less must be a multiple
// of 32.
cudaError_t hist_counts_route(int L, int forced, int device, HistRoute* r) {
  if (forced > 0 && forced < L) {
    if (forced % 32) return cudaErrorInvalidValue;
    *r = {forced, (size_t)forced * sizeof(int)};
    return cudaSuccess;
  }
  *r = {L, (size_t)L * sizeof(int)};
  if (forced > 0 || r->smem <= kDefaultSmem) return cudaSuccess;
  int optin = 0;
  const cudaError_t e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (e != cudaSuccess || r->smem <= (size_t)optin) return e;
  const int c = optin / (int)sizeof(int) / 32 * 32;
  *r = {c, (size_t)c * sizeof(int)};
  return cudaSuccess;
}

}  // namespace

extern "C" {

// chunk: 0 picks the route from L (hist_counts_route); > 0 forces a chunk of
// bins. One launch a chunk.
int hist_counts(const float* x, const float* vmin, const float* vmax, float* counts,
                int P, int n, int L, int chunk, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  HistRoute r;
  e = hist_counts_route(L, chunk, device, &r);
  if (e != cudaSuccess) return (int)e;
  e = allow_smem(hist_counts_kernel, r.smem);
  for (int c0 = 0; e == cudaSuccess && c0 < L; c0 += r.chunk) {  // one launch a chunk
    hist_counts_kernel<<<(unsigned)P, kHistThreads, r.smem, (cudaStream_t)stream>>>(
        x, vmin, vmax, counts, n, L, c0, min(r.chunk, L - c0));
    e = cudaGetLastError();
  }
  return (int)e;
}

// K4's kernel and its route at L bins: attributes[0..3] = registers
// a thread, local memory bytes a thread (nonzero if it spills), dynamic
// shared memory bytes a block and the chunk of bins a block counts at once.
int hist_attributes(int L, int device, int* attributes) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  HistRoute r;
  e = hist_counts_route(L, 0, device, &r);
  if (e != cudaSuccess) return (int)e;
  cudaFuncAttributes a;
  e = cudaFuncGetAttributes(&a, hist_counts_kernel);
  attributes[0] = a.numRegs;
  attributes[1] = (int)a.localSizeBytes;
  attributes[2] = (int)r.smem;
  attributes[3] = r.chunk;
  return (int)e;
}

const char* hist_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
