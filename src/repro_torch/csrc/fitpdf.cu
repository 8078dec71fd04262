// Hopper (sm_90a) kernels of the fused fit path: repro_torch.kernels.fitpdf.
//
// moments_edges_stats  replaces repro/kernels/fitpdf/kernel.py::moments_edges_stats
//                      (Pallas, _moments_edges_kernel): per-row shifted power
//                      sums, min and max, finalized into the (P, 8) stats and
//                      the Eq.-5 edges (P, L+1).
// fit_error_counts     replaces repro/kernels/fitpdf/kernel.py::fit_error_counts
//                      (Pallas, _fit_error_kernel): per-row histogram over the
//                      Eq.-5 intervals, then, with the counts still in shared
//                      memory, every candidate type's CDF at the L+1 edges and
//                      the Eq.-5 L1 error; only the (P, T) errors reach memory.
//
// Both read the (P, n) float32 window once and are bound by those bytes. The
// TPU kernels' sequential observation-chunk grid axis becomes a loop inside a
// warp: one warp owns one row, eight rows per 256-thread block. The float
// sums are reduced with a fixed __shfl_xor_sync butterfly, so results are
// bitwise reproducible. The only atomics are integer histogram adds in shared
// memory, which are exact. K1's row loop lives in row_moments.cuh (shared
// with K3, moments.cu), K2's histogram phase in row_hist.cuh (shared with
// K4, hist.cu).
//
// fit_error_counts takes an optional row_indices (int64, null = identity):
// output row r then reads window row row_indices[r], the grouping methods'
// representative gather (repro/kernels/fitpdf/ops.py:79-128) done as the
// kernel's own address computation, with no gathered copy in memory.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false
//        -shared -Xcompiler -fPIC (no fast math; -fmad=false keeps each float
//        operation rounded as in the plain PyTorch versions).
// Interface: plain C functions loaded with ctypes. Each launches on the given
// stream, allocates nothing and returns cudaGetLastError() of its launch.

#include "row_hist.cuh"
#include "row_moments.cuh"

namespace {

constexpr float kGammaWilsonHilfertyK = 1e4f;
constexpr int kMaxIter = 4000;  // incomplete gamma at k <= 1e4 needs < 1000

// ---------------------------------------------------------------------------
// Special functions, in double, rounded to float by the caller. They run
// P*T*(L+1) times per window, next to the P*n histogram adds.
// ---------------------------------------------------------------------------

// Lower regularized incomplete gamma P(a, x): series below x < a + 1, Lentz
// continued fraction for the upper tail above.
__device__ double gammainc_lower(double a, double x) {
  if (isnan(a) || isnan(x)) return a + x;
  if (x <= 0.0) return 0.0;
  if (isinf(x)) return 1.0;
  const double lpre = a * log(x) - x - lgamma(a);
  if (x < a + 1.0) {
    double ap = a, del = 1.0 / a, sum = del;
    for (int i = 0; i < kMaxIter; ++i) {
      ap += 1.0;
      del *= x / ap;
      sum += del;
      if (fabs(del) < fabs(sum) * 1e-16) break;
    }
    return sum * exp(lpre);
  }
  const double tiny = 1e-300;
  double b = x + 1.0 - a, c = 1.0 / tiny, d = 1.0 / b, h = d;
  for (int i = 1; i <= kMaxIter; ++i) {
    const double an = -i * (i - a);
    b += 2.0;
    d = an * d + b;
    if (fabs(d) < tiny) d = tiny;
    c = b + an / c;
    if (fabs(c) < tiny) c = tiny;
    d = 1.0 / d;
    const double del = d * c;
    h *= del;
    if (fabs(del - 1.0) < 1e-16) break;
  }
  return 1.0 - exp(lpre) * h;
}

// Continued fraction of the incomplete beta (modified Lentz).
__device__ double betacf(double a, double b, double x) {
  const double tiny = 1e-300;
  const double qab = a + b, qap = a + 1.0, qam = a - 1.0;
  double c = 1.0, d = 1.0 - qab * x / qap;
  if (fabs(d) < tiny) d = tiny;
  d = 1.0 / d;
  double h = d;
  for (int m = 1; m <= 300; ++m) {
    const double m2 = 2.0 * m;
    double aa = m * (b - m) * x / ((qam + m2) * (a + m2));
    d = 1.0 + aa * d;
    if (fabs(d) < tiny) d = tiny;
    c = 1.0 + aa / c;
    if (fabs(c) < tiny) c = tiny;
    d = 1.0 / d;
    h *= d * c;
    aa = -(a + m) * (qab + m) * x / ((a + m2) * (qap + m2));
    d = 1.0 + aa * d;
    if (fabs(d) < tiny) d = tiny;
    c = 1.0 + aa / c;
    if (fabs(c) < tiny) c = tiny;
    d = 1.0 / d;
    const double del = d * c;
    h *= del;
    if (fabs(del - 1.0) < 1e-16) break;
  }
  return h;
}

// Regularized incomplete beta I_x(a, b).
__device__ double betainc(double a, double b, double x) {
  if (isnan(a) || isnan(b) || isnan(x)) return a + b + x;
  if (x <= 0.0) return 0.0;
  if (x >= 1.0) return 1.0;
  const bool swap = x > (a + 1.0) / (a + b + 2.0);
  const double aa = swap ? b : a, bb = swap ? a : b, xx = swap ? 1.0 - x : x;
  const double front = exp(lgamma(aa + bb) - lgamma(aa) - lgamma(bb) +
                           aa * log(xx) + bb * log1p(-xx));
  const double part = front * betacf(aa, bb, xx) / aa;
  return swap ? 1.0 - part : part;
}

// ---------------------------------------------------------------------------
// The ten CDFs, line by line as repro/core/distributions.py writes them.
// Type codes index TYPES_10: normal, uniform, exponential, lognormal, cauchy,
// gamma, geometric, logistic, student_t, weibull.
// ---------------------------------------------------------------------------

__device__ __forceinline__ float phi(float z) {
  return 0.5f * (1.0f + erff(z / 1.41421356237309515f));
}

__device__ float cdf_eval(int code, float p0, float p1, float p2, float x) {
  switch (code) {
    case 0:  // normal
      return phi((x - p0) / p1);
    case 1:  // uniform
      return clip_nan((x - p0) / (p1 - p0), 0.0f, 1.0f);
    case 2:  // exponential
      return x <= 0.0f ? 0.0f : 1.0f - expf(-p0 * max_nan(x, 0.0f));
    case 3:  // lognormal
      return x <= 0.0f ? 0.0f : phi((logf(max_nan(x, kEps)) - p0) / p1);
    case 4:  // cauchy
      return 0.5f + atanf((x - p0) / p1) / 3.14159265358979312f;
    case 5: {  // gamma: exact below k = 1e4, Wilson-Hilferty above
      if (x <= 0.0f) return 0.0f;
      const float xs = max_nan(x, 0.0f) / p1;
      if (p0 > kGammaWilsonHilfertyK) {
        const float kk = max_nan(p0, kEps);
        const float z = (cbrtf(xs / kk) - (1.0f - 1.0f / (9.0f * kk))) * sqrtf(9.0f * kk);
        return phi(z);
      }
      return (float)gammainc_lower((double)min_nan(p0, kGammaWilsonHilfertyK),
                                   (double)min_nan(xs, 2.0f * kGammaWilsonHilfertyK));
    }
    case 6: {  // geometric; 1 - 1e-12 rounds to 1.0f, as in the reference
      if (x < 0.0f) return 0.0f;
      const float k = floorf(max_nan(x, 0.0f));
      return 1.0f - expf((k + 1.0f) * log1pf(-min_nan(p0, (float)(1.0 - 1e-12))));
    }
    case 7:  // logistic
      return 1.0f / (1.0f + expf(-((x - p0) / p1)));
    case 8: {  // student_t
      const float t = (x - p0) / p1;
      const float ib = (float)betainc((double)(0.5f * p2), 0.5, (double)(p2 / (p2 + t * t)));
      return t >= 0.0f ? 1.0f - 0.5f * ib : 0.5f * ib;
    }
    case 9: {  // weibull
      if (x <= 0.0f) return 0.0f;
      const float z = max_nan(x, 0.0f) / p1;
      return -expm1f(-powf(z, p0));
    }
    default:
      return __int_as_float(0x7fffffff);
  }
}

// ---------------------------------------------------------------------------
// fit_error_counts
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads)
fit_error_kernel(const float* __restrict__ x, const int64_t* __restrict__ row_indices,
                 const float* __restrict__ vmin, const float* __restrict__ vmax,
                 const float* __restrict__ edges, const float* __restrict__ params,
                 float* __restrict__ err, int P, int n, int L, int T, unsigned long long codes) {
  extern __shared__ int smem[];  // int hist[kRows][L], then float cdf[kRows][L+1]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * kRows + warp;
  if (row >= P) return;  // warps are independent: only __syncwarp below
  int* hist = smem + warp * L;
  float* cdfv = reinterpret_cast<float*>(smem + kRows * L) + warp * (L + 1);

  const long long src = row_indices ? (long long)row_indices[row] : row;
  warp_row_histogram(x + src * (long long)n, n, vmin[row], vmax[row], L, hist, lane);

  // Epilogue: CDF at the edges, masses, sum_k |freq_k / n - mass_k|.
  const float nf = (float)(n > 1 ? n : 1);
  const float* pr = params + row * 3LL * T;
  const float* er = edges + row * (long long)(L + 1);
  for (int t = 0; t < T; ++t) {
    const int code = (int)((codes >> (4 * t)) & 15ull);
    const float p0 = pr[3 * t], p1 = pr[3 * t + 1], p2 = pr[3 * t + 2];
    for (int k = lane; k <= L; k += 32) cdfv[k] = cdf_eval(code, p0, p1, p2, er[k]);
    __syncwarp();
    if (lane == 0) {
      float acc = 0.0f;
      for (int k = 0; k < L; ++k) {
        const float rel = (float)hist[k] / nf;
        acc += fabsf(rel - (cdfv[k + 1] - cdfv[k]));
      }
      err[row * T + t] = acc;
    }
    __syncwarp();
  }
}

}  // namespace

extern "C" {

size_t fitpdf_fit_error_smem_bytes(int L) {
  return (size_t)kRows * (size_t)(2 * L + 1) * sizeof(float);
}

int fitpdf_moments_edges_stats(const float* x, float* stats, float* edges,
                               int P, int n, int L, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  row_moments_kernel<true><<<row_blocks(P), kThreads, 0, (cudaStream_t)stream>>>(
      x, stats, edges, P, n, L);
  return (int)cudaGetLastError();
}

int fitpdf_fit_error_counts(const float* x, const int64_t* row_indices, const float* vmin,
                            const float* vmax, const float* edges, const float* params,
                            float* err, int P, int n, int L, int T, unsigned long long codes,
                            int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const size_t smem = fitpdf_fit_error_smem_bytes(L);
  fit_error_kernel<<<row_blocks(P), kThreads, smem, (cudaStream_t)stream>>>(
      x, row_indices, vmin, vmax, edges, params, err, P, n, L, T, codes);
  return (int)cudaGetLastError();
}

const char* fitpdf_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
