// The per-row moments kernel of K1 (fitpdf.cu, moments_edges_stats: stats
// and Eq.-5 edges) and K3 (moments.cu, moments_stats: stats only). One
// template, so the two compute the same stats bit for bit; K3 compiles the
// edges out.
//
// What bounds it: the row's bytes, read once; about ten float operations a
// value beside them, then each row's reduction and finalize. The one-warp-
// a-row design before it kept one 4-byte load a lane in flight (32
// dependent trips for a 1,000-value row). Here a warp takes a row, four
// rows a block, and each lane issues every 16-byte load of its share at
// once (kMomLoads a round: a 1,000-value row in one), as K2 and K4's
// histogram phase does (row_hist.cuh). Beside the read the time is
// instructions, so: a warp a row (a block of 128 threads a row ran its
// reduction and finalize in all four warps and took 1.4 times as long),
// NaN-propagating min and max in one instruction each, and a shuffle tree
// that trades halves (row_lane_sums). kernels/moments/ablation.py times
// the other shapes (kMomRowThreads 16 to 128; a row of several warps adds
// their sums through shared memory in warp order) and the parts.
//
// A float sum depends on who adds which value in what order, so that is a
// function of j and n alone: value j is in group q = j / 4, group q belongs
// to lane q % kMomRowThreads of the row, and a lane adds its groups in
// order of q, each group's values in order of j; the last, partial group
// (n % 4 values) comes last, at its owner. A row that starts on a 16-byte
// boundary reads its full groups as float4, any other row reads the same
// groups with scalar loads: the same sums either way, so a row's stats do
// not depend on where it lies (the reuse cache spans windows; Select's
// bitwise contracts). A lane adds its 32 or so values in float, as the
// plain version adds, and the lanes' sums go to double for the fixed tree:
// no float atomics, so every launch gives the same bits, and the sums stay
// within a rounding or two of exact. That matters: the shift is the row's
// first observation (the reference kernel's formula), and where that lies
// sd's from the mean, skew and kurt cancel between the power sums, so two
// float orders of the sums can land farther apart than K1's tolerance while
// each is close to exact; near-exact sums leave only the plain version's
// own rounding between them.
#pragma once

#include "common.cuh"

namespace {

constexpr int kMomRowThreads = 32;  // threads a row: a warp
constexpr int kMomRows = 4;         // rows a block
constexpr int kMomLoads = 8;        // 16-byte loads a thread keeps in flight
constexpr int kMomThreads = kMomRowThreads * kMomRows;
constexpr int kMomWarps = (kMomRowThreads + 31) / 32;  // warps a row
static_assert(kMomRowThreads >= 4 && (kMomRowThreads % 32 == 0 || 32 % kMomRowThreads == 0),
              "a row is a whole number of warps, or a warp a whole number of rows");

// min_nan / max_nan (common.cuh) in one instruction each: PTX's min.NaN and
// max.NaN give NaN when either operand is NaN.
__device__ __forceinline__ float min_nan1(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}
__device__ __forceinline__ float max_nan1(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// A thread's shifted power sums s1..s4 of its values, min and max.
struct RowSums {
  float shift, s1, s2, s3, s4, mn, mx;
  __device__ explicit RowSums(float first)
      : shift(first), s1(0.0f), s2(0.0f), s3(0.0f), s4(0.0f), mn(INFINITY), mx(-INFINITY) {}
  __device__ __forceinline__ void add(float v) {
    const float d = v - shift;
    const float d2 = d * d;
    const float d3 = d2 * d;
    s1 += d;
    s2 += d2;
    s3 += d3;
    s4 += d3 * d;
    mn = min_nan1(mn, v);
    mx = max_nan1(mx, v);
  }
  __device__ __forceinline__ void add4(float4 v) {
    add(v.x);
    add(v.y);
    add(v.z);
    add(v.w);
  }
};

// The row's sums over all its threads: s1..s4 in double (the threads' float
// sums of a few values each, added in a fixed tree), min and max.
struct RowTotals {
  double s1, s2, s3, s4;
  float mn, mx;
  __device__ __forceinline__ void merge(double o1, double o2, double o3, double o4, float omn,
                                        float omx) {
    s1 += o1;
    s2 += o2;
    s3 += o3;
    s4 += o4;
    mn = min_nan1(mn, omn);
    mx = max_nan1(mx, omx);
  }
};

// This thread's full groups q = rt, rt + kMomRowThreads, ... < nq of row
// xr, in order of q: float4 loads when kVec (xr 16-byte aligned), else
// scalar.
template <bool kVec>
__device__ __forceinline__ void add_groups(const float* __restrict__ xr, int nq, int rt, RowSums& r) {
  for (int base = 0; base < nq; base += kMomRowThreads * kMomLoads) {
    float4 v[kMomLoads];
#pragma unroll
    for (int u = 0; u < kMomLoads; ++u) {
      const int q = base + u * kMomRowThreads + rt;
      if (q < nq) {
        if constexpr (kVec) {
          v[u] = __ldg(reinterpret_cast<const float4*>(xr) + q);
        } else {
          const float* g = xr + 4 * q;
          v[u] = make_float4(__ldg(g), __ldg(g + 1), __ldg(g + 2), __ldg(g + 3));
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kMomLoads; ++u)
      if (base + u * kMomRowThreads + rt < nq) r.add4(v[u]);
  }
}

constexpr int kMomLanes = kMomRowThreads < 32 ? kMomRowThreads : 32;  // a row's lanes in a warp

// s1..s4 summed over the row's kMomLanes lanes of this warp, in a fixed
// tree: the first two steps trade halves, so that each lane carries one of
// the four sums (a quarter of the lanes each), then a butterfly within the
// quarters, then each sum from its quarter to every lane. Every lane ends
// with the same bits; 20 shuffles and 6 additions for 32 lanes, where a
// butterfly of the four would take 40 and 20.
__device__ __forceinline__ void row_lane_sums(RowTotals& w, int lane) {
  constexpr int kHalf = kMomLanes / 2, kQuarter = kMomLanes / 4;
  const bool a = lane & kHalf, b = lane & kQuarter;
  double k0 = a ? w.s3 : w.s1, k1 = a ? w.s4 : w.s2;
  k0 += __shfl_xor_sync(kFull, a ? w.s1 : w.s3, kHalf);
  k1 += __shfl_xor_sync(kFull, a ? w.s2 : w.s4, kHalf);
  double c = b ? k1 : k0;
  c += __shfl_xor_sync(kFull, b ? k0 : k1, kQuarter);
#pragma unroll
  for (int off = kQuarter / 2; off > 0; off >>= 1) c += __shfl_xor_sync(kFull, c, off);
  const int base = lane & ~(kMomLanes - 1);
  w.s1 = __shfl_sync(kFull, c, base);
  w.s2 = __shfl_sync(kFull, c, base + kQuarter);
  w.s3 = __shfl_sync(kFull, c, base + kHalf);
  w.s4 = __shfl_sync(kFull, c, base + kHalf + kQuarter);
#pragma unroll
  for (int off = kHalf; off > 0; off >>= 1) {
    w.mn = min_nan1(w.mn, __shfl_xor_sync(kFull, w.mn, off));
    w.mx = max_nan1(w.mx, __shfl_xor_sync(kFull, w.mx, off));
  }
}

// kMomRows rows a block (gridDim.x = ceil(P / kMomRows)), kMomRowThreads
// threads a row.
template <bool kEdges>
__global__ void __launch_bounds__(kMomThreads)
row_moments_kernel(const float* __restrict__ x, float* __restrict__ stats,
                   float* __restrict__ edges, int P, int n, int L) {
  const int rt = threadIdx.x % kMomRowThreads, lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * kMomRows + threadIdx.x / kMomRowThreads;
  const bool live = row < P;  // a block's rows past P load and store nothing
  const float* xr = x + (live ? row : 0) * (long long)n;

  RowSums r(live ? __ldg(xr) : 0.0f);
  const int nq = live ? n >> 2 : 0;
  if (((uintptr_t)xr & 15) == 0) {
    add_groups<true>(xr, nq, rt, r);
  } else {
    add_groups<false>(xr, nq, rt, r);
  }
  if (live && rt == nq % kMomRowThreads)  // the partial group, last of its owner's
    for (int j = 4 * nq; j < n; ++j) r.add(__ldg(xr + j));

  RowTotals w{r.s1, r.s2, r.s3, r.s4, r.mn, r.mx};
  row_lane_sums(w, lane);
  if constexpr (kMomWarps > 1) {
    // The row's warps' sums, combined in warp order by every thread of it.
    __shared__ RowTotals part[kMomRows][kMomWarps];
    const int rw = rt >> 5, rb = threadIdx.x / kMomRowThreads;
    if (lane == 0) part[rb][rw] = w;
    __syncthreads();
    w = part[rb][0];
#pragma unroll
    for (int i = 1; i < kMomWarps; ++i) {
      const RowTotals& o = part[rb][i];
      w.merge(o.s1, o.s2, o.s3, o.s4, o.mn, o.mx);
    }
  }
  if (!live) return;

  // Finalize (repro/kernels/fitpdf/kernel.py:86-100, operation by
  // operation, in float from the sums rounded to float).
  const float nf = (float)n;
  const float md = (float)w.s1 / nf;
  const float e2 = (float)w.s2 / nf, e3 = (float)w.s3 / nf, e4 = (float)w.s4 / nf;
  const float mdsq = md * md;
  const float m2 = max_nan(e2 - mdsq, 0.0f);
  const float m3 = e3 - 3.0f * md * e2 + 2.0f * (md * mdsq);
  const float m4 = e4 - 4.0f * md * e3 + 6.0f * md * md * e2 - 3.0f * (mdsq * mdsq);
  const float mean = r.shift + md;
  const float var = m2 * nf / max_nan(nf - 1.0f, 1.0f);
  const float sig = sqrtf(max_nan(m2, kEps));
  const float skew = m3 / (sig * (sig * sig));
  const float m2c = max_nan(m2, kEps);
  const float kurt = m4 / (m2c * m2c) - 3.0f;
  if (rt < 8) {  // [mean, var, skew, kurt, min, max, 0, 0], one thread a stat
    const float v = rt == 0 ? mean : rt == 1 ? var : rt == 2 ? skew : rt == 3 ? kurt
                  : rt == 4 ? w.mn : rt == 5 ? w.mx : 0.0f;
    stats[row * 8 + rt] = v;
  }
  if constexpr (kEdges) {
    // Eq.-5 edges, vmin + span * k / L (pdf_error.interval_edges' order),
    // written by the row's threads.
    const float span = max_nan(w.mx - w.mn, kEps);
    float* er = edges + row * (long long)(L + 1);
    for (int k = rt; k <= L; k += kMomRowThreads) er[k] = w.mn + span * (float)k / (float)L;
  }
}

inline unsigned mom_blocks(int P) { return (unsigned)((P + kMomRows - 1) / kMomRows); }

}  // namespace
