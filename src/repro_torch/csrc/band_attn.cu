// Hopper (sm_90a) kernel of the LM serving path: repro_torch.kernels.band_attn.
//
// band_attn  replaces repro/kernels/band_attn/kernel.py::banded_attention_kernel
//            (Pallas, pallas_call at l.92): causal sliding-window GQA
//            attention. q (B, S, H, hd), k/v (B, S, KV, hd), float32 or
//            bfloat16; key j is valid for query i iff i - W < j <= i and
//            j < S; head h reads kv head h / (H / KV). Scores, softmax and
//            the weighted sum are float32; out (B, S, H, hd) in q's type.
//
// Bound on an H100 at the serving shape (B 4, S 4096, H 16, KV 8, hd 256,
// W 1024, bf16): the useful work is 4 * hd FLOPs per valid (query, key)
// pair (q.k and p*v), and a (b, h) has W(W+1)/2 + (S-W)W = 3,670,528 valid
// pairs, so 2.41e11 FLOPs: 0.243 ms at the 989 TFLOP/s bf16 tensor-core
// peak. The bytes are q, k, v and out read or written once, 402.7 MB, 0.120
// ms at 3.35 TB/s. So it is bound by operations at 0.243 ms. This kernel
// runs its arithmetic in float32 on the CUDA cores (67 TFLOP/s), which
// cannot beat about 3.6 ms; tensor cores (mma / wgmma) are later work.
//
// The TPU kernel holds (W, 2W) float32 score tiles in VMEM: 8 MB at
// W = 1024, far above a block's 227 KB of shared memory. This one is an
// online softmax instead. A block owns one (b, h) and a tile of kBQ = 64
// query rows (8 warps x 8 rows); it walks the key tiles of kBK = 32 keys
// from max(0, q0 - W + 1) to its last query, so it reads only the band.
// The q tile sits in shared memory as float32 (read by every key tile);
// each key/value tile is copied in as it comes (input type). Per key tile:
// lane j of a warp takes key j and computes its 8 rows' scores (q rows
// broadcast from shared memory, 16-byte loads; the k row stride is padded
// by 16 bytes so the lanes' loads hit distinct banks), then each row's
// running max and sum are updated with a fixed xor-shuffle butterfly, and
// p * v is added key by key into a float32 accumulator of 8 rows x hd
// spread over the lanes (dimension lane + 32 c). No atomics and a fixed
// order of summation: a repeat is bitwise equal. Masked keys get weight 0
// (the reference's -1e30 score gives exp() == 0), the tail beyond S is
// masked in the kernel (no padded copy), and the output is the
// accumulator over max(sum, 1e-30), rounded once to the output type.
//
// Shared memory at hd = 256 is 99,840 B (bf16) or 132,608 B (float32),
// above the 48 KB default: band_attn opts in with cudaFuncSetAttribute
// and returns its error if that or the launch is refused.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -fmad=false -shared
// (kernels/_build.py); plain C interface, bound with ctypes. The launch is
// on the caller's stream; the function returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kRowsPerWarp = 8;
constexpr int kBQ = kWarps * kRowsPerWarp;  // query rows per block
constexpr int kBK = 32;                     // keys per tile, one per lane
constexpr int kThreads = kWarps * 32;
constexpr int kMaxHd = 256;
constexpr unsigned kFull = 0xffffffffu;

// A 16-byte chunk of T, widened to float.
template <typename T> struct Chunk;

template <> struct Chunk<float> {
  static constexpr int E = 4;
  __device__ __forceinline__ static void load(const float* p, float* out) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
  }
};

template <> struct Chunk<__nv_bfloat16> {
  static constexpr int E = 8;
  __device__ __forceinline__ static void load(const __nv_bfloat16* p, float* out) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

template <typename T>
__host__ __device__ constexpr int k_stride(int hd) { return hd + 16 / (int)sizeof(T); }
__host__ __device__ constexpr int q_stride(int hd) { return hd + 4; }

template <typename T>
size_t smem_bytes(int hd) {
  return (size_t)kBQ * q_stride(hd) * sizeof(float)      // q tile, float32
         + (size_t)kBK * k_stride<T>(hd) * sizeof(T)      // k tile, padded rows
         + (size_t)kBK * hd * sizeof(T);                  // v tile
}

// Copy rows [r0, r0 + rows) of a (S, stride) sequence into shared memory
// with row stride `ld`, zero-filling rows at or beyond S.
template <typename T>
__device__ __forceinline__ void copy_tile(T* dst, int ld, const T* src, long long row_stride,
                                          int r0, int rows, int S, int hd) {
  constexpr int E = 16 / (int)sizeof(T);
  const int chunks = hd / E;
  for (int c = threadIdx.x; c < rows * chunks; c += kThreads) {
    const int r = c / chunks, d = (c - r * chunks) * E;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < S) v = *reinterpret_cast<const uint4*>(src + (long long)(r0 + r) * row_stride + d);
    *reinterpret_cast<uint4*>(dst + r * ld + d) = v;
  }
}

template <typename T, int NC>
__global__ void __launch_bounds__(kThreads, 1)
band_attn_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, int S, int H, int KV, int hd, int W, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int qs = q_stride(hd), ks = k_stride<T>(hd);
  float* Qs = reinterpret_cast<float*>(smem);
  T* Ks = reinterpret_cast<T*>(Qs + kBQ * qs);
  T* Vs = Ks + kBK * ks;

  const int q0 = blockIdx.x * kBQ, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const long long q_row = (long long)H * hd, kv_row = (long long)KV * hd;
  const T* qb = q + (long long)b * S * q_row + (long long)h * hd;
  const T* kb = k + (long long)b * S * kv_row + (long long)kvh * hd;
  const T* vb = v + (long long)b * S * kv_row + (long long)kvh * hd;
  T* ob = o + (long long)b * S * q_row + (long long)h * hd;

  // q tile -> float32 in shared memory (zero rows beyond S).
  constexpr int E = Chunk<T>::E;
  {
    const int chunks = hd / E;
    for (int c = threadIdx.x; c < kBQ * chunks; c += kThreads) {
      const int r = c / chunks, d = (c - r * chunks) * E;
      float f[E];
      if (q0 + r < S) {
        Chunk<T>::load(qb + (long long)(q0 + r) * q_row + d, f);
      } else {
#pragma unroll
        for (int e = 0; e < E; ++e) f[e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < E; e += 4)
        *reinterpret_cast<float4*>(Qs + r * qs + d + e) = make_float4(f[e], f[e + 1], f[e + 2], f[e + 3]);
    }
  }

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = warp * kRowsPerWarp;
  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][NC];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  const int q_last = min(q0 + kBQ, S) - 1;
  const int k_first = max(0, q0 - W + 1);
  for (int kt = k_first; kt <= q_last; kt += kBK) {
    __syncthreads();  // the previous tile's readers are done
    copy_tile(Ks, ks, kb, kv_row, kt, kBK, S, hd);
    copy_tile(Vs, hd, vb, kv_row, kt, kBK, S, hd);
    __syncthreads();

    // Scores: lane j takes key kt + j against the warp's 8 rows.
    float s[kRowsPerWarp];
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) s[i] = 0.f;
    const T* krow = Ks + lane * ks;
    for (int d = 0; d < hd; d += E) {
      float kf[E];
      Chunk<T>::load(krow + d, kf);
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) {
        const float* qr = Qs + (row0 + i) * qs + d;
#pragma unroll
        for (int e = 0; e < E; e += 4) {
          const float4 qv = *reinterpret_cast<const float4*>(qr + e);
          s[i] = __fmaf_rn(qv.x, kf[e], s[i]);
          s[i] = __fmaf_rn(qv.y, kf[e + 1], s[i]);
          s[i] = __fmaf_rn(qv.z, kf[e + 2], s[i]);
          s[i] = __fmaf_rn(qv.w, kf[e + 3], s[i]);
        }
      }
    }

    // Online softmax, one row at a time; every lane holds the row's m, l.
    const int key = kt + lane;
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const int qi = q0 + row0 + i;
      const bool valid = key < S && key <= qi && key > qi - W;
      const float x = valid ? s[i] * scale : -INFINITY;
      const float m_new = fmaxf(m[i], warp_max(x));
      float p = 0.f, alpha = 1.f;
      if (m_new != -INFINITY) {
        p = valid ? expf(x - m_new) : 0.f;
        alpha = expf(m[i] - m_new);
      }
      l[i] = l[i] * alpha + warp_sum(p);
      m[i] = m_new;
      s[i] = p;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= alpha;
    }

    // acc += p v, key by key in order.
    for (int j = 0; j < kBK; ++j) {
      float vf[NC];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int d = lane + 32 * c;
        vf[c] = d < hd ? to_float(Vs[j * hd + d]) : 0.f;
      }
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) {
        const float pj = __shfl_sync(kFull, s[i], j);
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[i][c] = __fmaf_rn(pj, vf[c], acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int qi = q0 + row0 + i;
    if (qi >= S) continue;
    const float den = fmaxf(l[i], 1e-30f);
    T* out = ob + (long long)qi * q_row;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = lane + 32 * c;
      if (d < hd) store(out + d, acc[i][c] / den);
    }
  }
}

template <typename T, int NC>
cudaError_t launch_nc(const void* q, const void* k, const void* v, void* o, int B, int S, int H,
                      int KV, int hd, int W, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes<T>(hd);
  cudaError_t e = cudaFuncSetAttribute(band_attn_kernel<T, NC>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((unsigned)((S + kBQ - 1) / kBQ), (unsigned)H, (unsigned)B);
  band_attn_kernel<T, NC><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), S, H, KV, hd, W, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B, int S, int H,
                   int KV, int hd, int W, float scale, cudaStream_t stream) {
  switch ((hd + 31) / 32) {
    case 1: return launch_nc<T, 1>(q, k, v, o, B, S, H, KV, hd, W, scale, stream);
    case 2: return launch_nc<T, 2>(q, k, v, o, B, S, H, KV, hd, W, scale, stream);
    case 3: return launch_nc<T, 3>(q, k, v, o, B, S, H, KV, hd, W, scale, stream);
    case 4: return launch_nc<T, 4>(q, k, v, o, B, S, H, KV, hd, W, scale, stream);
    case 5: return launch_nc<T, 5>(q, k, v, o, B, S, H, KV, hd, W, scale, stream);
    case 6: return launch_nc<T, 6>(q, k, v, o, B, S, H, KV, hd, W, scale, stream);
    case 7: return launch_nc<T, 7>(q, k, v, o, B, S, H, KV, hd, W, scale, stream);
    case 8: return launch_nc<T, 8>(q, k, v, o, B, S, H, KV, hd, W, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 bfloat16. The wrapper checks shapes, contiguity and
// 16-byte alignment; this checks what the kernel's indexing relies on.
int band_attn(const void* q, const void* k, const void* v, void* o, int dtype, int B, int S,
              int H, int KV, int hd, int W, float scale, int device, void* stream) {
  if (B < 1 || S < 1 || KV < 1 || H % KV != 0 || hd < 8 || hd > kMaxHd || hd % 8 != 0 || W < 1 ||
      H > 65535 || B > 65535)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return (int)launch<float>(q, k, v, o, B, S, H, KV, hd, W, scale, s);
  if (dtype == 1) return (int)launch<__nv_bfloat16>(q, k, v, o, B, S, H, KV, hd, W, scale, s);
  return (int)cudaErrorInvalidValue;
}

size_t band_attn_smem_bytes(int dtype, int hd) {
  return dtype == 0 ? smem_bytes<float>(hd) : smem_bytes<__nv_bfloat16>(hd);
}

const char* band_attn_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
