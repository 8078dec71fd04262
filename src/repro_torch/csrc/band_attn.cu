// Hopper (sm_90a) kernels of the LM serving path: repro_torch.kernels.band_attn.
//
// band_attn  replaces repro/kernels/band_attn/kernel.py::banded_attention_kernel
//            (Pallas, pallas_call at l.92): causal sliding-window GQA
//            attention. q (B, S, H, hd), k/v (B, S, KV, hd), bfloat16 or
//            float32; key j is valid for query i iff i - W < j <= i and
//            j < S; head h reads kv head h / (H / KV). The softmax is
//            float32; out (B, S, H, hd) in q's type.
//
// Bound on an H100 at the serving shape (B 4, S 4096, H 16, KV 8, hd 256,
// W 1024, bf16): the useful work is 4 * hd FLOPs per valid (query, key)
// pair (q.k and p*v), and a (b, h) has W(W+1)/2 + (S-W)W = 3,670,528 valid
// pairs, so 2.41e11 FLOPs: 0.243 ms at the 989 TFLOP/s bf16 tensor-core
// peak. The bytes are q, k, v and out read or written once, 402.7 MB, 0.120
// ms at 3.35 TB/s. So it is bound by operations at 0.243 ms, and only the
// tensor cores can come near it: the CUDA cores' 67 TFLOP/s of float32
// cannot beat about 3.6 ms.
//
// The TPU kernel holds (W, 2W) float32 score tiles in VMEM: 8 MB at
// W = 1024, far above a block's 227 KB of shared memory. Both routes here
// are an online softmax over tiles of the band instead.
//
// bfloat16 (band_attn_tc_kernel), on the tensor cores:
// * A block takes one 64-row query tile of NWG query heads that share a kv
//   head (NWG = 2 when H / KV is even, so both heads of a gemma3 group;
//   else 1), one warpgroup (128 threads) a head. Each K/V tile in shared
//   memory feeds all NWG warpgroups.
// * It walks key tiles of 64 from max(0, q0 - W + 1) to its last query:
//   ceil((64 + W - 1) / 64) tiles, about 6 % more pairs than the band's.
//   Only a tile that holds an invalid pair (the band's two edge tiles, the
//   tail beyond S) is masked; interior tiles take no mask.
// * S = Q K^T is wgmma m64n64k16 with Q and K read from shared memory
//   through matrix descriptors; O += P V is wgmma m64nNk16 with P from
//   registers and V from shared memory in the transposed (MN-major) B
//   layout, N = the head dim padded to 64 (HDP). Both accumulate in
//   float32.
// * Tiles are copied by the Tensor Memory Accelerator: one thread issues
//   HDP / 64 boxes of 64 rows x 128 bytes a tile (a 4-D tensor map over
//   (B, S, heads, hd)), in the 128-byte swizzle layout that wgmma reads,
//   completing on an mbarrier. Columns at or beyond hd and rows at or
//   beyond S arrive as zeros, so hd is padded in shared memory, never with
//   a padded copy in device memory. Why TMA: copied with cp.async, 16
//   bytes a thread, into the no-swizzle core-matrix layout, the tiles set
//   the kernel's time (it ran no faster with its products taken out; see
//   PERF.md and kernels/band_attn/ablation.py).
// * The online softmax stays in float32 registers: each thread holds two
//   rows' running max and partial sum; the row max goes through a fixed
//   xor-shuffle over the 4 threads of a row, the sum once at the end. P is
//   rounded to bf16 only as the operand of P V, as the reference's oracle
//   rounds its weights to q's type (repro/kernels/band_attn/ref.py:24).
// * K/V tiles are double-buffered: tile k+1's boxes are in flight while
//   tile k's products run; every thread waits on the stage's mbarrier,
//   then one __syncthreads a tile frees the other stage for the next copy.
// * The output goes through shared memory (the Q tile's space) so the
//   stores to device memory are 16 bytes a thread.
// * No atomics and a fixed order of summation: a repeat is bitwise equal.
// Shared memory (NWG + 4) x 64 x HDP x 2 bytes and three mbarriers:
// 196,632 B at hd 256.
// Against the bound: the products run at the tensor cores' rate, the edge
// tiles add ~6 % to the 2.41e11 FLOPs, and the K/V bytes a block reads from
// L2 (64 KB a key tile, shared by NWG heads) come by TMA while the
// previous tile's products run; what remains is the serial order within a
// warpgroup (products, softmax, products), which a later design can
// overlap (warp specialisation, ping-pong between warpgroups).
//
// float32 (band_attn_kernel), on the CUDA cores, where tensor cores would
// give up the accuracy the caller asked for: a block owns one (b, h) and a
// tile of kBQ = 64 query rows (8 warps x 8 rows); it walks key tiles of
// kBK = 32 keys over the band. The q tile sits in shared memory; each key
// tile is copied in as it comes. Per key tile: lane j of a warp takes key
// j and computes its 8 rows' scores (16-byte loads; the k row stride is
// padded by 16 bytes so the lanes' loads hit distinct banks), each row's
// running max and sum are updated with a fixed xor-shuffle butterfly, and
// p * v is added key by key into a float32 accumulator of 8 rows x hd
// spread over the lanes. Masked keys get weight 0 and the output is the
// accumulator over max(sum, 1e-30). Shared memory 132,608 B at hd 256.
//
// Both opt in to dynamic shared memory above 48 KB with
// cudaFuncSetAttribute and return its error if that or the launch is
// refused.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -fmad=false -shared
// (kernels/_build.py); plain C interface, bound with ctypes. The launch is
// on the caller's stream; the function returns cudaGetLastError().

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "wgmma.cuh"

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

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }

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

// ---------------------------------------------------------------------------
// bfloat16: tensor cores (wgmma)
// ---------------------------------------------------------------------------

namespace tc {

using bf16 = __nv_bfloat16;

constexpr int kRows = 64;  // query rows of a warpgroup's tile; keys of a K/V tile
constexpr int kWgThreads = 128;
constexpr int kBox = 64;                          // columns of a TMA box: one 128-byte row
constexpr uint32_t kBoxBytes = kRows * kBox * 2;  // 8 KB: 64 rows of 128 bytes
constexpr uint32_t kAtom = 1024;                  // 8 rows of 128 bytes: one swizzle atom

// A wgmma matrix descriptor for a tile in the 128-byte swizzle layout that
// TMA writes (CU_TENSOR_MAP_SWIZZLE_128B): start address, the leading and
// stride byte offsets, layout type 1.
__device__ __forceinline__ uint64_t descriptor(uint32_t addr, uint32_t lead, uint32_t stride) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lead >> 4) << 16) |
         ((uint64_t)(stride >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

// This thread arrives on the barrier and tells it to expect `bytes` more of
// TMA writes before its phase completes.
__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

// Waits until the barrier's phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// One TMA box {64 columns, 1 head, 64 rows, 1 batch} of a (B, S, heads, hd)
// tensor into shared memory, completing on `bar`; out-of-bounds columns and
// rows (hd, S) arrive as zeros.
__device__ __forceinline__ void tma_box(uint32_t dst, const CUtensorMap* map, int col, int head,
                                        int row, int b, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(col), "r"(head), "r"(row), "r"(b), "r"(bar)
      : "memory");
}

// Rows [row, row + 64) of one head: HDP / 64 boxes, 8 KB apart.
template <int HDP>
__device__ __forceinline__ void tma_tile(uint32_t dst, const CUtensorMap* map, int head, int row,
                                         int b, uint32_t bar) {
#pragma unroll
  for (int i = 0; i < HDP / kBox; ++i) tma_box(dst + i * kBoxBytes, map, i * kBox, head, row, b, bar);
}

// Byte offset of element (r, c) of a kRows x HDP bf16 tile in the
// core-matrix layout (8 x 8 blocks of 128 contiguous bytes, consecutive
// along the columns): where the output is staged before it is stored.
template <int HDP>
__device__ __forceinline__ uint32_t cm_offset(int r, int c) {
  return (uint32_t)((((r >> 3) * (HDP / 8) + (c >> 3)) * 8 + (r & 7)) * 16 + (c & 7) * 2);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(kFull, x, 1));
  return fmaxf(x, __shfl_xor_sync(kFull, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(kFull, x, 1);
  return x + __shfl_xor_sync(kFull, x, 2);
}

// HDP is hd rounded up to 64 (a whole number of TMA boxes); NWG warpgroups
// take NWG consecutive query heads of one kv head.
template <int HDP, int NWG>
__global__ void __launch_bounds__(NWG * kWgThreads, 1)
band_attn_tc_kernel(const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap k_map,
                    const __grid_constant__ CUtensorMap v_map, bf16* __restrict__ o, int S, int H,
                    int KV, int hd, int W, float scale_log2) {
  constexpr int NT = NWG * kWgThreads;
  constexpr uint32_t kTile = kRows * HDP * 2;  // bytes of one tile: HDP / 64 boxes
  constexpr int kAcc = HDP / 2;                // O accumulators a thread
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t sq = (uint32_t)__cvta_generic_to_shared(smem);  // NWG Q tiles
  const uint32_t sk = sq + NWG * kTile;                          // 2 K tiles
  const uint32_t sv = sk + 2 * kTile;                            // 2 V tiles
  const uint32_t bar_q = sv + 2 * kTile, bar_kv = bar_q + 8;     // barriers: Q, K/V stage 0 and 1

  const int tid = threadIdx.x, wg = tid / kWgThreads;
  const int warp = (tid % kWgThreads) >> 5, lane = tid & 31, quad = lane & 3;
  const int q0 = blockIdx.x * kRows, b = blockIdx.z;
  const int h0 = blockIdx.y * NWG, kvh = h0 / (H / KV);
  const int q_last = min(q0 + kRows, S) - 1;
  const int k_first = max(0, q0 - W + 1);

  if (tid == 0) {
    mbar_init(bar_q, 1);
    mbar_init(bar_kv, 1);
    mbar_init(bar_kv + 8, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect(bar_q, NWG * kTile);
#pragma unroll
    for (int g = 0; g < NWG; ++g) tma_tile<HDP>(sq + g * kTile, &q_map, h0 + g, q0, b, bar_q);
    mbar_expect(bar_kv, 2 * kTile);
    tma_tile<HDP>(sk, &k_map, kvh, k_first, b, bar_kv);
    tma_tile<HDP>(sv, &v_map, kvh, k_first, b, bar_kv);
  }
  __syncthreads();  // the barriers are initialised

  // This thread's rows of the tile: r0 and r0 + 8.
  const int r0 = warp * 16 + (lane >> 2);
  const int qi0 = q0 + r0, qi1 = qi0 + 8;
  const uint32_t qt = sq + wg * kTile;
  float acc[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  mbar_wait(bar_q, 0);

  int t = 0;
  for (int kt = k_first; kt <= q_last; kt += kRows, ++t) {
    const int stage = t & 1;
    mbar_wait(bar_kv + 8 * stage, (t >> 1) & 1);  // tile t has landed
    __syncthreads();  // every warpgroup is done with tile t - 1's buffers
    if (tid == 0 && kt + kRows <= q_last) {
      const uint32_t bar = bar_kv + 8 * (stage ^ 1);
      mbar_expect(bar, 2 * kTile);
      tma_tile<HDP>(sk + (stage ^ 1) * kTile, &k_map, kvh, kt + kRows, b, bar);
      tma_tile<HDP>(sv + (stage ^ 1) * kTile, &v_map, kvh, kt + kRows, b, bar);
    }
    const uint32_t kt_s = sk + stage * kTile, vt_s = sv + stage * kTile;

    // S = Q K^T, both K-major: k-step kk reads 32 bytes at 32 (kk % 4) into
    // the rows of box kk / 4; 8-row groups 1024 bytes apart.
    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    wgmma::fence();
    wgmma::fence_operands<32>(s);
#pragma unroll
    for (int kk = 0; kk < HDP / 16; ++kk) {
      const uint32_t off = (kk / 4) * kBoxBytes + (kk % 4) * 32;
      wgmma::ss_n64(s, descriptor(qt + off, 16, kAtom), descriptor(kt_s + off, 16, kAtom), 1);
    }
    wgmma::commit();
    wgmma::wait_all();
    wgmma::fence_operands<32>(s);

    // Mask only a tile that holds an invalid pair.
    const bool interior = kt + kRows - 1 <= q0 && kt > q0 + kRows - 1 - W && kt + kRows <= S;
    if (!interior) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int key = kt + 8 * j + 2 * quad + e;
          if (!(key <= qi0 && key > qi0 - W && key < S)) s[4 * j + e] = -INFINITY;
          if (!(key <= qi1 && key > qi1 - W && key < S)) s[4 * j + 2 + e] = -INFINITY;
        }
      }
    }

    // Online softmax in float32: scores in log2 units, scale folded in.
    float x0 = -INFINITY, x1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      x0 = fmaxf(x0, fmaxf(s[4 * j], s[4 * j + 1]));
      x1 = fmaxf(x1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
    }
    const float n0 = fmaxf(m0, quad_max(x0)), n1 = fmaxf(m1, quad_max(x1));
    const float ref0 = n0 == -INFINITY ? 0.f : n0 * scale_log2;
    const float ref1 = n1 == -INFINITY ? 0.f : n1 * scale_log2;
    const float a0 = exp2f(m0 * scale_log2 - ref0), a1 = exp2f(m1 * scale_log2 - ref1);
    m0 = n0;
    m1 = n1;
    float p0 = 0.f, p1 = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        s[4 * j + e] = exp2f(__fmaf_rn(s[4 * j + e], scale_log2, -ref0));
        s[4 * j + 2 + e] = exp2f(__fmaf_rn(s[4 * j + 2 + e], scale_log2, -ref1));
        p0 += s[4 * j + e];
        p1 += s[4 * j + 2 + e];
      }
    }
    l0 = l0 * a0 + p0;
    l1 = l1 * a1 + p1;
#pragma unroll
    for (int j = 0; j < kAcc / 4; ++j) {
      acc[4 * j] *= a0;
      acc[4 * j + 1] *= a0;
      acc[4 * j + 2] *= a1;
      acc[4 * j + 3] *= a1;
    }
    // P in bf16 as wgmma's A fragments: keys 16 kk .. 16 kk + 15.
    uint32_t pa[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      pa[kk][0] = pack_bf16(s[8 * kk], s[8 * kk + 1]);
      pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
      pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
      pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
    }

    // O += P V, V MN-major: 16 keys (two 1024-byte 8-row groups, the
    // stride offset) a k-step; the boxes along hd 8 KB apart (the leading
    // offset); one wgmma of width HDP.
    wgmma::fence();
    wgmma::fence_operands<kAcc>(acc);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma::rs<HDP>(acc, pa[kk], descriptor(vt_s + kk * 2 * kAtom, kBoxBytes, kAtom), 1);
    wgmma::commit();
    wgmma::wait_all();
    wgmma::fence_operands<kAcc>(acc);
  }

  // Normalise, stage the bf16 rows in this warpgroup's Q tile, then store
  // them 16 bytes a thread.
  const float d0 = fmaxf(quad_sum(l0), 1e-30f), d1 = fmaxf(quad_sum(l1), 1e-30f);
  __syncthreads();  // every warpgroup's products have read their Q tile
#pragma unroll
  for (int j = 0; j < kAcc / 4; ++j) {
    const int c = 8 * j + 2 * quad;
    *reinterpret_cast<uint32_t*>(smem + wg * kTile + cm_offset<HDP>(r0, c)) =
        pack_bf16(acc[4 * j] / d0, acc[4 * j + 1] / d0);
    *reinterpret_cast<uint32_t*>(smem + wg * kTile + cm_offset<HDP>(r0 + 8, c)) =
        pack_bf16(acc[4 * j + 2] / d1, acc[4 * j + 3] / d1);
  }
  __syncthreads();
  constexpr int kChunks = HDP / 8;
  const long long q_ld = (long long)H * hd;
  for (int c = tid; c < NWG * kRows * kChunks; c += NT) {
    const int g = c / (kRows * kChunks), cl = c - g * kRows * kChunks;
    const int rest = cl >> 3;
    const int cc = rest % kChunks, row = q0 + (rest / kChunks) * 8 + (cl & 7);
    if (cc >= hd / 8 || row >= S) continue;
    *reinterpret_cast<uint4*>(o + ((long long)b * S + row) * q_ld + (long long)(h0 + g) * hd + cc * 8) =
        *reinterpret_cast<const uint4*>(smem + g * kTile + cl * 16);
  }
}

size_t smem_bytes(int hd, int nwg) {
  return (size_t)(nwg + 4) * kRows * ((hd + kBox - 1) / kBox * kBox) * 2 + 3 * 8;
}

// cuTensorMapEncodeTiled, looked up at run time through the CUDA runtime
// (no link against libcuda).
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

cudaError_t encode_tiled(EncodeTiled* fn) {
  static EncodeTiled cached = nullptr;
  if (cached == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
    if (e != cudaSuccess) return e;
    if (found != cudaDriverEntryPointSuccess || p == nullptr) return cudaErrorSymbolNotFound;
    cached = reinterpret_cast<EncodeTiled>(p);
  }
  *fn = cached;
  return cudaSuccess;
}

// The tensor map of a (B, S, heads, hd) bf16 tensor read in boxes of
// {64 columns, 1 head, 64 rows, 1 batch}, 128-byte swizzled.
cudaError_t tensor_map(CUtensorMap* map, const void* base, int B, int S, int heads, int hd) {
  EncodeTiled encode;
  cudaError_t e = encode_tiled(&encode);
  if (e != cudaSuccess) return e;
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)heads, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)hd * 2, (cuuint64_t)heads * hd * 2,
                                 (cuuint64_t)S * heads * hd * 2};
  const cuuint32_t box[4] = {kBox, 1, kRows, 1}, unit[4] = {1, 1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides,
                            box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// What the launcher does with the instantiation for (HDP, NWG): launch it
// or, with launch == false, report its registers and local memory.
struct Call {
  const void *q, *k, *v;
  void* o;
  int B, S, H, KV, hd, W;
  float scale;
  cudaStream_t stream;
  bool launch;
  int* attributes;  // registers, local memory bytes, dynamic shared memory bytes
};

template <int HDP, int NWG>
cudaError_t run(const Call& c) {
  const size_t smem = smem_bytes(c.hd, NWG);
  if (!c.launch) {
    cudaFuncAttributes a;
    cudaError_t e = cudaFuncGetAttributes(&a, band_attn_tc_kernel<HDP, NWG>);
    c.attributes[0] = a.numRegs;
    c.attributes[1] = (int)a.localSizeBytes;
    c.attributes[2] = (int)smem;
    return e;
  }
  CUtensorMap qm, km, vm;
  cudaError_t e = tensor_map(&qm, c.q, c.B, c.S, c.H, c.hd);
  if (e == cudaSuccess) e = tensor_map(&km, c.k, c.B, c.S, c.KV, c.hd);
  if (e == cudaSuccess) e = tensor_map(&vm, c.v, c.B, c.S, c.KV, c.hd);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(band_attn_tc_kernel<HDP, NWG>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((unsigned)((c.S + kRows - 1) / kRows), (unsigned)(c.H / NWG), (unsigned)c.B);
  band_attn_tc_kernel<HDP, NWG><<<grid, NWG * kWgThreads, smem, c.stream>>>(
      qm, km, vm, static_cast<bf16*>(c.o), c.S, c.H, c.KV, c.hd, c.W, c.scale * 1.4426950408889634f);
  return cudaGetLastError();
}

template <int NWG>
cudaError_t run_nwg(const Call& c) {
  switch ((c.hd + kBox - 1) / kBox) {
    case 1: return run<64, NWG>(c);
    case 2: return run<128, NWG>(c);
    case 3: return run<192, NWG>(c);
    case 4: return run<256, NWG>(c);
    default: return cudaErrorInvalidValue;
  }
}

// Warpgroups a block: two heads of a kv group when H / KV is even.
cudaError_t run(const Call& c) { return (c.H / c.KV) % 2 == 0 ? run_nwg<2>(c) : run_nwg<1>(c); }

}  // namespace tc

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
  if (dtype == 1) return (int)tc::run({q, k, v, o, B, S, H, KV, hd, W, scale, s, true, nullptr});
  return (int)cudaErrorInvalidValue;
}

// The bf16 kernel's instantiation for (hd, H, KV): attributes[0..2] =
// registers a thread, local memory bytes a thread (spills), dynamic shared
// memory bytes a block.
int band_attn_tc_attributes(int hd, int H, int KV, int* attributes) {
  if (hd < 8 || hd > kMaxHd || hd % 8 != 0 || KV < 1 || H % KV != 0) return (int)cudaErrorInvalidValue;
  return (int)tc::run({nullptr, nullptr, nullptr, nullptr, 1, 1, H, KV, hd, 1, 1.f, nullptr, false,
                       attributes});
}

const char* band_attn_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
