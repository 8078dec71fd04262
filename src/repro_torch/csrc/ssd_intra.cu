// Hopper (sm_90a) kernel of the SSD's prefill: repro_torch.kernels.ssd_intra.
//
// ssd_intra  replaces no Pallas kernel: the reference computes the SSD's
//            intra-chunk term with einsums around a float32 decay matrix
//            (repro/models/ssm.py). Added because that chain of plain
//            passes paced the port's prefill: five float32 (B, Nc, H, Q, Q)
//            tensors a layer, 805 MB each at mamba2-780m's shape. It
//            computes, for each chunk c of Q steps and head h of group g(h),
//
//   y[b, c, i, h, :] = sum_{j <= i} bf16(float(CB[b, c, g, i, j]) * exp(ca[b, c, i, h] - ca[b, c, j, h]))
//                                   * x[b, c, j, h, :]
//
//            CB (B, Nc, G, Q, Q) bf16 (C_i . B_j), ca (B, Nc, Q, H) float32
//            (the cumulative log-decays), x (B, Nc, Q, H, P) bf16 (dt x) ->
//            y (B, Nc, Q, H, P) bf16, the product summed in float32. The
//            decay matrix is rounded to bf16 where the plain version rounds
//            it (kernels/ssd_intra/ref.py).
//
// Bound on an H100 at mamba2-780m's prefill (B 4, Nc 16, Q 256, H 48, P 64,
// G 1): x read and y written once, 100.7 MB each, CB 8.4 MB and ca 3.1 MB:
// 212.9 MB a layer, 0.0636 ms at 3.35 TB/s. The products of the tiles on
// and below the diagonal are 1.61e10 FLOPs, 0.0163 ms at 989 TFLOP/s. So it
// is bound by bytes, and the decay matrix must never reach device memory.
// hymba-1.5b (H 64, P 50, N 16): 222.3 MB, 0.0664 ms.
//
// Design:
// * A block is one warpgroup (128 threads) and owns a 64-row tile of i for
//   one (b, c, h). It walks the 64-column tiles of j from 0 up to the
//   diagonal; tiles above it are never loaded or computed. Blocks of one
//   (b, c, h) are neighbours in the grid, the longest first, so its x tiles
//   are read from L2 by the later ones.
// * The decay tile M (64 x 64) is built in registers, in float32, in the
//   layout of wgmma's A operand: each thread takes its two rows and sixteen
//   columns, reads CB from shared memory and ca from shared memory, and
//   computes float(CB) * expf(ca_i - ca_j), rounded to bf16. In the
//   diagonal tile an entry with j > i is 0 and its exponent (positive, which
//   overflows once a chunk's decay passes ~88) is never used.
// * y += M x is wgmma m64nNk16 with M from registers and the x tile from
//   shared memory in the transposed (MN-major) B layout, N = P rounded up
//   to 64 (PP), as K5 does P V (band_attn.cu). The sum stays in float32
//   registers until the end.
// * The x and CB tiles are copied by TMA (csrc/tma.cuh) in the 128-byte
//   swizzle layout, double-buffered: tile t + 1 is in flight while tile t is
//   built and multiplied. x is read through a 2-D map of (B Nc Q, H P): P
//   need not be a multiple of 8 (hymba's 50 x 2 bytes is no 16-byte row, so
//   a map over the heads' own P columns is refused). A box starts at the
//   16-byte column at or before h P (a box that starts between two refuses
//   to run: an illegal instruction on the H100), o = h P mod 8 columns
//   early, so PP covers P + o; the other columns are the neighbours' or
//   zeros past H P, and only sums that are never stored see them. So x
//   needs no padded copy, only H P a multiple of 8.
// * The output goes through shared memory and leaves as 4-byte words, a row
//   of P columns (from column o) after another, so the stores are coalesced
//   for any even P.
// * No atomics and a fixed order of summation: a repeat is bitwise equal.
// Shared memory: two stages of (PP / 64 + 1) x 8 KB, Q floats of ca, two
// mbarriers: 33,808 B at P 64, Q 256.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -fmad=false -shared
// (kernels/_build.py); plain C interface, bound with ctypes. The launch is
// on the caller's stream; the function returns cudaGetLastError().

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tma.cuh"
#include "wgmma.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kRows = 64;         // rows i of a block's tile; columns j of a tile
constexpr int kThreads = 128;     // one warpgroup
constexpr int kBox = 64;          // columns of a TMA box: one 128-byte row
constexpr uint32_t kTileBytes = kRows * kBox * 2;  // 8 KB: 64 rows of 128 bytes
constexpr int kMaxP = 256;

// Bytes of one stage: PP / 64 boxes of x, then the CB tile.
__host__ __device__ constexpr uint32_t stage_bytes(int pp) { return (pp / kBox + 1) * kTileBytes; }

size_t smem_bytes(int pp, int Q) { return 2 * (size_t)stage_bytes(pp) + (size_t)Q * 4 + 2 * 8; }

// The columns of x a block reads: P, and up to 6 more before them where P
// is no multiple of 8 (the offset o of an aligned box, even since P is).
__host__ __device__ constexpr int span(int P) { return P % 8 ? P + 6 : P; }

// PP is span(P) rounded up to 64 (a whole number of TMA boxes).
template <int PP>
__global__ void __launch_bounds__(kThreads, PP <= 128 ? 4 : 2)
ssd_intra_kernel(const __grid_constant__ CUtensorMap cb_map, const __grid_constant__ CUtensorMap x_map,
                 const float* __restrict__ ca, bf16* __restrict__ y, int Q, int G, int H, int P) {
  constexpr uint32_t kX = (PP / kBox) * kTileBytes, kStage = stage_bytes(PP);
  constexpr int kAcc = PP / 2;  // y accumulators a thread
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t s0 = (uint32_t)__cvta_generic_to_shared(smem);
  float* ca_s = reinterpret_cast<float*>(smem + 2 * kStage);
  const uint32_t bar = s0 + 2 * kStage + Q * 4;  // stage 0 and 1

  const int tiles = Q / kRows;
  const int ti = tiles - 1 - (int)(blockIdx.x % tiles);  // the longest walks first
  const long long bc = blockIdx.x / tiles;               // b * Nc + c
  const int h = blockIdx.y, g = h / (H / G);
  const int i0 = ti * kRows;
  const int cb_row = (int)((bc * G + g) * Q + i0), x_row = (int)(bc * Q);
  const int x_col = (h * P) & ~7, o = h * P - x_col;  // the box's first column, 16-byte aligned
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, quad = lane & 3;

  if (tid == 0) {
    tma::mbar_init(bar, 1);
    tma::mbar_init(bar + 8, 1);
    tma::mbar_fence_init();
    tma::mbar_expect(bar, kStage);
#pragma unroll
    for (int k = 0; k < PP / kBox; ++k) tma::load_2d(s0 + k * kTileBytes, &x_map, x_col + k * kBox, x_row, bar);
    tma::load_2d(s0 + kX, &cb_map, 0, cb_row, bar);
  }
  // The log-decays of rows 0 .. i0 + 63 of this chunk and head.
  const float* cab = ca + bc * Q * H + h;
  for (int j = tid; j < i0 + kRows; j += kThreads) ca_s[j] = cab[(long long)j * H];
  __syncthreads();  // the barriers are initialised, ca is in shared memory

  // This thread's rows of the tile: r0 and r0 + 8.
  const int r0 = warp * 16 + (lane >> 2);
  const float ca_r[2] = {ca_s[i0 + r0], ca_s[i0 + r0 + 8]};
  float acc[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;

  for (int t = 0; t <= ti; ++t) {
    const int stage = t & 1;
    tma::mbar_wait(bar + 8 * stage, (t >> 1) & 1);  // tile t has landed
    __syncthreads();  // every thread is done with tile t - 1's stage
    if (tid == 0 && t < ti) {
      const uint32_t next = s0 + (stage ^ 1) * kStage, nbar = bar + 8 * (stage ^ 1);
      tma::mbar_expect(nbar, kStage);
#pragma unroll
      for (int k = 0; k < PP / kBox; ++k)
        tma::load_2d(next + k * kTileBytes, &x_map, x_col + k * kBox, x_row + (t + 1) * kRows, nbar);
      tma::load_2d(next + kX, &cb_map, (t + 1) * kRows, cb_row, nbar);
    }
    const uint32_t xs = s0 + stage * kStage;
    const unsigned char* cbs = smem + stage * kStage + kX;
    const int j0 = t * kRows;
    const bool diagonal = t == ti;

    // M as wgmma's A fragments, k-step kk = columns 16 kk .. 16 kk + 15:
    // register 2 e + rr holds row r0 + 8 rr at columns 16 kk + 8 e + 2 quad
    // and the next.
    uint32_t a[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 16 * kk + 8 * e + 2 * quad;
        const float ca_c0 = ca_s[j0 + c], ca_c1 = ca_s[j0 + c + 1];
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const int r = r0 + 8 * rr;
          const uint32_t w = *reinterpret_cast<const uint32_t*>(cbs + tma::swizzled(r, c));
          const float lo = __uint_as_float(w << 16), hi = __uint_as_float(w & 0xffff0000u);
          const float m0 = diagonal && c > r ? 0.f : lo * expf(ca_r[rr] - ca_c0);
          const float m1 = diagonal && c + 1 > r ? 0.f : hi * expf(ca_r[rr] - ca_c1);
          a[kk][2 * e + rr] = tma::pack_bf16(m0, m1);
        }
      }
    }

    // y += M x, x MN-major: 16 rows of x (two 1024-byte 8-row groups, the
    // stride offset) a k-step; its boxes along P 8 KB apart (the leading
    // offset); one wgmma of width PP.
    wgmma::fence();
    wgmma::fence_operands<kAcc>(acc);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma::rs<PP>(acc, a[kk], tma::descriptor(xs + kk * 2 * tma::kAtom, kTileBytes, tma::kAtom), 1);
    wgmma::commit();
    wgmma::wait_all();
    wgmma::fence_operands<kAcc>(acc);
  }

  // Stage the bf16 rows (PP + 8 columns apart, so the writes of a warp fall
  // in distinct banks) in the first stage, then store columns o .. o + P - 1
  // of each row as 4-byte words, consecutive threads on consecutive words.
  constexpr int kLd = PP + 8;
  bf16* out_s = reinterpret_cast<bf16*>(smem);
  __syncthreads();  // every thread's products have read the stages
#pragma unroll
  for (int j = 0; j < kAcc / 4; ++j) {
    const int c = 8 * j + 2 * quad;
    *reinterpret_cast<uint32_t*>(out_s + r0 * kLd + c) = tma::pack_bf16(acc[4 * j], acc[4 * j + 1]);
    *reinterpret_cast<uint32_t*>(out_s + (r0 + 8) * kLd + c) = tma::pack_bf16(acc[4 * j + 2], acc[4 * j + 3]);
  }
  __syncthreads();
  const int words = P / 2;
  const long long ld = (long long)H * P;
  bf16* yb = y + (bc * Q + i0) * ld + (long long)h * P;
  for (int k = tid; k < kRows * words; k += kThreads) {
    const int r = k / words, w = k - r * words;
    *reinterpret_cast<uint32_t*>(yb + r * ld + 2 * w) =
        *reinterpret_cast<const uint32_t*>(out_s + r * kLd + o + 2 * w);
  }
}

// What the launcher does with the instantiation for PP: launch it or, with
// launch == false, report its registers and local memory.
struct Call {
  const void *cb, *ca, *x;
  void* y;
  int BC, Q, G, H, P;
  cudaStream_t stream;
  bool launch;
  int* attributes;  // registers, local memory bytes, dynamic shared memory bytes
};

template <int PP>
cudaError_t run(const Call& c) {
  const size_t smem = smem_bytes(PP, c.Q);
  if (!c.launch) {
    cudaFuncAttributes a;
    cudaError_t e = cudaFuncGetAttributes(&a, ssd_intra_kernel<PP>);
    c.attributes[0] = a.numRegs;
    c.attributes[1] = (int)a.localSizeBytes;
    c.attributes[2] = (int)smem;
    return e;
  }
  CUtensorMap cb_map, x_map;
  cudaError_t e = tma::map_2d(&cb_map, c.cb, (long long)c.BC * c.G * c.Q, c.Q, (long long)c.Q * 2, kRows);
  if (e == cudaSuccess)
    e = tma::map_2d(&x_map, c.x, (long long)c.BC * c.Q, (long long)c.H * c.P, (long long)c.H * c.P * 2, kRows);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(ssd_intra_kernel<PP>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((unsigned)(c.BC * (c.Q / kRows)), (unsigned)c.H);
  ssd_intra_kernel<PP><<<grid, kThreads, smem, c.stream>>>(cb_map, x_map, static_cast<const float*>(c.ca),
                                                          static_cast<bf16*>(c.y), c.Q, c.G, c.H, c.P);
  return cudaGetLastError();
}

cudaError_t run(const Call& c) {
  switch ((span(c.P) + kBox - 1) / kBox) {
    case 1: return run<64>(c);
    case 2: return run<128>(c);
    case 3: return run<192>(c);
    case 4: return run<256>(c);
    default: return cudaErrorInvalidValue;
  }
}

bool valid_widths(int H, int P) { return P >= 2 && P % 2 == 0 && span(P) <= kMaxP && ((long long)H * P) % 8 == 0; }

}  // namespace

extern "C" {

// The wrapper checks shapes, types, contiguity and alignment; this checks
// what the kernel's indexing and its TMA maps rely on: Q a multiple of 64,
// H a multiple of G, P even with span(P) at most 256, H P a multiple of 8
// (16-byte rows of x), every row and block index within 32 bits.
int ssd_intra(const void* cb, const void* ca, const void* x, void* y, int BC, int Q, int G, int H, int P,
              int device, void* stream) {
  if (BC < 1 || Q < kRows || Q % kRows != 0 || G < 1 || H < G || H % G != 0 || H > 65535 ||
      !valid_widths(H, P) || (long long)BC * G * Q >= (1ll << 31) || (long long)BC * (Q / kRows) >= (1ll << 31))
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  return (int)run({cb, ca, x, y, BC, Q, G, H, P, (cudaStream_t)stream, true, nullptr});
}

// The instantiation for P at chunk Q: attributes[0..2] = registers a thread,
// local memory bytes a thread (spills), dynamic shared memory bytes a block.
int ssd_intra_attributes(int P, int Q, int* attributes) {
  if (!valid_widths(8, P) || Q < kRows || Q % kRows != 0) return (int)cudaErrorInvalidValue;
  return (int)run({nullptr, nullptr, nullptr, nullptr, 1, Q, 1, 8, P, nullptr, false, attributes});
}

const char* ssd_intra_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
