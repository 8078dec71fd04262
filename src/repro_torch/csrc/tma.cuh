// Hopper (sm_90a) tile copies by the Tensor Memory Accelerator, completing on
// mbarriers in shared memory, and the wgmma matrix descriptor of the tiles
// they write; used by band_attn.cu (with 4-D tensor maps of its own) and
// ssd_intra.cu.
//
// A tile is written in the 128-byte swizzle layout (CU_TENSOR_MAP_SWIZZLE_128B):
// rows of 128 bytes, and within each group of 8 rows (a 1,024-byte atom)
// the 16-byte chunk c of row r is stored at chunk c ^ (r % 8). The tile's
// address in shared memory must be 1,024-byte aligned.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tma {

constexpr uint32_t kAtom = 1024;  // 8 rows of 128 bytes: one swizzle atom

// A wgmma matrix descriptor for a tile in the 128-byte swizzle layout:
// start address, the leading and stride byte offsets, layout type 1.
__device__ __forceinline__ uint64_t descriptor(uint32_t addr, uint32_t lead, uint32_t stride) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lead >> 4) << 16) |
         ((uint64_t)(stride >> 4) << 32) | (1ull << 62);
}

// Byte offset of the 4-byte word holding columns (c, c + 1), c even, of row
// r in a tile of 2-byte elements with 128-byte rows, 128-byte swizzled.
__device__ __forceinline__ uint32_t swizzled(int r, int c) {
  return (uint32_t)(r * 128 + ((((c >> 3) ^ (r & 7))) << 4) + (c & 7) * 2);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

// Makes the initialised barriers visible to the TMA unit.
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
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

// One box of a 2-D tensor map at element coordinates (col, row) into shared
// memory, completing on `bar`; elements outside the tensor arrive as zeros
// and count towards the barrier's bytes.
__device__ __forceinline__ void load_2d(uint32_t dst, const CUtensorMap* map, int col, int row,
                                        uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(col), "r"(row), "r"(bar)
      : "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

// cuTensorMapEncodeTiled, looked up at run time through the CUDA runtime
// (no link against libcuda).
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

inline cudaError_t encode_tiled(EncodeTiled* fn) {
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

// The tensor map of a row-major (rows, cols) bf16 matrix whose rows lie
// `row_bytes` apart (a multiple of 16), read in boxes of 64 columns (128
// bytes) x `box_rows` rows, 128-byte swizzled.
inline cudaError_t map_2d(CUtensorMap* map, const void* base, long long rows, long long cols,
                          long long row_bytes, int box_rows) {
  EncodeTiled encode;
  cudaError_t e = encode_tiled(&encode);
  if (e != cudaSuccess) return e;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)row_bytes};
  const cuuint32_t box[2] = {64, (cuuint32_t)box_rows}, unit[2] = {1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims, strides,
                            box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace tma
