// What the attention forward and backward kernels share: the padded tile
// row, the dropout generator and the tile loaders.
#pragma once

#include "common.cuh"
#include "wgmma.cuh"

#include <cuda.h>  // CUtensorMap and its enumerations (types only)
#include <stdint.h>

namespace emotts {

template <typename T>
__host__ __device__ constexpr int attn_row_pad() {
  // row stride of a tile read by rows, in elements beyond D: an odd number of
  // 32-bit words, so that lanes reading different rows at one depth hit
  // different banks
  return sizeof(T) == 2 ? 2 : 1;
}

// Philox4x32-10 (Salmon et al., "Parallel random numbers: as easy as 1, 2,
// 3", 2011): a counter-based generator, so a draw is a pure function of
// (key, counter) and forward and backward regenerate the same bits whatever
// order they walk the tiles in.
__device__ __forceinline__ uint4 philox4x32_10(uint32_t c0, uint32_t c1,
                                               uint32_t c2, uint32_t c3,
                                               uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint32_t hi0 = __umulhi(0xD2511F53u, c0), lo0 = 0xD2511F53u * c0;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c2), lo1 = 0xCD9E8D57u * c2;
    const uint32_t n0 = hi1 ^ c1 ^ k0;
    const uint32_t n2 = hi0 ^ c3 ^ k1;
    c0 = n0; c1 = lo1; c2 = n2; c3 = lo0;
    k0 += 0x9E3779B9u;
    k1 += 0xBB67AE85u;
  }
  return make_uint4(c0, c1, c2, c3);
}

// The dropout stream of (example, head): the reference's per-head mix of the
// per-example int32 seed, with wrap-around.
__device__ __forceinline__ uint32_t dropout_key(int seed, int head) {
  return (uint32_t)seed + (uint32_t)head * 0x9E3779B9u;  // -1640531527 as uint32
}

// Random words of keys 4*kgroup .. 4*kgroup+3 for one query: key index j is
// kept where word (j & 3) >= threshold.
__device__ __forceinline__ uint4 dropout_bits(uint32_t key, uint32_t query,
                                              uint32_t kgroup) {
  return philox4x32_10(query, kgroup, 0u, 0u, key, 0u);
}

// rows x D values of a (B, T, H, D) tensor, rows t0 .. t0+rows-1 of one
// (batch, head), into a tile of row stride LD; rows beyond T are zero.
template <typename T, int D, int LD>
__device__ __forceinline__ void load_rows(T* __restrict__ dst,
                                          const T* __restrict__ src,
                                          long long base, long long row_stride,
                                          int t0, int rows, int Tlen, int tid) {
  for (int e = tid; e < rows * D; e += kThreads) {
    const int r = e / D, d = e - r * D;
    const int t = t0 + r;
    dst[r * LD + d] = t < Tlen ? src[base + (long long)t * row_stride + d]
                               : from_float<T>(0.f);
  }
}

// Width of a bf16 tensor-core tile for head dim D: whole 64-column swizzle
// blocks, the columns beyond D zero (they add nothing to a product over the
// head dim, and the output columns they give are never written).
template <int D>
struct TcWidth {
  static constexpr int DP = (D + 63) / 64 * 64;
  static constexpr int NB = DP / 64;
};

// The tensor map of a bf16 (B, T, H, D) tensor for TMA copies of tiles of
// `rows` rows of one (batch, head): dimensions (D, H, T, B) innermost first,
// boxes of 64 columns x 1 head x `rows` rows x 1 example, 128-byte swizzle
// (the layout of wgmma.cuh), elements outside the tensor (rows beyond T,
// columns beyond D) read as zeros.  cuTensorMapEncodeTiled is a driver
// function: it is looked up through the runtime, so nothing links libcuda.
using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                   cuuint32_t, void*, const cuuint64_t*,
                                   const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave,
                                   CUtensorMapSwizzle, CUtensorMapL2promotion,
                                   CUtensorMapFloatOOBfill);

inline int tile_map(CUtensorMap* map, const void* data, int B, int T, int H,
                    int D, int rows) {
  static EncodeTiledFn encode = [] {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault,
                                &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      fn = nullptr;
    return reinterpret_cast<EncodeTiledFn>(fn);
  }();
  if (encode == nullptr) return kErrTensorMap;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)T,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)H * D * 2,
                                 (cuuint64_t)T * H * D * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(data), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kErrTensorMap;
}

// Start the TMA copy of rows t0 .. of one (batch, head) into a swizzled
// tile of ROWS rows: one box per 64-column block, ROWS * DP * 2 bytes on
// barrier `bar` (the caller has set them as the phase's expected count).
template <int D, int ROWS>
__device__ __forceinline__ void tma_tile(uint32_t tile, const CUtensorMap& map,
                                         uint32_t bar, int h, int t0, int b) {
#pragma unroll
  for (int n = 0; n < TcWidth<D>::NB; ++n)
    wg::tma_load_4d(tile + n * ROWS * 128, &map, bar, 64 * n, h, t0, b);
}

// Round a finite fp32 value to the nearest bf16 (ties to even) with integer
// operations: the bits of __float2bfloat16_rn, off the conversion unit that
// the exponentials keep busy.
__device__ __forceinline__ float round_bf16_alu(float x) {
  uint32_t u = __float_as_uint(x);
  u += 0x7FFFu + ((u >> 16) & 1u);
  return __uint_as_float(u & 0xFFFF0000u);
}

// The two bf16 values of a packed pair, as fp32.
__device__ __forceinline__ float bf16_lo(uint32_t pair) {
  return __uint_as_float(pair << 16);
}
__device__ __forceinline__ float bf16_hi(uint32_t pair) {
  return __uint_as_float(pair & 0xFFFF0000u);
}

}  // namespace emotts
