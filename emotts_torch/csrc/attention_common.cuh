// What the attention forward and backward kernels share: the dropout
// generator, the bf16 kernels' TMA tiles and the fp32 kernels' tiles and
// tensor-core products.
#pragma once

#include "common.cuh"
#include "wgmma.cuh"

#include <cuda.h>  // CUtensorMap and its enumerations (types only)
#include <stdint.h>

namespace emotts {

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

// The fp32 tiles of the tensor-core kernels (attention.cu, attention_bwd.cu):
// rows of D floats at a stride of D + 4, so that the fragment loads of
// mma.sync, lane (g, t) at row g and column t (or at row 2t and column g), hit
// 32 different banks.
template <int D>
struct F32Tile {
  static constexpr int LD = D + 4;
  static_assert(D % 32 == 0, "head dim must be a multiple of 32");
};

// Start the 16-byte cp.async copies of `rows` rows t0 .. of one (batch, head)
// of a contiguous fp32 (B, T, H, D) tensor (`src` at that (batch, head)'s row
// 0) into a tile of stride D + 4; rows at or beyond T are zero-filled.  All
// THREADS threads take part; the caller commits the group.
template <int D, int ROWS, int THREADS>
__device__ __forceinline__ void copy_rows_f32(float* dst, const float* src,
                                              long long row_stride, int t0,
                                              int Tlen, int tid) {
  constexpr int CH = D / 4;  // 16-byte chunks of a row
#pragma unroll 4
  for (int e = tid; e < ROWS * CH; e += THREADS) {
    const int r = e / CH, c = e - r * CH;
    const int t = t0 + r;
    const bool ok = t < Tlen;
    cp_async16_zfill(dst + r * F32Tile<D>::LD + 4 * c,
                     src + (long long)(ok ? t : 0) * row_stride + 4 * c, ok);
  }
}

// Start the 4-byte copies of n floats src[t0 ..] into dst (a shared-memory
// address), zero at or beyond `len`; threads 0 .. n-1 take part.
__device__ __forceinline__ void copy_floats(uint32_t dst, const float* src,
                                            int t0, int n, int len, int tid) {
  if (tid < n) {
    const int t = t0 + tid;
    wg::cp_async4(dst + 4 * tid, src + (t < len ? t : 0), t < len);
  }
}

// The A fragment of mma.sync.m16n8k8 (rows g, g + 8; columns t, t + 4) of a
// 16-row fp32 tile read at `p` = row g, column t, split into its TF32 hi and lo.
template <int LD>
__device__ __forceinline__ void a_frag(const float* p, uint32_t (&hi)[4],
                                       uint32_t (&lo)[4]) {
  split_tf32<true>(p[0], hi[0], lo[0]);
  split_tf32<true>(p[8 * LD], hi[1], lo[1]);
  split_tf32<true>(p[4], hi[2], lo[2]);
  split_tf32<true>(p[8 * LD + 4], hi[3], lo[3]);
}

// d[c0 ..] += a * b in 3xTF32 for N n8 tiles that share one A fragment, the
// three products of an accumulator N products apart so that none waits for
// the one before it (the vocoder core's order: lo*hi, hi*lo, hi*hi).
template <int N, int M>
__device__ __forceinline__ void mma_3xtf32(float (&d)[M][4], int c0,
                                           const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4],
                                           const uint32_t (&bh)[N][2],
                                           const uint32_t (&bl)[N][2]) {
#pragma unroll
  for (int n = 0; n < N; ++n) mma_tf32(d[c0 + n], al, bh[n]);
#pragma unroll
  for (int n = 0; n < N; ++n) mma_tf32(d[c0 + n], ah, bl[n]);
#pragma unroll
  for (int n = 0; n < N; ++n) mma_tf32(d[c0 + n], ah, bh[n]);
}

// acc (16 x 8N per warp) += A B^T over depth D in 3xTF32: A a 16-row tile
// read at `a` (row g, column t of the warp's rows), B N n8 tiles of rows read
// at `b` (row g, column t of the tile's first row), both of stride LD.  The
// S = Q K^T form of the attention kernels.
template <int D, int N>
__device__ __forceinline__ void mma_abt(float (&acc)[N][4], const float* a,
                                        const float* b) {
  constexpr int LD = F32Tile<D>::LD;
#pragma unroll
  for (int kk = 0; kk < D; kk += 8) {
    uint32_t ah[4], al[4], bh[N][2], bl[N][2];
    a_frag<LD>(a + kk, ah, al);
#pragma unroll
    for (int n = 0; n < N; ++n) {
      split_tf32<true>(b[8 * n * LD + kk], bh[n][0], bl[n][0]);
      split_tf32<true>(b[8 * n * LD + kk + 4], bh[n][1], bl[n][1]);
    }
    mma_3xtf32<N>(acc, 0, ah, al, bh, bl);
  }
}

// acc (16 x D per warp) += P B over K8 k-steps of 8 rows of B in 3xTF32, P
// given as the split A fragments of each k-step.  P comes from the C
// fragment of an earlier product, where thread (g, t) holds columns 2t and
// 2t + 1 of an n8 tile; A slot t of k-step j is taken to be B row 8j + 2t and
// slot t + 4 row 8j + 2t + 1, so P needs no shuffle (a sum over rows does not
// depend on their order).  `b` points at row 2t, column g of the first k-step's
// rows (stride LD).
template <int D, int K8>
__device__ __forceinline__ void mma_pb(float (&acc)[D / 8][4],
                                       const uint32_t (&ph)[K8][4],
                                       const uint32_t (&pl)[K8][4],
                                       const float* b) {
  constexpr int LD = F32Tile<D>::LD;
  constexpr int G = 4;  // n8 tiles per group of products
#pragma unroll
  for (int j = 0; j < K8; ++j)
#pragma unroll
    for (int c0 = 0; c0 < D / 8; c0 += G) {
      uint32_t bh[G][2], bl[G][2];
#pragma unroll
      for (int c = 0; c < G; ++c) {
        split_tf32<true>(b[8 * j * LD + 8 * (c0 + c)], bh[c][0], bl[c][0]);
        split_tf32<true>(b[(8 * j + 1) * LD + 8 * (c0 + c)], bh[c][1], bl[c][1]);
      }
      mma_3xtf32<G>(acc, c0, ph[j], pl[j], bh, bl);
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
