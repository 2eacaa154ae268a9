// What the attention forward and backward kernels share: the padded tile
// row, the dropout generator and the tile loader.
#pragma once

#include "common.cuh"

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

}  // namespace emotts
