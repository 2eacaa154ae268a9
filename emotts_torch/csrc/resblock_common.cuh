// Device code shared by the ResBlock1 kernel (resblock.cu) and the fused MRF
// stage kernel (mrf.cu): a chain of dilated 1-D convolutions over a tile of
// activations that stays in shared memory.
//
// One block owns one (batch row, time tile).  Shared memory holds, in fp32,
//   BUF  the running residual x over tile + 2*halo rows,
//   Z    the intermediate of each dilation step over the same rows,
//   W    a slab of the weights of the tap being applied,
// and every dilation step  x += c2(lrelu(c1(lrelu(x), d)))  runs on them.
// After each step the rows whose receptive field reached outside the loaded
// window are no longer exact, so each step only computes the rows that later
// steps (and the tile itself) still need: the valid window shrinks by
// r*d + r rows a side per step, r = (k-1)/2.
//
// Rows outside [0, T) are forced to 0 after BOTH convs of every step, which
// is what zero padding means for the reference's chained convs: without it
// the biases would leak in at the sequence edges.
//
// Weights are (tap, in, out) fp32 in device memory, the flax layout.  They do
// not fit in shared memory (126 taps x C^2 is 8 MB at C = 128), so they are
// streamed through a 8 KB slab per block and stay in the 50 MB L2.
//
// Arithmetic: fp32 FMA throughout (no TF32).  `ROUND` repeats the rounding
// points of the fused-MRF reference for bf16 activations: the conv inputs
// lrelu(x) and the masked lrelu(c1(..)) are rounded to bf16, the residual
// and every accumulation stay fp32.
#pragma once

#include "common.cuh"

namespace emotts {

constexpr float kLreluSlope = 0.1f;
constexpr int kMaxDilations = 8;
constexpr int kRowsPerThread = 8;   // RM: output rows per thread
constexpr int kColsPerThread = 4;   // one float4 of output channels
constexpr int kSlabFloats = 2048;   // weight slab: KC input channels x C

struct DilationList {
  int n;
  int d[kMaxDilations];
};

__device__ __forceinline__ float lrelu(float v) {
  return v > 0.f ? v : v * kLreluSlope;
}

template <int C>
struct ConvGeom {
  static constexpr int LD = C + 1;  // odd row stride: no bank conflicts
  static constexpr int CG = C / kColsPerThread;  // column groups
  static constexpr int RG = kThreads / CG;       // row groups per round
  static constexpr int KC = (kSlabFloats / C) < C ? (kSlabFloats / C) : C;
  static_assert(C % 4 == 0 && kThreads % CG == 0, "unsupported channel count");
  static_assert((KC * C) % 4 == 0 && KC * C <= kSlabFloats && C % KC == 0,
                "the slab holds whole float4s and divides the input channels");
};

// Epilogue of conv1: z = round(mask(lrelu(acc))) -> Z
template <int C, bool ROUND>
struct StoreZ {
  float* z;
  long long t_of_row0;  // time index of buffer row 0
  long long t_len;
  __device__ __forceinline__ void operator()(int row, int col, const float (&a)[kColsPerThread]) const {
    const long long t = t_of_row0 + row;
    const bool in_seq = t >= 0 && t < t_len;
    float* p = z + row * ConvGeom<C>::LD + col;
#pragma unroll
    for (int e = 0; e < kColsPerThread; ++e) {
      float v = in_seq ? lrelu(a[e]) : 0.f;
      if (ROUND) v = round_bf16(v);
      p[e] = v;
    }
  }
};

// Epilogue of conv2: x = mask(x + acc) -> BUF (each element by its one owner)
template <int C>
struct AddResidual {
  float* buf;
  long long t_of_row0;
  long long t_len;
  __device__ __forceinline__ void operator()(int row, int col, const float (&a)[kColsPerThread]) const {
    const long long t = t_of_row0 + row;
    const bool in_seq = t >= 0 && t < t_len;
    float* p = buf + row * ConvGeom<C>::LD + col;
#pragma unroll
    for (int e = 0; e < kColsPerThread; ++e) p[e] = in_seq ? p[e] + a[e] : 0.f;
  }
};

// out[row, :] = bias + sum_tap act(in[row + (tap - r) * dil, :]) @ w[tap]
// for rows in [q_lo, q_hi) of the shared-memory buffer `in` (n_rows rows of
// stride LD).  ACT_IN applies lrelu (and the bf16 rounding) to the inputs as
// they are read.  All threads of the block must call this together.
template <int C, bool ACT_IN, bool ROUND, typename Epilogue>
__device__ __forceinline__ void conv_rows(const float* __restrict__ in, int n_rows,
                                          int q_lo, int q_hi,
                                          const float* __restrict__ w,
                                          const float* __restrict__ bias, int k,
                                          int dil, float* __restrict__ slab,
                                          const Epilogue& epi) {
  using G = ConvGeom<C>;
  constexpr int LD = G::LD;
  constexpr int RM = kRowsPerThread;
  const int tid = threadIdx.x;
  const int cg = tid % G::CG;
  const int rg = tid / G::CG;
  const int col = cg * kColsPerThread;
  const int r = (k - 1) / 2;
  const int rows_per_round = G::RG * RM;
  const int n_rounds = (q_hi - q_lo + rows_per_round - 1) / rows_per_round;
  const float4 bv = __ldg(reinterpret_cast<const float4*>(bias + col));

  for (int round = 0; round < n_rounds; ++round) {
    const int row0 = q_lo + (round * G::RG + rg) * RM;
    const bool active = row0 < q_hi;
    float acc[RM][kColsPerThread];
#pragma unroll
    for (int m = 0; m < RM; ++m) {
      acc[m][0] = bv.x; acc[m][1] = bv.y; acc[m][2] = bv.z; acc[m][3] = bv.w;
    }
    for (int tap = 0; tap < k; ++tap) {
      const int shift = (tap - r) * dil;
      // rows past q_hi in the last group are computed on clamped addresses
      // and never stored
      const float* arow[RM];
#pragma unroll
      for (int m = 0; m < RM; ++m) {
        int src = row0 + m + shift;
        src = src < 0 ? 0 : (src >= n_rows ? n_rows - 1 : src);
        arow[m] = in + src * LD;
      }
      const float* wt = w + (size_t)tap * C * C;
      for (int ci0 = 0; ci0 < C; ci0 += G::KC) {
        __syncthreads();  // the slab's previous contents are consumed
        for (int e = tid * 4; e < G::KC * C; e += kThreads * 4) {
          *reinterpret_cast<float4*>(slab + e) =
              __ldg(reinterpret_cast<const float4*>(wt + (size_t)ci0 * C + e));
        }
        __syncthreads();
        if (active) {
#pragma unroll 4
          for (int cc = 0; cc < G::KC; ++cc) {
            const float4 wv = *reinterpret_cast<const float4*>(slab + cc * C + col);
#pragma unroll
            for (int m = 0; m < RM; ++m) {
              float a = arow[m][ci0 + cc];
              if (ACT_IN) {
                a = lrelu(a);
                if (ROUND) a = round_bf16(a);
              }
              acc[m][0] = fmaf(a, wv.x, acc[m][0]);
              acc[m][1] = fmaf(a, wv.y, acc[m][1]);
              acc[m][2] = fmaf(a, wv.z, acc[m][2]);
              acc[m][3] = fmaf(a, wv.w, acc[m][3]);
            }
          }
        }
      }
    }
    if (active) {
#pragma unroll
      for (int m = 0; m < RM; ++m)
        if (row0 + m < q_hi) epi(row0 + m, col, acc[m]);
    }
  }
}

// Total one-sided receptive field of a ResBlock1 chain.
__host__ __device__ inline int chain_halo(int k, const DilationList& dl) {
  const int r = (k - 1) / 2;
  int h = 0;
  for (int j = 0; j < dl.n; ++j) h += r * dl.d[j] + r;
  return h;
}

// Run one ResBlock1 chain on BUF in place.  BUF rows [halo - chain_halo,
// halo + tile + chain_halo) must hold x (0 outside the sequence); on return
// rows [halo, halo + tile) hold the block's output.  `t0` is the time index
// of buffer row `halo`.
template <int C, bool ROUND>
__device__ __forceinline__ void resblock_chain(float* buf, float* z, float* slab,
                                               int n_rows, int halo, int tile,
                                               long long t0, long long t_len,
                                               const float* w1, const float* b1,
                                               const float* w2, const float* b2,
                                               int k, const DilationList& dl) {
  const int r = (k - 1) / 2;
  int rem = chain_halo(k, dl);
  const StoreZ<C, ROUND> store_z{z, t0 - halo, t_len};
  const AddResidual<C> add_res{buf, t0 - halo, t_len};
  for (int j = 0; j < dl.n; ++j) {
    rem -= r * dl.d[j] + r;  // halo the later steps still need
    const int o_lo = halo - rem;
    const int o_hi = halo + tile + rem;
    const size_t woff = (size_t)j * k * C * C;
    conv_rows<C, true, ROUND>(buf, n_rows, o_lo - r, o_hi + r, w1 + woff,
                              b1 + j * C, k, dl.d[j], slab, store_z);
    __syncthreads();
    conv_rows<C, false, false>(z, n_rows, o_lo, o_hi, w2 + woff, b2 + j * C, k,
                               1, slab, add_res);
    __syncthreads();
  }
}

// Load rows [q_lo, q_hi) of the window into BUF from x (B, T, C); 0 outside
// the sequence.
template <typename T, int C>
__device__ __forceinline__ void load_window(float* buf, const T* __restrict__ x,
                                            long long batch, long long t_len,
                                            long long t_of_row0, int q_lo, int q_hi) {
  constexpr int LD = ConvGeom<C>::LD;
  const int n = (q_hi - q_lo) * C;
  for (int e = threadIdx.x; e < n; e += kThreads) {
    const int row = q_lo + e / C;
    const int c = e % C;
    const long long t = t_of_row0 + row;
    float v = 0.f;
    if (t >= 0 && t < t_len) v = to_float(x[(batch * t_len + t) * C + c]);
    buf[row * LD + c] = v;
  }
}

inline size_t chain_smem_floats(int C, int tile, int halo) {
  return (size_t)kSlabFloats + 2 * (size_t)(tile + 2 * halo) * (C + 1);
}

}  // namespace emotts
