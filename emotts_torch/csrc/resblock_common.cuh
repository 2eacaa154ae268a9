// Device code shared by the ResBlock1 kernel (resblock.cu) and the fused MRF
// stage kernel (mrf.cu): a chain of dilated 1-D convolutions over a tile of
// activations that stays in shared memory, every product on the tensor
// cores.
//
// One block owns one (batch row, time tile).  Shared memory holds, in fp32,
//   RING stages of weights: a chunk of KC input channels x C outputs of one
//        tap, filled by 16-byte cp.async while the other stages are used,
//   BUF  the running residual x over tile + 2*halo rows,
//   Z    the intermediate of each dilation step, over the window less the
//        rows it never holds (z_offset),
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
// The conv core (`conv_rows`) is one GEMM per conv: M = the rows computed,
// N = C outputs, K = k taps x C inputs, with the accumulator started at the
// bias.  It runs on `mma.sync.m16n8k8` with TF32 operands.  The A fragments
// of tap `tap` are read from rows `row + (tap - r) * dil` of BUF or Z, so the
// dilated shift is address arithmetic; the B fragments from the weight chunk,
// which the caller hands over as (tap, out, in) so that a chunk row holds
// the K values of one output.  K runs in steps of 16 with its columns
// permuted, so that a thread reads its A and B values of two k-steps with one
// 128-bit load each; rows are not padded but swizzled (`swz`), which keeps
// those loads free of bank conflicts.  Eight warps split N into WARPS_N
// column groups of 64 (32 at C = 32) and interleave the m16 tiles of a pass;
// a pass covers up to WARPS_M * MT m16 tiles, enough for every conv of the
// main path in one, and reads every weight chunk of the conv once from L2.
//
// Arithmetic.  fp32 is emulated with 3xTF32, a documented emulation: each
// operand v is split into hi = cvt.rna.tf32(v) and lo = cvt.rna.tf32(v - hi)
// and a_lo*b_hi + a_hi*b_lo + a_hi*b_hi is accumulated in fp32 (both halves go
// through cvt because the tensor cores ignore the low 13 bits of an
// unconverted operand).  The dropped a_lo*b_lo term is below 2^-22 of the
// product.  The bf16 instance of the MRF stage feeds values that are exact in
// bf16 (conv inputs rounded by the reference's rounding points, weights
// rounded by the caller), and a bf16 value is exact in TF32, so there one
// TF32 product per term is exact and the split is skipped.  Whether to split
// is the chain's choice (`ROUND`), not each conv's: conv2's input was rounded
// when it was stored.  `ROUND` repeats the rounding points of the fused-MRF
// reference for bf16 activations: the conv inputs lrelu(x) and the masked
// lrelu(c1(..)) are rounded to bf16, the residual and every accumulation stay
// fp32.
//
// What bounds it.  The algorithm's operations over the TF32 rate bound both
// kernels; the design does 3x those in the fp32 instances, plus the halo rows
// (1.02-1.16 rows computed for every row kept on the main path).  Measured on
// an H100 (PERF.md), the design's products run at 90-135 TFLOP/s, a fifth to
// a quarter of the 495 TFLOP/s that wgmma reaches: mma.sync with two warps a
// scheduler, the cvt conversions of the split (at C <= 64), and each weight
// chunk's block barrier and L2 wait (with the products compiled out, 19-32 %
// of the time remains: tools/probe_vocoder_core.py) are what is left.  The
// ring overlaps a chunk's copy with the products of the chunk before; Z
// holds only the rows the chain uses, so the per-step launches get longer
// tiles.
#pragma once

#include "common.cuh"

namespace emotts {

constexpr float kLreluSlope = 0.1f;
constexpr int kMaxDilations = 8;
constexpr int kWarps = kThreads / 32;

struct DilationList {
  int n;
  int d[kMaxDilations];
};

__device__ __forceinline__ float lrelu(float v) {
  return v > 0.f ? v : v * kLreluSlope;
}

// The geometry, tuned on the card (PERF.md): stages of the weight ring (a
// third stage cost tile rows and gained nothing), and per channel count the
// input channels of one weight chunk (one ring stage) and the m16 tiles of a
// warp per pass (what the registers allow beside NT n8 tiles).
constexpr int kRingStages = 2;
__host__ __device__ constexpr int chunk_rows(int C) {
  return C >= 256 ? 16 : C >= 128 ? 32 : C;
}
__host__ __device__ constexpr int warp_m_tiles(int C) { return C == 32 ? 6 : 3; }
// The 128-bit fragment loads of a quarter warp read 16 floats from each of
// two neighbouring rows; they fill all 32 banks when the two rows start 16
// banks apart.  Rows are not padded: where a row is a multiple of 32 floats,
// its columns are swizzled, (row, col) at col ^ 16 in odd rows (`swz`).
__host__ __device__ constexpr int row_floats(int C) { return C; }
// Floats of the weight ring: stages of C output rows of KC input channels.
__host__ __device__ constexpr int ring_floats(int C) {
  return kRingStages * C * chunk_rows(C);
}
template <int L>
__device__ __forceinline__ int swz(int row) {
  return L % 32 == 0 ? (row & 1) << 4 : 0;  // a 16-float row needs none
}

template <int C>
struct ConvGeom {
  static constexpr int LDA = row_floats(C);    // activation row stride
  // offset of activation (row, col) in BUF or Z
  static __device__ __forceinline__ int at(int row, int col) {
    return row * LDA + (col ^ swz<LDA>(row));
  }
  static constexpr int KC = chunk_rows(C);
  static constexpr int LDW = KC;               // weight chunk: C rows (out) of KC (in)
  static constexpr int STAGES = kRingStages;
  static constexpr int STAGE = C * LDW;        // floats of one ring stage
  static constexpr int NT = C >= 64 ? 8 : 4;   // n8 tiles of a warp
  static constexpr int WN = 8 * NT;            // columns of a warp
  static constexpr int WARPS_N = C / WN;
  static constexpr int WARPS_M = kWarps / WARPS_N;
  static constexpr int MT = warp_m_tiles(C);   // m16 tiles of a warp per pass
  static constexpr int MT_PASS = WARPS_M * MT;
  static_assert(C % WN == 0 && kWarps % WARPS_N == 0 && C % KC == 0 &&
                    KC % 16 == 0 && (KC * C) % (4 * kThreads) == 0 && STAGES >= 2,
                "unsupported channel count");
};

// Epilogue of conv1: z = round(mask(lrelu(acc))) -> Z, two columns at a time
template <int C, bool ROUND>
struct StoreZ {
  float* z;
  long long t_of_row0;  // time index of buffer row 0
  long long t_len;
  __device__ __forceinline__ void operator()(int row, int col, float a0, float a1) const {
    const long long t = t_of_row0 + row;
    const bool in_seq = t >= 0 && t < t_len;
    float v0 = in_seq ? lrelu(a0) : 0.f;
    float v1 = in_seq ? lrelu(a1) : 0.f;
    if (ROUND) {
      v0 = round_bf16(v0);
      v1 = round_bf16(v1);
    }
    *reinterpret_cast<float2*>(z + ConvGeom<C>::at(row, col)) = make_float2(v0, v1);
  }
};

// Epilogue of conv2: x = mask(x + acc) -> BUF (each element by its one owner)
template <int C>
struct AddResidual {
  float* buf;
  long long t_of_row0;
  long long t_len;
  __device__ __forceinline__ void operator()(int row, int col, float a0, float a1) const {
    const long long t = t_of_row0 + row;
    const bool in_seq = t >= 0 && t < t_len;
    float2* p = reinterpret_cast<float2*>(buf + ConvGeom<C>::at(row, col));
    const float2 x = *p;
    *p = in_seq ? make_float2(x.x + a0, x.y + a1) : make_float2(0.f, 0.f);
  }
};

// out[row, :] = bias + sum_tap act(in[row + (tap - r) * dil, :]) @ w[tap]
// for rows in [q_lo, q_hi) of the shared-memory buffer `in` (rows
// [row_lo, row_hi) of stride LDA), on the tensor cores.  ACT_IN applies
// lrelu (and with ROUND_IN the bf16 rounding) to the inputs as they are read;
// SPLIT selects 3xTF32.
// All threads of the block must call this together, after a barrier that
// ends every earlier use of `ring`.
template <int C, bool ACT_IN, bool ROUND_IN, bool SPLIT, typename Epilogue>
__device__ __forceinline__ void conv_rows(const float* __restrict__ in, int row_lo,
                                          int row_hi, int q_lo, int q_hi,
                                          const float* __restrict__ w,
                                          const float* __restrict__ bias, int k,
                                          int dil, float* __restrict__ ring,
                                          const Epilogue& epi) {
  using G = ConvGeom<C>;
  constexpr int LDA = G::LDA, LDW = G::LDW, KC = G::KC, NT = G::NT, MT = G::MT;
  constexpr int CHUNKS_PER_TAP = C / KC;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;  // fragment row group, thread in group
  const int wm = warp % G::WARPS_M, wn = warp / G::WARPS_M;
  const int n0 = wn * G::WN;
  const int r = (k - 1) / 2;
  const int n_mt = (q_hi - q_lo + 15) / 16;
  const int n_pass = (n_mt + G::MT_PASS - 1) / G::MT_PASS;
  const int n_chunk = k * CHUNKS_PER_TAP;
  const int total = n_pass * n_chunk;

  // chunk c of a pass: tap c / CHUNKS_PER_TAP, input channels from
  // (c % CHUNKS_PER_TAP) * KC: KC contiguous floats of each of the C rows of
  // that tap in w (tap, out, in).  Every call commits one group (empty past
  // the end), so that the count of groups in flight is the same in every
  // iteration.
  auto load_chunk = [&](int i, int stage) {
    if (i < total) {
      const int c = i % n_chunk, tap = c / CHUNKS_PER_TAP;
      const float* src = w + (size_t)tap * C * C + (c - tap * CHUNKS_PER_TAP) * KC;
      float* dst = ring + stage * G::STAGE;
#pragma unroll
      for (int e = threadIdx.x; e < KC * C / 4; e += kThreads) {
        const int n = e / (KC / 4), k4 = (e % (KC / 4)) * 4;
        cp_async16(dst + n * LDW + (k4 ^ swz<LDW>(n)), src + (size_t)n * C + k4);
      }
    }
    cp_async_commit_group();
  };

  float2 bv[NT];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
    bv[nt] = make_float2(__ldg(bias + n0 + nt * 8 + 2 * t4),
                         __ldg(bias + n0 + nt * 8 + 2 * t4 + 1));

  float acc[MT][NT][4];
#pragma unroll
  for (int s = 0; s < G::STAGES - 1; ++s) load_chunk(s, s);
  int stage = 0;  // the ring stage of chunk i
  for (int i = 0; i < total; ++i) {
    const int pass = i / n_chunk, c = i - pass * n_chunk;
    if (c == 0) {
#pragma unroll
      for (int j = 0; j < MT; ++j)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          acc[j][nt][0] = acc[j][nt][2] = bv[nt].x;
          acc[j][nt][1] = acc[j][nt][3] = bv[nt].y;
        }
    }
    cp_async_wait_group<G::STAGES - 2>();  // this thread's part of chunk i
    __syncthreads();  // all of chunk i has landed; everyone is done with i-1
    // chunk i + STAGES - 1 into the stage chunk i-1 used
    load_chunk(i + G::STAGES - 1, stage == 0 ? G::STAGES - 1 : stage - 1);
    const float* wb = ring + stage * G::STAGE + (n0 + g) * LDW + 4 * t4;
    const int bswz = swz<LDW>(g);  // rows n0 + nt * 8 + g have g's parity
    stage = stage == G::STAGES - 1 ? 0 : stage + 1;
    const int tap = c / CHUNKS_PER_TAP;
    const int ci0 = (c - tap * CHUNKS_PER_TAP) * KC;
    const int shift = (tap - r) * dil;

    // this thread's A rows (g and g + 8 of each m16 tile); rows past q_hi
    // are computed on clamped addresses and never stored
    const float* arow[MT][2];
    int aswz[MT][2];
    bool on[MT];
#pragma unroll
    for (int j = 0; j < MT; ++j) {
      const int mt = pass * G::MT_PASS + j * G::WARPS_M + wm;
      on[j] = mt < n_mt;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        int src = q_lo + mt * 16 + g + 8 * h + shift;
        src = src < row_lo ? row_lo : (src >= row_hi ? row_hi - 1 : src);
        arow[j][h] = in + src * LDA + 4 * t4;
        aswz[j][h] = swz<LDA>(src);
      }
    }

    // K in steps of 16 with the columns permuted: thread t4 reads columns
    // 4*t4 .. 4*t4 + 3 of A and of B^T with one 128-bit load each, and k-step
    // s in {0, 1} takes columns 4*t4 + 2s (fragment column t4) and
    // 4*t4 + 2s + 1 (column t4 + 4).  A and B agree on the order, so the
    // product is the same sum.
#pragma unroll
    for (int kk = 0; kk < KC; kk += 16) {
      float4 braw[NT];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
        braw[nt] = *reinterpret_cast<const float4*>(wb + nt * 8 * LDW + (kk ^ bswz));
      float4 araw[MT][2];
#pragma unroll
      for (int j = 0; j < MT; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          araw[j][h] = on[j] ? *reinterpret_cast<const float4*>(
                                   arow[j][h] + ((ci0 + kk) ^ aswz[j][h]))
                             : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        uint32_t bh[NT][2], bl[NT][2];
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          split_tf32<SPLIT>(s ? braw[nt].z : braw[nt].x, bh[nt][0], bl[nt][0]);
          split_tf32<SPLIT>(s ? braw[nt].w : braw[nt].y, bh[nt][1], bl[nt][1]);
        }
#pragma unroll
        for (int j = 0; j < MT; ++j) {
          if (!on[j]) continue;  // the same for the whole warp
          float a[4] = {s ? araw[j][0].z : araw[j][0].x, s ? araw[j][1].z : araw[j][1].x,
                        s ? araw[j][0].w : araw[j][0].y, s ? araw[j][1].w : araw[j][1].y};
          uint32_t ah[4], al[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if (ACT_IN) {
              a[e] = lrelu(a[e]);
              if (ROUND_IN) a[e] = round_bf16(a[e]);
            }
            split_tf32<SPLIT>(a[e], ah[e], al[e]);
          }
          // the three products of an accumulator NT products apart, so
          // that none waits for the one before it
          if (SPLIT) {
#pragma unroll
            for (int nt = 0; nt < NT; ++nt) mma_tf32(acc[j][nt], al, bh[nt]);
#pragma unroll
            for (int nt = 0; nt < NT; ++nt) mma_tf32(acc[j][nt], ah, bl[nt]);
          }
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) mma_tf32(acc[j][nt], ah, bh[nt]);
        }
      }
    }

    if (c == n_chunk - 1) {
#pragma unroll
      for (int j = 0; j < MT; ++j) {
        if (!on[j]) continue;
        const int row = q_lo + (pass * G::MT_PASS + j * G::WARPS_M + wm) * 16 + g;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const int col = n0 + nt * 8 + 2 * t4;
          if (row < q_hi) epi(row, col, acc[j][nt][0], acc[j][nt][1]);
          if (row + 8 < q_hi) epi(row + 8, col, acc[j][nt][2], acc[j][nt][3]);
        }
      }
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

// First buffer row of Z that a chain over a window with `halo` rows a side
// uses: conv1 of the first step writes rows from (halo - chain_halo) + r*d0.
// Z holds rows [z_offset, n_rows - z_offset) only: for one dilation step
// that is the tile and r rows a side, not the whole window.
__host__ __device__ inline int z_offset(int k, const DilationList& dl, int halo) {
  return halo - chain_halo(k, dl) + (k - 1) / 2 * dl.d[0];
}

// Run one ResBlock1 chain on BUF in place.  BUF rows [halo - chain_halo,
// halo + tile + chain_halo) must hold x (0 outside the sequence); on return
// rows [halo, halo + tile) hold the block's output.  `t0` is the time index
// of buffer row `halo`.  Z holds buffer rows [zoff, n_rows - zoff), zoff at
// most z_offset(k, dl, halo).  With ROUND (the bf16 MRF instance) the conv
// inputs are rounded to bf16 and the products are single TF32; else 3xTF32.
template <int C, bool ROUND>
__device__ __forceinline__ void resblock_chain(float* buf, float* z_alloc, int zoff,
                                               float* ring, int n_rows, int halo,
                                               int tile, long long t0,
                                               long long t_len, const float* w1,
                                               const float* b1, const float* w2,
                                               const float* b2, int k,
                                               const DilationList& dl) {
  constexpr bool SPLIT = !ROUND;
  const int r = (k - 1) / 2;
  int rem = chain_halo(k, dl);
  float* z = z_alloc - zoff * ConvGeom<C>::LDA;  // indexed by buffer row
  const StoreZ<C, ROUND> store_z{z, t0 - halo, t_len};
  const AddResidual<C> add_res{buf, t0 - halo, t_len};
  for (int j = 0; j < dl.n; ++j) {
    rem -= r * dl.d[j] + r;  // halo the later steps still need
    const int o_lo = halo - rem;
    const int o_hi = halo + tile + rem;
    const size_t woff = (size_t)j * k * C * C;
    conv_rows<C, true, ROUND, SPLIT>(buf, 0, n_rows, o_lo - r, o_hi + r, w1 + woff,
                                     b1 + j * C, k, dl.d[j], ring, store_z);
    __syncthreads();
    conv_rows<C, false, false, SPLIT>(z, zoff, n_rows - zoff, o_lo, o_hi, w2 + woff,
                                      b2 + j * C, k, 1, ring, add_res);
    __syncthreads();
  }
}

// Load rows [q_lo, q_hi) of the window into BUF from x (B, T, C); 0 outside
// the sequence.
template <typename T, int C>
__device__ __forceinline__ void load_window(float* buf, const T* __restrict__ x,
                                            long long batch, long long t_len,
                                            long long t_of_row0, int q_lo, int q_hi) {
  const int n = (q_hi - q_lo) * C;
  for (int e = threadIdx.x; e < n; e += kThreads) {
    const int row = q_lo + e / C;
    const int c = e % C;
    const long long t = t_of_row0 + row;
    float v = 0.f;
    if (t >= 0 && t < t_len) v = to_float(x[(batch * t_len + t) * C + c]);
    buf[ConvGeom<C>::at(row, c)] = v;
  }
}

// Dynamic shared memory of a chain: the weight ring, BUF and Z.
inline size_t chain_smem_floats(int C, int tile, int halo, int zoff) {
  return (size_t)ring_floats(C) +
         (size_t)(2 * tile + 4 * halo - 2 * zoff) * row_floats(C);
}

}  // namespace emotts
