// Device code shared by the ResBlock1 kernel (resblock.cu) and the fused MRF
// stage kernel (mrf.cu): a chain of dilated 1-D convolutions over a tile of
// activations that stays in shared memory, every product on Hopper's
// warpgroup MMA (`wgmma`).
//
// One block owns one (batch row, time tile).  Shared memory holds
//   RING stages of weights: KC input channels of one tap for all C outputs,
//        in the layout `wgmma` reads (below), filled ahead of their use,
//   BUF  the running residual x over tile + 2*halo rows (fp32),
//   Z    the intermediate of each dilation step, over the window less the
//        rows it never holds (z_offset) (fp32),
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
// N = C outputs, K = k taps x C inputs, the accumulators started at the bias
// and kept in registers over the whole K.  Two consumer warpgroups issue
// `wgmma.mma_async.m64nNk8` with TF32 operands: A (64 rows x 8 channels)
// from registers, B (8 channels x N outputs) from a ring stage through a
// matrix descriptor.  A warp's A fragment is the m16n8k8 one, so the dilated
// shift stays address arithmetic: the rows of tap `tap` are read from rows
// `row + (tap - r) * dil` of BUF or Z, lrelu (and the bf16 rounding) applied
// on load, and split into TF32 hi and lo parts in registers.  A 64 x N fp32
// tile costs N/2 registers a thread, so each warpgroup holds 128 columns'
// worth: at C = 256 the two warpgroups split N (128 each) over one m64 tile;
// at C <= 128 they split M, each holding 128 accumulator columns' worth of
// m64 tiles of all C columns: one at C = 128, and at C = 64 with both weight
// parts (stacked, below); two at C = 64 with one part and at C = 32 with
// two; four at C = 32 with one.  A pass covers those tiles (64 rows at
// C = 256, 128 at C = 128, 128 or 256 at C = 64, 256 or 512 at C = 32, two
// parts or one) and streams every weight stage of the conv once.
//
// B is split once, by the wrappers (ops/resblock.py::pack_weights), not per
// fragment: `wgmma` cannot split an operand it reads from shared memory.  A
// stage is rows of 128 bytes, one swizzle row each: at C >= 128 in fp32, C
// rows (outputs) of 16 input channels, the hi part and then the lo part in
// a row; at C <= 64 in fp32, 32 channels, the hi part's C rows and then the
// lo part's (ConvGeom::STACK: one wgmma of N = 2C then takes a_hi times both
// parts, the narrow N = C products running the tensor cores worst); for the
// bf16 MRF instance, C rows of 32 channels of its one part.  Each part's
// channels are permuted within 16 so that a thread reads the A values of two
// k8 steps with one 128-bit load (k8 step s of fragment column c is channel
// 4c + 2s for c < 4 and 4(c-4) + 2s + 1 after), and a row's 16-byte chunks
// are swizzled (chunk q at q ^ (row % 8)), the layout of a 128-byte-swizzled
// K-major operand.  So a stage is one contiguous block of the packed weights,
// and each stage is one bulk copy.
//
// The ring.  One producer warp (warp 8; one thread of it) walks the same
// sequence of convs, passes and stages as the consumers (produce_chain) and
// fills each stage with one `cp.async.bulk` as soon as both warpgroups have
// released it: each stage completes on its own `mbarrier` by transaction
// count and is released by one arrival from each consumer warp right after
// its products on it have finished.  No block-wide barrier stands between
// two stages, and the producer runs on into the next conv's weights while
// the consumers finish a conv.  The consumers order their BUF and Z accesses
// among themselves with a named barrier over their 256 threads
// (`consumer_sync`).  A ninth warp puts three warps on one of the SM's four
// register files, which caps every thread at 168 registers: one A buffer a
// warpgroup fits (a second, to overlap a warpgroup's own products with its
// next A operands, spilled at C = 32).  The two warpgroups run unsynchronised
// and overlap each other.  (Measured against this on an H100, PERF.md: the
// consumers' own cp.async with a barrier a stage, thread 0 of the consumers
// as the producer, two-block clusters multicasting each stage, the
// warpgroups taking turns at the tensor cores.)
//
// Arithmetic.  fp32 is emulated with 3xTF32, a documented emulation: each
// operand v is split into hi = cvt.rna.tf32(v) and lo = cvt.rna.tf32(v - hi),
// and a_lo*b_hi + a_hi*b_lo + a_hi*b_hi is accumulated in fp32: three
// `wgmma`s a k8 step (two with STACK, a_hi*b_lo in its own accumulator
// columns, added in the epilogue).  The dropped a_lo*b_lo term is below
// 2^-22 of the product.  The bf16 instance of the MRF stage feeds values that are exact
// in bf16 (conv inputs rounded by the reference's rounding points, weights
// rounded by the caller), and a bf16 value is exact in TF32, so there one
// TF32 product per term is exact: one `wgmma` a k8 step, and the weights are
// packed without a lo part.  Whether to split is the chain's choice
// (`ROUND`), not each conv's: conv2's input was rounded when it was stored.
// `ROUND` repeats the rounding points of the fused-MRF reference for bf16
// activations: the conv inputs lrelu(x) and the masked lrelu(c1(..)) are
// rounded to bf16, the residual and every accumulation stay fp32.
//
// What bounds it.  The algorithm's operations over the TF32 rate bound both
// kernels; the design does 3x those in the fp32 instances, plus the halo
// rows and the rows of a conv's last m64 tile past its end.  Each pass
// streams the conv's packed weights (8 bytes a weight with both parts) from
// L2 into shared memory, 0.75 * (rows of the pass) operations a byte.  On
// an H100 (PERF.md, tools/probe_vocoder_core.py) the products run at 60-75 %
// of the TF32 rate where they run, and with them compiled out the stream
// and the A operands still take 44 % (C = 128) to 55 % (C = 256) of the
// time: the two overlap little.
#pragma once

#include "common.cuh"
#include "wgmma.cuh"

namespace emotts {

constexpr float kLreluSlope = 0.1f;
constexpr int kMaxDilations = 8;
// Two consumer warpgroups, then the producer warp.
constexpr int kConsumers = 256;
constexpr int kBlockThreads = kConsumers + 32;

struct DilationList {
  int n;
  int d[kMaxDilations];
};

__device__ __forceinline__ float lrelu(float v) {
  return v > 0.f ? v : v * kLreluSlope;
}

// The geometry (mirrored in emotts_torch/ops/resblock.py).  A ring stage is
// one 128-byte row for each of the C outputs, two (one a part) at C <= 64;
// the ring holds ring_stages(C) of them, 1024-byte aligned (the swizzle's
// period: up to 1008 bytes of a 16-byte-aligned base are skipped), and a
// full and an empty mbarrier each.
constexpr int kStageRowBytes = 128;
constexpr int kRingAlign = 1024;
__host__ __device__ constexpr int ring_stages(int C) { return C >= 256 ? 2 : 4; }
__host__ __device__ constexpr int stage_bytes(int C) {
  return (C <= 64 ? 2 : 1) * C * kStageRowBytes;
}
__host__ __device__ constexpr int ring_bytes(int C) {
  return kRingAlign + ring_stages(C) * (stage_bytes(C) + 16);
}
// The 128-bit fragment loads of a quarter warp read 16 floats from each of
// two neighbouring rows; they fill all 32 banks when the two rows start 16
// banks apart.  Rows are not padded: where a row is a multiple of 32 floats,
// its columns are swizzled, (row, col) at col ^ 16 in odd rows (`swz`).
__host__ __device__ constexpr int row_floats(int C) { return C; }
template <int L>
__device__ __forceinline__ int swz(int row) {
  return L % 32 == 0 ? (row & 1) << 4 : 0;  // a 16-float row needs none
}

// An activation buffer (BUF or Z): rows of C floats.
template <int C>
struct Rows {
  static constexpr int LDA = row_floats(C);
  // offset of activation (row, col)
  static __device__ __forceinline__ int at(int row, int col) {
    return row * LDA + (col ^ swz<LDA>(row));
  }
};

// The conv core's geometry for C channels and PARTS weight parts (2: hi and
// lo, 3xTF32; 1: the bf16 instance's single product).  With STACK (3xTF32 at
// C <= 64) a stage holds 32 input channels of both parts, the hi part's C
// rows then the lo part's, and a warpgroup's accumulators span both (2C
// columns: a_hi*b_hi and a_hi*b_lo side by side from one wgmma, a_lo*b_hi
// added to the first C by a second), which the epilogue sums: two wgmmas of
// N = 2C and C a k8 step in place of three of N = C, which run the tensor
// cores worst.  Else a stage row holds 16 channels of each part (KC = 16) or
// 32 of the one.
template <int C, int PARTS>
struct ConvGeom {
  static constexpr int NW = C < 128 ? C : 128;  // output columns of a warpgroup
  static constexpr int WG_N = C / NW;           // warpgroups along N
  static constexpr int WG_M = 2 / WG_N;         // warpgroups along M
  static constexpr bool STACK = PARTS == 2 && C <= 64;
  static constexpr int NACC = STACK ? 2 * NW : NW;  // accumulator columns
  // m64 tiles of a warpgroup a pass: 64 accumulator registers a thread, so
  // that each stage of weights serves as many rows as the registers allow
  static constexpr int MT = 128 / NACC;
  static constexpr int PASS_TILES = WG_M * MT;  // m64 tiles of a pass
  static constexpr int KC = STACK ? 32 : 32 / PARTS;  // input channels of a stage
  static constexpr int KS = KC / 8;                   // k8 steps of a stage
  static constexpr int STAGES = ring_stages(C);
  // the bytes of a stage's weights (the ring's stages are stage_bytes(C) apart)
  static constexpr int STAGE_BYTES = (STACK ? 2 : 1) * C * kStageRowBytes;
  static constexpr int STAGE_FLOATS = STAGE_BYTES / 4;
  static constexpr int CONV_FLOATS_PER_TAP = C * C * PARTS;  // packed
  static_assert(WG_N * NW == C && WG_M * WG_N == 2 && C % KC == 0 &&
                    (PARTS == 1 || PARTS == 2) && STAGES >= 2 &&
                    STAGE_BYTES <= stage_bytes(C),
                "unsupported channel count");
};

// Passes of a conv over `rows` rows.
template <int C, int PARTS>
__device__ __forceinline__ int conv_passes(int rows) {
  using G = ConvGeom<C, PARTS>;
  return ((rows + 63) / 64 + G::PASS_TILES - 1) / G::PASS_TILES;
}

// Total one-sided receptive field of a ResBlock1 chain.
__host__ __device__ inline int chain_halo(int k, const DilationList& dl) {
  const int r = (k - 1) / 2;
  int h = 0;
  for (int j = 0; j < dl.n; ++j) h += r * dl.d[j] + r;
  return h;
}

// The weight ring: its stages, their barriers and the position of one side
// (producer or consumers) in the sequence of stages.  full[s] completes when
// stage s has landed (the producer's expected bytes); empty[s] when all 8
// consumer warps have released it.
template <int C>
struct Ring {
  static constexpr int STAGES = ring_stages(C);
  uint32_t base;  // shared address of stage 0
  uint32_t bars;  // full[s] at bars + 8 s, empty[s] at bars + 8 (STAGES + s)
  int stage = 0;
  uint32_t phase = 0;  // flips each time the sequence wraps to stage 0

  // Carve the ring from the start of dynamic shared memory; returns the
  // first byte after it (16-byte aligned).
  __device__ __forceinline__ unsigned char* carve(unsigned char* smem) {
    unsigned char* p = wg::align_1024(smem);
    base = wg::smem_addr(p);
    p += STAGES * stage_bytes(C);
    bars = wg::smem_addr(p);
    return p + STAGES * 16;
  }
  __device__ __forceinline__ uint32_t stage_addr() const {
    return base + (uint32_t)(stage * stage_bytes(C));
  }
  __device__ __forceinline__ uint32_t full() const { return bars + 8 * stage; }
  __device__ __forceinline__ uint32_t empty() const {
    return bars + 8 * (STAGES + stage);
  }
  __device__ __forceinline__ void advance() {
    if (++stage == STAGES) {
      stage = 0;
      phase ^= 1;
    }
  }
  // One thread, before the block's first barrier.
  __device__ __forceinline__ void init() const {
    for (int s = 0; s < STAGES; ++s) {
      wg::mbar_init(bars + 8 * s, 1);
      wg::mbar_init(bars + 8 * (STAGES + s), kConsumers / 32);
    }
    wg::mbar_init_fence();
  }
};

// The producer's side of conv_rows: the conv's passes x k x C/KC stages of
// packed weights `w` (tap, chunk, out, 32), each one bulk copy into the
// next ring stage once the consumers have released it.  One thread.
template <int C, int PARTS>
__device__ __forceinline__ void produce_conv(Ring<C>& ring, const float* w, int k,
                                             int rows) {
  using G = ConvGeom<C, PARTS>;
  const int n_pass = conv_passes<C, PARTS>(rows);
  const int n_chunk = k * (C / G::KC);
  for (int pass = 0; pass < n_pass; ++pass)
    for (int c = 0; c < n_chunk; ++c) {
      // the phase before a barrier's first counts as complete
      wg::mbar_wait(ring.empty(), ring.phase ^ 1);
      wg::mbar_expect_tx(ring.full(), G::STAGE_BYTES);
      wg::bulk_load(ring.stage_addr(), w + (size_t)c * G::STAGE_FLOATS, G::STAGE_BYTES,
                    ring.full());  // the stage's weights: STAGE_BYTES of stage_bytes(C)
      ring.advance();
    }
}

// The consumers' barrier for their BUF and Z accesses: named barrier 1 over
// their 256 threads (the producer warp never joins it).
__device__ __forceinline__ void consumer_sync() { wg::barrier_sync(1, kConsumers); }

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
    *reinterpret_cast<float2*>(z + Rows<C>::at(row, col)) = make_float2(v0, v1);
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
    float2* p = reinterpret_cast<float2*>(buf + Rows<C>::at(row, col));
    const float2 x = *p;
    *p = in_seq ? make_float2(x.x + a0, x.y + a1) : make_float2(0.f, 0.f);
  }
};

// out[row, :] = bias + sum_tap act(in[row + (tap - r) * dil, :]) @ w[tap]
// for rows in [q_lo, q_hi) of the shared-memory buffer `in` (rows
// [row_lo, row_hi) of stride LDA), on the tensor cores, its weight stages
// taken from `ring` in the order the producer fills them (produce_conv).
// ACT_IN applies lrelu (and with ROUND_IN the bf16 rounding) to the inputs
// as they are read; PARTS = 2 selects 3xTF32.  All consumer threads call
// this together, after a consumer_sync that ends every earlier write of
// `in`.
template <int C, int PARTS, bool ACT_IN, bool ROUND_IN, typename Epilogue>
__device__ __forceinline__ void conv_rows(const float* __restrict__ in, int row_lo,
                                          int row_hi, int q_lo, int q_hi,
                                          const float* __restrict__ bias, int k,
                                          int dil, Ring<C>& ring, const Epilogue& epi) {
  using G = ConvGeom<C, PARTS>;
  constexpr int LDA = Rows<C>::LDA, MT = G::MT, KS = G::KS, NW = G::NW;
  constexpr int CHUNKS_PER_TAP = C / G::KC;
  constexpr bool SPLIT = PARTS == 2;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;  // fragment row group, thread in group
  const int wg_i = warp >> 2, wq = warp & 3;  // warpgroup, warp in it
  const int wm = wg_i % G::WG_M, wn = wg_i / G::WG_M;
  const int n0 = wn * NW;
  const int r = (k - 1) / 2;
  const int n_mt = (q_hi - q_lo + 63) / 64;
  const int n_pass = conv_passes<C, PARTS>(q_hi - q_lo);
  const int n_chunk = k * CHUNKS_PER_TAP;

  constexpr int NACC = G::NACC;
  float acc[MT][NACC / 2];
  int mt0[MT];  // buffer row of this thread's first A row in each m64 tile
  bool on[MT];  // whether the tile is in the conv: the same for the whole warpgroup

  // This thread's A operands of stage c, read before its weights have
  // landed: rows g and g + 8 of its warp's 16 in each tile; rows past q_hi
  // are computed on clamped addresses and never stored.  Columns
  // 4*t4 .. 4*t4 + 3 of each 16 channels come in one 128-bit load, k8 step
  // 2v + s taking columns 4*t4 + 2s (fragment column t4) and 4*t4 + 2s + 1
  // (column t4 + 4).  [tile][k8 step][part: hi, lo][fragment register]
  uint32_t a[MT][KS][PARTS][4];
  auto prep = [&](int c) {
    const int tap = c / CHUNKS_PER_TAP;
    const int ci0 = (c - tap * CHUNKS_PER_TAP) * G::KC;
    const int shift = (tap - r) * dil;
#pragma unroll
    for (int j = 0; j < MT; ++j) {
      if (!on[j]) continue;
      float4 raw[2][KS / 2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        int src = mt0[j] + 8 * h + shift;
        src = src < row_lo ? row_lo : (src >= row_hi ? row_hi - 1 : src);
        const float* p = in + src * LDA;
        const int sw = swz<LDA>(src);
#pragma unroll
        for (int v = 0; v < KS / 2; ++v)
          raw[h][v] = *reinterpret_cast<const float4*>(p + ((ci0 + 16 * v + 4 * t4) ^ sw));
      }
#pragma unroll
      for (int s = 0; s < KS; ++s) {
        const int v = s >> 1, o = 2 * (s & 1);
        float e4[4] = {o ? raw[0][v].z : raw[0][v].x, o ? raw[1][v].z : raw[1][v].x,
                       o ? raw[0][v].w : raw[0][v].y, o ? raw[1][v].w : raw[1][v].y};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = e4[e];
          if (ACT_IN) {
            x = lrelu(x);
            if (ROUND_IN) x = round_bf16(x);
          }
          uint32_t lo;
          split_tf32<SPLIT>(x, a[j][s][0][e], lo);
          if constexpr (SPLIT) a[j][s][PARTS - 1][e] = lo;
        }
      }
    }
  };

  for (int pass = 0; pass < n_pass; ++pass) {
#pragma unroll
    for (int j = 0; j < MT; ++j) {
      const int mt = pass * G::PASS_TILES + j * G::WG_M + wm;
      on[j] = mt < n_mt;
      mt0[j] = q_lo + mt * 64 + wq * 16 + g;
#pragma unroll
      for (int i = 0; i < NACC / 8; ++i) {
        // the bias in the output columns; 0 in a STACK tile's a_hi*b_lo half
        const float2 b =
            i < NW / 8 ? __ldg(reinterpret_cast<const float2*>(bias + n0 + 8 * i + 2 * t4))
                       : make_float2(0.f, 0.f);
        acc[j][4 * i] = acc[j][4 * i + 2] = b.x;
        acc[j][4 * i + 1] = acc[j][4 * i + 3] = b.y;
      }
    }
    for (int c = 0; c < n_chunk; ++c) {
      prep(c);
      wg::mbar_wait(ring.full(), ring.phase);
      // B of this warpgroup's columns: rows n0 .. n0 + NW of the stage, the
      // hi part at byte 0 of a row and the lo part at byte 64 (3xTF32, not
      // STACK).  KS k8 steps: three wgmmas each (a_lo*b_hi, a_hi*b_lo,
      // a_hi*b_hi); with STACK two, over rows [hi | lo] and [hi]; else one.
      const uint32_t sb = ring.stage_addr() + (uint32_t)(n0 * kStageRowBytes);
      wg::fence();
#pragma unroll
      for (int s = 0; s < KS; ++s) {
        const uint64_t bh = wg::desc(sb + 32 * s);
        const uint64_t bl = wg::desc(sb + 64 + 32 * s);
#pragma unroll
        for (int j = 0; j < MT; ++j) {
          if (!on[j]) continue;
          if constexpr (G::STACK) {
            wg::mma_tf32_rs(acc[j], a[j][s][0], bh);  // [a_hi*b_hi | a_hi*b_lo]
            if (SPLIT)                                 // a_lo*b_hi
              wg::mma_tf32_rs(reinterpret_cast<float(&)[NW / 2]>(acc[j]),
                              a[j][s][PARTS - 1], bh);
          } else {
            if (SPLIT) {
              wg::mma_tf32_rs(acc[j], a[j][s][PARTS - 1], bh);
              wg::mma_tf32_rs(acc[j], a[j][s][0], bl);
            }
            wg::mma_tf32_rs(acc[j], a[j][s][0], bh);
          }
        }
      }
      wg::commit();
      wg::wait<0>();
#pragma unroll
      for (int j = 0; j < MT; ++j) {
        wg::fence_regs(acc[j]);
        wg::fence_regs(a[j]);
      }
      // this warp is done with the stage
      __syncwarp();
      if (lane == 0) wg::mbar_arrive(ring.empty());
      ring.advance();
    }
#pragma unroll
    for (int j = 0; j < MT; ++j) {
      if (!on[j]) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = mt0[j] + 8 * h;
        if (row >= q_hi) continue;
#pragma unroll
        for (int i = 0; i < NW / 8; ++i) {
          float v0 = acc[j][4 * i + 2 * h], v1 = acc[j][4 * i + 2 * h + 1];
          if constexpr (G::STACK) {  // + a_hi*b_lo, NW columns on
            v0 += acc[j][4 * (i + NW / 8) + 2 * h];
            v1 += acc[j][4 * (i + NW / 8) + 2 * h + 1];
          }
          epi(row, n0 + 8 * i + 2 * t4, v0, v1);
        }
      }
    }
  }
}

// First buffer row of Z that a chain over a window with `halo` rows a side
// uses: conv1 of the first step writes rows from (halo - chain_halo) + r*d0.
// Z holds rows [z_offset, n_rows - z_offset) only: for one dilation step
// that is the tile and r rows a side, not the whole window.
__host__ __device__ inline int z_offset(int k, const DilationList& dl, int halo) {
  return halo - chain_halo(k, dl) + (k - 1) / 2 * dl.d[0];
}

// The convs of a chain in order: f(step, second conv?, q_lo, q_hi, dil) over
// buffer rows [q_lo, q_hi).  conv1 of a step covers the rows the later steps
// still need plus r a side, conv2 those rows.  Consumers and producer both
// walk it, so they agree on every conv's passes.
template <typename F>
__device__ __forceinline__ void chain_convs(int k, const DilationList& dl, int halo,
                                            int tile, F&& f) {
  const int r = (k - 1) / 2;
  int rem = chain_halo(k, dl);
  for (int j = 0; j < dl.n; ++j) {
    rem -= r * dl.d[j] + r;  // halo the later steps still need
    const int o_lo = halo - rem;
    const int o_hi = halo + tile + rem;
    f(j, false, o_lo - r, o_hi + r, dl.d[j]);
    f(j, true, o_lo, o_hi, 1);
  }
}

// Run one ResBlock1 chain on BUF in place.  BUF rows [halo - chain_halo,
// halo + tile + chain_halo) must hold x (0 outside the sequence); on return
// rows [halo, halo + tile) hold the block's output.  `t0` is the time index
// of buffer row `halo`.  Z holds buffer rows [zoff, n_rows - zoff), zoff at
// most z_offset(k, dl, halo).  With ROUND (the bf16 MRF instance) the conv
// inputs are rounded to bf16 and the products are single TF32; else 3xTF32.
// Its weight stages come from `ring`, filled by produce_chain<C, PARTS> over
// the same chain.  Consumer threads only.
template <int C, bool ROUND>
__device__ __forceinline__ void resblock_chain(float* buf, float* z_alloc, int zoff,
                                               Ring<C>& ring, int n_rows, int halo,
                                               int tile, long long t0,
                                               long long t_len, const float* b1,
                                               const float* b2, int k,
                                               const DilationList& dl) {
  constexpr int PARTS = ROUND ? 1 : 2;
  float* z = z_alloc - zoff * Rows<C>::LDA;  // indexed by buffer row
  const StoreZ<C, ROUND> store_z{z, t0 - halo, t_len};
  const AddResidual<C> add_res{buf, t0 - halo, t_len};
  chain_convs(k, dl, halo, tile, [&](int j, bool second, int q_lo, int q_hi, int dil) {
    if (!second)
      conv_rows<C, PARTS, true, ROUND>(buf, 0, n_rows, q_lo, q_hi, b1 + j * C, k, dil,
                                       ring, store_z);
    else
      conv_rows<C, PARTS, false, false>(z, zoff, n_rows - zoff, q_lo, q_hi, b2 + j * C,
                                        k, dil, ring, add_res);
    consumer_sync();
  });
}

// The producer's side of resblock_chain.
template <int C, int PARTS>
__device__ __forceinline__ void produce_chain(Ring<C>& ring, int halo, int tile,
                                              const float* w1, const float* w2, int k,
                                              const DilationList& dl) {
  const size_t per_step = (size_t)k * ConvGeom<C, PARTS>::CONV_FLOATS_PER_TAP;
  chain_convs(k, dl, halo, tile, [&](int j, bool second, int q_lo, int q_hi, int) {
    produce_conv<C, PARTS>(ring, (second ? w2 : w1) + j * per_step, k, q_hi - q_lo);
  });
}

// The first part of every kernel on the core: carve shared memory (BUF into
// `buf`), set up the ring's barriers and send the producer warp through the
// block's stages (`produce`: the chains of the block in order).  Returns
// false in the producer warp, which then has nothing more to do.
template <int C, typename Produce>
__device__ __forceinline__ bool start_block(unsigned char* smem, Ring<C>& ring,
                                            float*& buf, const Produce& produce) {
  buf = reinterpret_cast<float*>(ring.carve(smem));
  if (threadIdx.x == 0) ring.init();
  __syncthreads();
  if (threadIdx.x >= kConsumers) {
    if (threadIdx.x == kConsumers) produce();
    return false;
  }
  return true;
}

// Load rows [q_lo, q_hi) of the window into BUF from x (B, T, C); 0 outside
// the sequence.  Consumer threads only.
template <typename T, int C>
__device__ __forceinline__ void load_window(float* buf, const T* __restrict__ x,
                                            long long batch, long long t_len,
                                            long long t_of_row0, int q_lo, int q_hi) {
  const int n = (q_hi - q_lo) * C;
  for (int e = threadIdx.x; e < n; e += kConsumers) {
    const int row = q_lo + e / C;
    const int c = e % C;
    const long long t = t_of_row0 + row;
    float v = 0.f;
    if (t >= 0 && t < t_len) v = to_float(x[(batch * t_len + t) * C + c]);
    buf[Rows<C>::at(row, c)] = v;
  }
}

// Dynamic shared memory of a chain in bytes: the weight ring (with its
// alignment and barriers), BUF and Z.
inline size_t chain_smem_bytes(int C, int tile, int halo, int zoff) {
  return (size_t)ring_bytes(C) +
         (size_t)(2 * tile + 4 * halo - 2 * zoff) * row_floats(C) * sizeof(float);
}

}  // namespace emotts
