// Fused self-attention backward for the FFT blocks (training).
//
// Replaces the Pallas kernel `_bwd_kernel` of emotts/ops/attention.py
// (reached through the custom VJP of `fused_attention`).  Per (batch, head),
// with P the softmax of S = (Q K^T) * scale + bias cast to the compute type
// and P_d = keep ? P / (1 - rate) : 0 its dropped-out form:
//   dV   = P_d^T dO
//   dP_d = dO V^T ;  dP = keep ? dP_d / (1 - rate) : 0
//   dS   = P * (dP - rowsum(dP * P)) * scale      (fp32, then cast)
//   dQ   = dS K ;  dK = dS^T Q
// All five products accumulate in fp32; P enters P_d^T dO and dS enters its
// two products in the compute type, as in the reference.
//
// The TPU kernel recomputes a whole (T, T) probability block on chip from q,
// k and the bias.  A Hopper block has 227 KB, so these kernels tile, and a
// tile of P needs each query row's softmax maximum and sum before it can be
// formed: the forward kernel writes them (`stats`, 2*B*H*T floats) when a
// gradient is wanted, and no pre-pass recomputes them here.
//
// rowsum(dP * P) needs every key of a row before the first dS tile exists.
// It equals rowsum(dO * O) for an unrounded O, but the O that the forward
// pass returns is rounded, and its probabilities were rounded before they
// were normalised: with bf16 inputs that loses the exact cancellation in
// dP - rowsum(dP * P) for rows that attend to a few keys only (measured on
// the card: errors of 0.06 in dK where the plain version has values below
// 2).  So the sum is taken as the reference takes it, from the same rounded
// P that forms dS, in a sweep of its own over the key tiles.
//
// Two launches a call in either dtype, a delta pass and a fused pass, and no
// atomic whose order varies, so that a repeated call gives the same bits.  The dropout mask is the one the
// forward kernel draws from (seed, head, query, key) (attention_common.cuh).
//
// What bounds it on this card: 10*B*H*T^2*D operations against
// (4 reads + 3 writes)*B*T*H*D*itemsize + statistics bytes, so operations
// from T of a few hundred on.
//
// Padding: the bias is additive -1e9, so a padded key has P = 0 exactly and
// a fully padded query row has uniform P and a finite gradient, as in the
// reference.  Query and key slots beyond T in a last tile are given P = 0,
// so they add nothing to rows that exist, and are never written.
//
// bf16: on the tensor cores (wgmma, sm_90a; building blocks in wgmma.cuh),
// P, dP and dS formed once per (query tile, key tile) pair: 14 B*H*T^2*D
// operations (the delta pass's two products, the fused pass's five) against
// the algorithm's 10, and two passes of exponentials.  Tiles are copied by
// TMA into 128-byte swizzled, double-buffered stages on mbarriers (rows
// beyond T and columns beyond D come in as zeros; D rounded up to whole
// 64-column blocks, NB of them); the statistics, the bias and the keep
// words come by 4-byte cp.async.  Both passes form P with `prob`: 2^(S *
// scale * log2(e) + bias * log2(e) - lse2), lse2 = m * log2(e) + log2(l)
// of the row, one add, one fma and one ex2 an entry.
//  - delta pass (`attention_bwd_delta_tc_kernel`): one block per 128
//    queries, two warpgroups of 64 query rows sharing the K and V tiles (64
//    keys; 32 at D = 256).  Per tile S = Q K^T and dP_d = dO V^T, P rounded
//    to bf16, delta += rowsum(dP * P) in each thread's fp32 sum in key
//    order, then the four lanes of a row in a fixed butterfly.  At rate > 0
//    it draws each 4-key Philox word once (lanes c and c ^ 1 share a word's
//    group: each draws it for one of its two rows and hands the other the
//    two words it keeps) and writes the keep bits as words of 32 keys, (B,
//    H, ceil(T / 32), T) uint32, which the fused pass reads instead of
//    drawing.  It sets the fused pass's dQ counters to 0.  Shared memory: Q
//    and dO of 128 rows, two stages of K and V and their bias: 193.5 KB at D
//    = 192 and 256.
//  - fused pass (`attention_bwd_fused_tc_kernel`): one block per 64 keys, two
//    warpgroups with their own roles; keys are the rows of every product but
//    dQ's (M = 64), so a key's values sit in one row of registers.  Per
//    64-query tile (one step):
//      warpgroup 0: S^T = K Q^T; P^T rounded to bf16; P_d^T from the keep
//                   words; P^T to an 8 KB scratch (bf16 pairs,
//                   register-major, a dropped entry with its sign bit set);
//                   dV += P_d^T dO, P_d^T the register A operand;
//      warpgroup 1: dP_d^T = V dO^T, and lse2 of the tile's queries while
//                   that product runs; dS^T = P^T (dP^T - delta) * scale,
//                   rounded, the register A operand of dK += dS^T Q and a
//                   swizzled 64 x 64 tile in shared memory;
//      both:        the tile's dQ partial dS K, A = that tile read MN-major
//                   (no transpose); warpgroup 1 the first ceil(NB / 2)
//                   column blocks, warpgroup 0 the rest.
//    What each warpgroup holds: dV or dK (NB * 32 fp32 registers a thread, 96
//    at D = 192), its share of the dQ partial (ceil(NB / 2) * 32), S^T or
//    dP_d^T (32) and the A fragments (16).  dV, dK and dQ's products take
//    the whole width in one wgmma a 16-deep step (m64nNk16, N up to 256).
//    Named barriers hand over lse2 (2), P^T (1) and dS^T (3).  The steps
//    overlap: a step issues its S^T or dP_d^T product while the previous
//    step's dV, dK and dQ products still run, waits for those (wait<1>), and
//    the previous step's dQ partial is added under the new products.  No
//    __syncthreads a step: the stage's barrier counts both its TMA bytes and
//    warpgroup 0's cp.async arrivals, and warpgroup 0 refills the other
//    stage once both warpgroups are past wait<1> (barrier 2).  Shared
//    memory: K and V, two stages of Q and dO, the dS^T tile, the P^T
//    scratch, statistics and keep words: 163.5 KB at D = 192, 211.5 KB at
//    D = 256.
//  - dQ in a fixed order.  The partials of a query tile are added into an
//    fp32 workspace (per 64-query tile 64 * 64 * NB floats in the
//    accumulators' register order, so that a warp's adds cover 512
//    contiguous bytes) in one fixed order of key tiles, so the sum's bits do
//    not depend on which block gets there first.  A counter per (b, h, query
//    tile) says whose turn it is: warpgroup 1's thread 0 waits for the turn
//    (acquire) while its dP_d^T product runs and passes it on through
//    barriers 5 and 4; the first turn stores, later turns add with `red` (the
//    turn is exclusive), the last adds its partial to the sum it loads and
//    rounds to bf16 into dq; thread 0 hands the turn on after barrier 3, by
//    which every thread's adds are done, with an add of release semantics
//    (it covers the other threads' adds, ordered before it by the barrier;
//    no separate fence).  Blocks are
//    launched in the order of their linear index and the key tile is the
//    grid's fastest index, so the blocks of one (b, h) start in key-tile
//    order.  Where they fit on the card together (the host checks the key
//    tiles against the SMs), block kt takes query tile (kt + step) % nqt at
//    step `step`, its turn is `step`, and the turn before it is block kt +
//    1's, taken one step earlier: no block starts by waiting.  Otherwise
//    every block takes tile `step` and the order is the key-tile order, in
//    which a block waits only for blocks launched before it.
//  - Rounding points as the reference: P rounded to bf16 before it enters
//    dS and (dropped out and rounded again) dV; dS rounded to bf16 before dQ
//    and dK.  Rounding of a single value is integer arithmetic
//    (round_bf16_alu), of a pair one conversion instruction: the conversion
//    unit is the one the exponentials use.
//  - Registers a thread and spill bytes (stores/loads) as ptxas reports them
//    (tools/profile_attention_f32.py), rate 0 / rate > 0:
//      delta pass  D = 32, 64: 90 / 140;  96, 128: 113 / 154;
//                  192: 123 / 145;  256: 96 / 122; no spills;
//      fused pass  D = 32: 142 / 142;  64: 156 / 154;  96, 128: 190 / 190;
//                  192: 240 / 238, no spills;  256: 255 / 255 with 60 / 92
//                  bytes spilled (no model of the repo has D = 256).
// fp32: the bf16 instance's schedule, a delta pass and then a fused pass
// that forms P, dP and dS once per (query tile, key tile) pair: 14 B*H*T^2*D
// operations, two passes of exponentials, each Philox word drawn once a
// call.  The products run on the tensor cores through mma.sync.m16n8k8 with
// TF32 operands, each as three (3xTF32: lo*hi + hi*lo + hi*hi).
// Not wgmma: TF32 wgmma takes its shared-memory operands K-major only (the
// transpose bits exist for 16-bit types) and 3xTF32 needs a lo copy of each
// shared-memory operand.  dV += P_d^T dO, dK += dS^T Q and dQ = dS K would
// need dO, Q and K transposed and split in shared memory; S^T = K Q^T and
// dP_d^T = V dO^T read Q and dO K-major as stored, but their lo copies (24
// KB a 32-row tile each, two stages) do not fit beside what the fused pass
// holds (222 KB at D = 192).  mma.sync takes both operands from registers,
// split as they are loaded from fp32 tiles.  The split is integer
// arithmetic (`split_tf32_alu`: hi rounded to nearest as cvt.rna.tf32 rounds
// it, lo = v - hi read truncated by the tensor cores): with two cvt a value
// on the conversion unit, at a quarter of the ALU's rate, the splits and not
// the products set the time (2.72 ms at (16,1024,2,192) against 2.04,
// tools/probe_attention_bwd.py; PERF.md, PR 16).  Every tile is fp32
// at a row stride of D + 4 floats (conflict-free fragment loads along either
// index).  A fresh result (P^T, dS^T) is the A operand of the next product
// straight from its accumulator: the rows of the other operand are read in
// the C fragment's order (slot t is row 2t, slot t + 4 row 2t + 1), so
// nothing is shuffled.  Both passes form P with `prob`, as the bf16 passes
// do (base-2 exponent from the row's lse2, one ex2 an entry, `log2e_for` for
// an example whose keys are all padded).
//  - delta pass (`attention_bwd_delta_f32_kernel`): one block per 64
//    queries (Q and dO of 128 rows would fill shared memory alone); K and V
//    in double-buffered tiles of 32 keys (16 at D = 256), copied by 16-byte
//    cp.async with rows beyond T zero-filled.  Two groups of 4 warps (16
//    query rows a warp) take half of every key tile each: per tile and warp
//    S = Q K^T and dP_d = dO V^T (16 x 16), delta += rowsum(dP * P) in each
//    thread's fp32 sum in key order, then over the four lanes of a row and
//    the two groups in a fixed order.  At rate > 0 it draws each 4-key
//    Philox word once (lanes t and t ^ 1 share a word's group: each draws
//    it for one of its two rows and hands the other the two words it keeps)
//    and writes the keep bits in the bf16 pass's format, words of 32 keys,
//    (B, H, ceil(T / 32), T) uint32, each group storing the bytes of its
//    keys.  It sets the fused pass's dQ counters to 0.  Shared memory: Q and
//    dO, two stages of K and V, their bias, the groups' shares of delta:
//    201,472 bytes at D = 192, 200,320 at D = 256.
//  - fused pass (`attention_bwd_fused_f32_kernel`): one block per 64 keys,
//    the rows of S^T, dP^T, dV and dK; 16 warps in four groups of 4 (16 keys
//    a warp), (role, half): role 0 forms S^T and P^T and accumulates dV,
//    role 1 forms dP^T and dS^T and accumulates dK; each group forms its
//    role's tile for half of the step's queries and accumulates half of the
//    columns of dV or dK (48 accumulator registers a thread at D = 192).
//    Per tile of 32 queries (16 at D = 256), a step:
//      role 0: S^T = K Q^T of the half's queries; P^T, and P_d^T from the
//              keep words; P^T to a scratch (fp32, register-major, a dropped
//              entry with its sign bit set; two scratches, for even and odd
//              steps);
//      role 1: dP_d^T = V dO^T of the half's queries; after named barrier 1,
//              dS^T = P^T (dP^T - delta) * scale, also stored to a dS^T
//              tile (keys x queries, stride BQ + 4);
//      all:    after barrier 2, the other half's P_d^T (from the scratch) or
//              dS^T (from the tile), then dV += P_d^T dO or dK += dS^T Q
//              over the group's columns; the tile's dQ partial dS K, a part
//              of 16 queries by D / 8 columns a warp (D / 16 at D = 256), A
//              read from the dS^T tile in the key order of a C fragment,
//              added into dq (below).
//    Loads: K and V once, by warp 1; the Q and dO rows of each step by bulk
//    copies, one a row (the tiles keep their padded stride, which no TMA
//    box writes), their m, l, delta and keep words by cp.async, all counted
//    on the stage's mbarrier and issued by warp 0 into the other stage once
//    its dV product is done (every thread is then past the step that read
//    that stage); rows beyond T are stored as zeros.  No __syncthreads a
//    step: the stage's mbarrier, barrier 1 (P^T) and barrier 2 (P^T and
//    dS^T of both halves).  Shared memory: K and V, two stages of Q and dO,
//    the two P^T scratches, the dS^T tile, statistics and keep words:
//    227,608 bytes at D = 192, 213,656 at D = 256.
//  - dQ in a fixed order, into dq itself: fp32 needs no workspace, since a
//    turn stores or adds its fp32 pairs where they belong.  A counter per
//    (b, h, query tile) counts the warps whose adds are done, DQW a turn (16
//    at D = 64, 128, 192, 256; 12 at 96; 8 at 32): a warp's lane 0 waits
//    (acquire) until the counter reaches DQW * turn, the first turn stores,
//    later turns add (so each element gets its adds in turn order), and lane
//    0 counts the warp in with release semantics once the warp's adds are
//    issued.  The turns follow the bf16 pass's two orders.  Where the key
//    tiles of one (b, h) fit on the SMs together (`rotate`, set by the host)
//    block kt starts on query tile R kt (R = 64 / the query tile: 2, or 4 at
//    D = 256), the first of its own keys' rows, and walks on from there:
//    tile i = R a + c is taken by block a first and then by blocks a - 1,
//    a - 2, ... (mod the key tiles), R steps apart each, so a block waits
//    only for one a turn ahead, which took the tile R steps before.
//    Otherwise every block takes tile `step` and its turn is its key tile.
//  - Registers a thread as ptxas reports them (tools/profile_attention_f32.py),
//    rate 0 / rate > 0:
//      delta pass  D = 32: 85 / 100;  64: 97 / 130;  96: 102 / 130;
//                  128: 104 / 130;  192: 106 / 130;  256: 82 / 112;
//      fused pass  D = 32: 99 / 95;  64: 98 / 101;  96: 105 / 118;
//                  128: 106 / 109;  192: 127 / 127;  256: 128 / 128, and at
//                  rate > 0 40 / 40 bytes spilled (stores / loads; no model
//                  of the repo has D = 256); no other spills.
//    At (16,1024,2,192) the two passes run their TF32 products (3 x 14
//    B*H*T^2*D operations) at about 130 TFLOP/s, where the card runs
//    independent mma.sync TF32 products at 260-313 from 8-32 warps an SM
//    (the same tool): each warp loads and splits every operand value it
//    multiplies, and a value of Q, dO or K is loaded and split by every warp
//    that takes it.
#include "attention_common.cuh"

#include <math.h>

namespace emotts {

struct BwdArgs {
  const void *q, *k, *v;
  const float* bias;
  const int* seeds;
  const float* stats;
  const void* dout;
  void *dq, *dk, *dv;
  float* delta;
  uint32_t* keep;   // the delta pass's keep words (rate > 0)
  float* dq_acc;    // bf16 only: the fp32 dQ workspace
  int* counters;    // the dQ adds' turns
  int B, T, H;
  uint32_t thresh;
  float inv_keep;
  cudaStream_t stream;
};

// ---------------------------------------------------------------------------
// bf16 on the tensor cores
// ---------------------------------------------------------------------------

// Waiting for a turn and handing it on (the ordered dQ adds): one thread
// loads the counter with acquire semantics until it reaches the block's
// turn, and a barrier passes the turn to the others; after their adds and a
// barrier, one thread advances the counter with release semantics.  A wait
// that has not ended after some seconds traps, so that a broken order fails
// the launch instead of hanging the card.
__device__ __forceinline__ int ld_acquire_gpu(const int* p) {
  int v;
  asm volatile("ld.global.acquire.gpu.b32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}
__device__ __forceinline__ void red_release_gpu_add(int* p, int v) {
  asm volatile("red.release.gpu.global.add.s32 [%0], %1;\n" ::"l"(p), "r"(v) : "memory");
}
__device__ __forceinline__ void wait_turn(const int* counter, int turn) {
  for (uint32_t n = 0; ld_acquire_gpu(counter) != turn; ++n) {
    if (n == (1u << 22)) __trap();
    __nanosleep(64);
  }
}

// P of one entry, exp(S * scale + bias - m) / l, as 2^(S * scale2 + bias2 -
// lse2) with scale2 = scale * log2(e), bias2 the bias times log2(e) and
// lse2 = m * log2(e) + log2(l) of the entry's row (`row_lse2`): one add, one
// fma and one ex2 an entry.  Both passes form P with these functions, from
// the same inputs, so they agree bit for bit.  An example whose keys are all
// padded (bias -1e9) has every row's maximum near -1e9, and S * scale +
// bias, rounded at that magnitude, is the same for every key, so its P is
// uniform; `log2e_for` gives such an example the factor 0 in place of
// log2(e), which makes every exponent -log2(l) and P = 1 / l, as the
// forward's statistics have it.
constexpr float kLog2e = 1.4426950408889634f;
__device__ __forceinline__ float log2e_for(float row0_max) {
  return row0_max < -1e8f ? 0.f : kLog2e;
}
__device__ __forceinline__ float row_lse2(float m, float l, float lg) {
  float l2;
  asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(l2) : "f"(l));
  return fmaf(m, lg, l2);
}
__device__ __forceinline__ float prob(float s, float scale2, float bias2, float lse2) {
  float e;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(e) : "f"(fmaf(s, scale2, bias2 - lse2)));
  return e;
}

template <int D>
struct BwdDeltaTc {
  static constexpr int DP = TcWidth<D>::DP;
  static constexpr int BQ = 128;               // two warpgroups of 64 queries
  static constexpr int BK = D > 192 ? 32 : 64;  // keys per tile
  static constexpr int THREADS = 256;
  static constexpr int Q_BYTES = BQ * DP * 2;   // Q or dO
  static constexpr int KV_BYTES = BK * DP * 2;  // one K or V tile
  // Q, dO; stage s: K at 2s, V at 2s + 1 (in KV tiles); the bias of both
  // stages; the copy barrier of each stage
  static constexpr int BIAS = 2 * Q_BYTES + 4 * KV_BYTES;
  static constexpr int BARS = BIAS + 2 * BK * 4;
  static constexpr int SMEM = 1024 + BARS + 2 * 8;
};

// The delta pass: one block per 128 queries, a sweep over the key tiles.
// Writes delta = rowsum(dP * P) and, with dropout, the keep bits of every
// (query, key) as words of 32 keys; sets the fused pass's dQ counters of its
// query tiles to 0.
template <int D, bool DROP>
__global__ void __launch_bounds__(BwdDeltaTc<D>::THREADS, 1)
attention_bwd_delta_tc_kernel(const __grid_constant__ CUtensorMap tm_q,
                              const __grid_constant__ CUtensorMap tm_k,
                              const __grid_constant__ CUtensorMap tm_v,
                              const __grid_constant__ CUtensorMap tm_do,
                              const float* __restrict__ bias,
                              const int* __restrict__ seeds,
                              const float* __restrict__ stats,
                              float* __restrict__ delta_out,
                              uint32_t* __restrict__ keep_out,
                              int* __restrict__ counters, int Tlen, int H,
                              float scale, uint32_t thresh, float inv_keep) {
  using C = BwdDeltaTc<D>;
  constexpr int NS = C::BK / 2;   // accumulator registers of an S tile
  constexpr int NW = C::BK / 32;  // keep words of a row in a key tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = wg::align_1024(smem_raw);
  const uint32_t sQ = wg::smem_addr(smem);
  const uint32_t sDO = sQ + C::Q_BYTES;
  const uint32_t sKV = sDO + C::Q_BYTES;
  float* sBias = reinterpret_cast<float*>(smem + C::BIAS);
  const uint32_t sBiasAddr = sQ + C::BIAS;
  const uint32_t bar = sQ + C::BARS;  // stage s: bar + 8 s

  const int tid = threadIdx.x;
  const int wgi = tid >> 7;
  const int warp = (tid >> 5) & 3;
  const int g = (tid & 31) >> 2, c = tid & 3;
  const int q0 = blockIdx.x * C::BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const long long bh = (long long)b * H + h;
  const long long stat_row = bh * Tlen;
  const long long stat_plane = (long long)gridDim.z * H * Tlen;
  const float* bias_b = bias + (long long)b * Tlen;
  const int nkt = (Tlen + C::BK - 1) / C::BK;
  const int kwords = (Tlen + 31) / 32;
  const int row0 = q0 + 64 * wgi + 16 * warp + g;  // rows row0, row0 + 8
  const uint32_t sQw = sQ + wgi * 64 * 128, sDOw = sDO + wgi * 64 * 128;
  const uint32_t key = DROP ? dropout_key(seeds[b], h) : 0u;

  if (tid < C::BQ / 64) {
    const int nqt = (Tlen + 63) / 64, qt = blockIdx.x * (C::BQ / 64) + tid;
    if (qt < nqt) counters[bh * nqt + qt] = 0;
  }

  // K, V of tile j into stage s by TMA (thread 0), the bias by cp.async
  auto load_kv = [&](int j, int s, uint32_t extra_bytes) {
    const int k0 = j * C::BK;
    const uint32_t sK = sKV + 2 * s * C::KV_BYTES;
    if (tid == 0) {
      wg::mbar_expect_tx(bar + 8 * s, 2 * C::KV_BYTES + extra_bytes);
      tma_tile<D, C::BK>(sK, tm_k, bar + 8 * s, h, k0, b);
      tma_tile<D, C::BK>(sK + C::KV_BYTES, tm_v, bar + 8 * s, h, k0, b);
    }
    if (tid < C::BK) {
      const int t = k0 + tid;
      wg::cp_async4(sBiasAddr + (s * C::BK + tid) * 4, bias_b + (t < Tlen ? t : 0),
                    t < Tlen);
    }
    wg::cp_async_commit();
  };

  if (tid == 0) {
    wg::mbar_init(bar, 1);
    wg::mbar_init(bar + 8, 1);
    wg::mbar_init_fence();
  }
  __syncthreads();
  load_kv(0, 0, 2 * C::Q_BYTES);
  if (tid == 0) {
    tma_tile<D, C::BQ>(sQ, tm_q, bar, h, q0, b);
    tma_tile<D, C::BQ>(sDO, tm_do, bar, h, q0, b);
  }

  const float lg = log2e_for(stats[stat_row]);
  const float scale2 = scale * lg;
  float lse2[2], dsum[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int t = row0 + 8 * r;
    // a row beyond T gets lse2 = inf, hence P = 0
    lse2[r] = t < Tlen ? row_lse2(stats[stat_row + t], stats[stat_plane + stat_row + t], lg)
                       : INFINITY;
  }

  for (int it = 0; it < nkt; ++it) {
    const int s = it & 1;
    const int k0 = it * C::BK;
    wg::mbar_wait(bar + 8 * s, (it >> 1) & 1);
    wg::cp_async_wait<0>();
    if (tid < C::BK) sBias[s * C::BK + tid] *= lg;  // the thread's own copy, as `prob` takes it
    __syncthreads();
    if (it + 1 < nkt) load_kv(it + 1, s ^ 1, 0);
    const uint32_t sK = sKV + 2 * s * C::KV_BYTES, sV = sK + C::KV_BYTES;

    // S = Q K^T, dP_d = dO V^T
    float sc[NS], dp[NS];
#pragma unroll
    for (int i = 0; i < NS; ++i) sc[i] = dp[i] = 0.f;
    wg::fence();
#pragma unroll
    for (int kk = 0; kk < C::DP / 16; ++kk) {
      wg::mma_ss(sc, wg::desc_k(sQw, C::BQ, kk), wg::desc_k(sK, C::BK, kk), kk > 0);
      wg::mma_ss(dp, wg::desc_k(sDOw, C::BQ, kk), wg::desc_k(sV, C::BK, kk), kk > 0);
    }
    wg::commit();
    wg::wait<0>();
    wg::fence_regs(sc);
    wg::fence_regs(dp);

    // only the last tile has key slots beyond T
    const bool full = k0 + C::BK <= Tlen;
    uint32_t kbits[2][NW];  // keep bits of rows row0, row0 + 8: word w, bit key % 32
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int w = 0; w < NW; ++w) kbits[r][w] = 0u;
#pragma unroll
    for (int i = 0; i < C::BK / 8; ++i) {
      // keys k0 + 8i + 2c + e are words 2(c & 1) + e of group (k0 + 8i) / 4
      // + c / 2: lanes c and c ^ 1 share the group, so the even lane draws
      // it for row0 and the odd one for row0 + 8, and each hands the other
      // the two words it keeps of its row.  One draw a word.
      uint32_t word[2][2] = {{0u, 0u}, {0u, 0u}};  // [row][e]
      if constexpr (DROP) {
        const int odd = c & 1;
        const uint4 w = dropout_bits(key, (uint32_t)(row0 + 8 * odd),
                                     (uint32_t)((k0 >> 2) + 2 * i + (c >> 1)));
        const uint32_t got0 = __shfl_xor_sync(0xffffffffu, odd ? w.x : w.z, 1);
        const uint32_t got1 = __shfl_xor_sync(0xffffffffu, odd ? w.y : w.w, 1);
        word[0][0] = odd ? got0 : w.x;
        word[0][1] = odd ? got1 : w.y;
        word[1][0] = odd ? w.z : got0;
        word[1][1] = odd ? w.w : got1;
      }
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = 8 * i + 2 * c + e;
          const int idx = 4 * i + 2 * r + e;
          float p = round_bf16_alu(
              prob(sc[idx], scale2, sBias[s * C::BK + col], lse2[r]));
          if (!full && k0 + col >= Tlen) p = 0.f;
          float dpv = dp[idx];
          if constexpr (DROP) {
            const bool keep = word[r][e] >= thresh;
            dpv = keep ? dpv * inv_keep : 0.f;
            kbits[r][i >> 2] |= (uint32_t)keep << (col & 31);
          }
          dsum[r] = fmaf(dpv, p, dsum[r]);
        }
    }
    if constexpr (DROP) {
      // the four lanes of a row hold disjoint bits; lane c stores entry c of
      // the row's 2 * NW words
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int w = 0; w < NW; ++w) {
          kbits[r][w] |= __shfl_xor_sync(0xffffffffu, kbits[r][w], 1);
          kbits[r][w] |= __shfl_xor_sync(0xffffffffu, kbits[r][w], 2);
        }
      if (c < 2 * NW) {
        const int r = c / NW, w = c % NW;
        const int t = row0 + 8 * r, kw = (k0 >> 5) + w;
        if (t < Tlen && kw < kwords)
          keep_out[(bh * kwords + kw) * Tlen + t] = kbits[r][w];
      }
    }
  }

  // the four lanes of a row add their shares in a fixed order
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    dsum[r] += __shfl_xor_sync(0xffffffffu, dsum[r], 1);
    dsum[r] += __shfl_xor_sync(0xffffffffu, dsum[r], 2);
    const int t = row0 + 8 * r;
    if (c == 0 && t < Tlen) delta_out[stat_row + t] = dsum[r];
  }
}

template <int D>
struct BwdFusedTc {
  static constexpr int DP = TcWidth<D>::DP;
  static constexpr int NB = TcWidth<D>::NB;
  static constexpr int BKEY = 64;  // keys per block: the rows of S^T, dP^T, dK, dV
  static constexpr int BQ = 64;    // queries per tile: the rows of dQ
  static constexpr int THREADS = 256;
  static constexpr int TILE = 64 * DP * 2;  // one 64-row bf16 tile
  // K, V; Q of stage 0, 1; dO of stage 0, 1 (in tiles); dS^T (64 x 64 bf16,
  // swizzled as a TMA tile: the A operand of dQ's product); P^T as bf16
  // pairs (64 x 64, register-major); m (then lse2), l, delta of both stages;
  // the keep words of both stages ([stage][word][query]); the copy barriers
  // (K and V, then each stage)
  static constexpr int DST = 6 * TILE;
  static constexpr int PSCRATCH = DST + 64 * 64 * 2;
  static constexpr int STATS = PSCRATCH + 64 * 64 * 2;
  static constexpr int KEEP = STATS + 2 * 3 * BQ * 4;
  static constexpr int BARS = KEEP + 2 * 2 * BQ * 4;
  static constexpr int SMEM = 1024 + BARS + 3 * 8;
  // dQ's 64-column blocks: warpgroup 1 takes the first NQB, warpgroup 0 the rest
  static constexpr int NQB = (NB + 1) / 2;
};

// The fused pass: one block per (key tile, head, example), the key tile the
// grid's fastest index.  Per query tile: S^T, P^T, dP^T, dS^T once; dV, dK
// accumulate in registers; the tile's dQ partial dS K is added into the fp32
// workspace in a fixed order of key tiles (the last adder rounds to bf16).
template <int D, bool DROP>
__global__ void __launch_bounds__(BwdFusedTc<D>::THREADS, 1)
attention_bwd_fused_tc_kernel(const __grid_constant__ CUtensorMap tm_q,
                              const __grid_constant__ CUtensorMap tm_k,
                              const __grid_constant__ CUtensorMap tm_v,
                              const __grid_constant__ CUtensorMap tm_do,
                              const float* __restrict__ bias,
                              const float* __restrict__ stats,
                              const float* __restrict__ delta,
                              const uint32_t* __restrict__ keep,
                              __nv_bfloat16* __restrict__ dq,
                              __nv_bfloat16* __restrict__ dk,
                              __nv_bfloat16* __restrict__ dv, float* dq_acc,
                              int* counters, int Tlen, int H, float scale,
                              float inv_keep, int rotate) {
  using C = BwdFusedTc<D>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = wg::align_1024(smem_raw);
  const uint32_t s0 = wg::smem_addr(smem);
  const uint32_t sK = s0, sV = s0 + C::TILE, sDS = s0 + C::DST;
  uint32_t* pscratch = reinterpret_cast<uint32_t*>(smem + C::PSCRATCH);
  float* sStats = reinterpret_cast<float*>(smem + C::STATS);
  const uint32_t* sKeep = reinterpret_cast<const uint32_t*>(smem + C::KEEP);
  const uint32_t sStatsAddr = s0 + C::STATS, sKeepAddr = s0 + C::KEEP;
  const uint32_t bar_kv = s0 + C::BARS, bar = bar_kv + 8;  // stage s: bar + 8 s

  const int tid = threadIdx.x;
  const int wgi = tid >> 7;  // 0: S^T, P^T, dV; 1: dP^T, dS^T, dK; both: dQ
  const int t128 = tid & 127;
  const int warp = (tid >> 5) & 3;
  const int g = (tid & 31) >> 2, c = tid & 3;
  // Blocks are launched in the order of their linear index, so the blocks of
  // one (b, h) start in key-tile order (the dQ turns below rely on it).
  const int kt = blockIdx.x, nkt = gridDim.x;
  const int key0 = kt * C::BKEY;
  const int h = blockIdx.y, b = blockIdx.z;
  const long long row_stride = (long long)H * D;
  const long long base = (long long)b * Tlen * row_stride + (long long)h * D;
  const long long bh = (long long)b * H + h;
  const long long stat_row = bh * Tlen;
  const long long stat_plane = (long long)gridDim.z * H * Tlen;
  const int nqt = (Tlen + C::BQ - 1) / C::BQ;
  const int kwords = (Tlen + 31) / 32;
  const int lrow = 16 * warp + g;  // this thread's key rows: lrow, lrow + 8
  // the dQ workspace of this (b, h): per query tile NB * 8 * 128 float4,
  // entry (n * 8 + e) * 128 + t holding accumulator registers 4e .. 4e + 3
  // of column block n of thread t of the warpgroup that computes it, so that
  // a warp's adds cover 512 contiguous bytes
  float4* ws_bh = reinterpret_cast<float4*>(dq_acc) + bh * nqt * C::NB * 8 * 128;
  int* counter = counters + bh * nqt;
  // The query tile of step `step` and this block's turn in adding its dQ
  // partial to it.  With `rotate` (the host sets it when the blocks of one
  // (b, h) fit on the card together, so that all of them run at once) block
  // kt takes tile (kt + step) % nqt and its turn is `step`: every block
  // starts on a tile of its own, and the turn before is block kt + 1's,
  // which took the tile one step earlier.  Without it every block takes tile
  // `step` and its turn is kt (key-tile order): a block then waits only for
  // blocks launched before it.
  auto tile_of = [&](int step) { return rotate ? (kt + step) % nqt : step; };
  auto turn_of = [&](int step) { return rotate ? step : kt; };

  // Q, dO of the tile of step `step` into stage s by TMA (thread 0), its
  // queries' m, l, delta and keep words by cp.async (warpgroup 0); both
  // complete on the stage's barrier (one arrival with the TMA bytes, one a
  // thread of warpgroup 0 when its copies land).  Stage s: Q at tile 2 + s,
  // dO at tile 4 + s; m, l, delta at 3s, 3s+1, 3s+2 (in BQ floats)
  auto load_q = [&](int step, int s) {
    const int t0 = tile_of(step) * C::BQ;
    if (tid == 0) {
      wg::mbar_expect_tx(bar + 8 * s, 2 * C::TILE);
      tma_tile<D, C::BQ>(s0 + (2 + s) * C::TILE, tm_q, bar + 8 * s, h, t0, b);
      tma_tile<D, C::BQ>(s0 + (4 + s) * C::TILE, tm_do, bar + 8 * s, h, t0, b);
    }
    if (wgi == 0) {
      constexpr int N = (DROP ? 5 : 3) * C::BQ;  // m, l, delta; keep words 0, 1
#pragma unroll
      for (int x = t128; x < N; x += 128) {
        const int which = x / C::BQ, qq = x - which * C::BQ;
        const int t = t0 + qq;
        if (which < 3) {
          const float* src = which == 0 ? stats + stat_row
                             : which == 1 ? stats + stat_plane + stat_row
                                          : delta + stat_row;
          wg::cp_async4(sStatsAddr + ((3 * s + which) * C::BQ + qq) * 4,
                        src + (t < Tlen ? t : 0), t < Tlen);
        } else {
          const int w = which - 3, kw = (key0 >> 5) + w;
          const bool ok = t < Tlen && kw < kwords;
          wg::cp_async4(sKeepAddr + ((2 * s + w) * C::BQ + qq) * 4,
                        keep + (bh * kwords + (ok ? kw : 0)) * Tlen + (ok ? t : 0), ok);
        }
      }
      wg::cp_async_mbar_arrive(bar + 8 * s);
    }
  };

  if (tid == 0) {
    wg::mbar_init(bar_kv, 1);
    wg::mbar_init(bar, 1 + 128);
    wg::mbar_init(bar + 8, 1 + 128);
    wg::mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0) {
    wg::mbar_expect_tx(bar_kv, 2 * C::TILE);
    tma_tile<D, C::BKEY>(sK, tm_k, bar_kv, h, key0, b);
    tma_tile<D, C::BKEY>(sV, tm_v, bar_kv, h, key0, b);
  }
  load_q(0, 0);

  // the bias times log2(e) (or 0, `log2e_for`), as `prob` takes it; a key
  // beyond T gets -inf, hence P = 0 in every column
  const float lg = log2e_for(stats[stat_row]);
  const float scale2 = scale * lg;
  float bk2[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int t = key0 + lrow + 8 * r;
    bk2[r] = t < Tlen ? bias[(long long)b * Tlen + t] * lg : -INFINITY;
  }
  float acc[C::NB][32];  // dV (warpgroup 0) or dK (warpgroup 1)
#pragma unroll
  for (int i = 0; i < 32; ++i)
#pragma unroll
    for (int n = 0; n < C::NB; ++n) acc[n][i] = 0.f;
  wg::mbar_wait(bar_kv, 0);

  // The dQ partial of the tile of step s is added during step s + 1:
  // warpgroup 1's thread 0 waits for the turn while its dP^T product runs,
  // barrier 5 passes the turn to warpgroup 1 and barrier 4 to warpgroup 0,
  // which adds its share after issuing dV's product.  The first turn stores,
  // later ones add with `red` (the turn is exclusive, so the order of the
  // sums is fixed), and the last adds its partial to the sum it loads and
  // rounds to bf16 into dq.  Thread 0 hands the turn on after barrier 3, by
  // which every thread's adds are done, while dQ's product runs.
  auto wait_for = [&](int step) {
    if (turn_of(step) > 0) wait_turn(counter + tile_of(step), turn_of(step));
  };
  auto add_partial = [&](int step, int w, float (&part)[C::NQB][32]) {
    const int turn = turn_of(step), i = tile_of(step);
    float4* tile = ws_bh + (long long)i * C::NB * 8 * 128 + t128;
#pragma unroll
    for (int m = 0; m < C::NQB; ++m) {
      const int n = w == 1 ? m : C::NQB + m;
      if (n >= C::NB) continue;
      float4* dst = tile + n * 8 * 128;
      if (turn + 1 < nkt) {
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const float4 v = make_float4(part[m][4 * e], part[m][4 * e + 1],
                                       part[m][4 * e + 2], part[m][4 * e + 3]);
          if (turn == 0)
            __stcg(dst + e * 128, v);
          else
            atomicAdd(dst + e * 128, v);
        }
        continue;
      }
      float4 sum[8];
#pragma unroll
      for (int e = 0; e < 8; ++e)
        sum[e] = turn > 0 ? __ldcg(dst + e * 128) : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int t = i * C::BQ + lrow + 8 * r;
        if (t >= Tlen) continue;
        __nv_bfloat16* qrow = dq + base + (long long)t * row_stride;
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int col = 64 * n + 8 * e + 2 * c;
          if (col < D)
            *reinterpret_cast<uint32_t*>(qrow + col) =
                wg::pack_bf16((r ? sum[e].z : sum[e].x) + part[m][4 * e + 2 * r],
                              (r ? sum[e].w : sum[e].y) + part[m][4 * e + 2 * r + 1]);
        }
      }
    }
  };
  // after a barrier that every thread passed after its adds
  auto hand_on = [&](int step) {
    if (tid == 0 && turn_of(step) + 1 < nkt) red_release_gpu_add(counter + tile_of(step), 1);
  };

  // The steps overlap: a step issues its first product (S^T or dP^T) while
  // the previous step's dV, dK and dQ products may still run, waits for
  // those (wait<1>) and adds the previous dQ partial under the new product.
  // Stage (step + 1) % 2 is refilled once both warpgroups are past their
  // wait<1> (barrier 2).
  float dqa[C::NQB][32];  // this warpgroup's column blocks of a tile's dQ partial
  // A fragments: P_d^T (warpgroup 0) or dS^T (1), read by the products a
  // step leaves running, so held until the next step's wait<1>
  uint32_t fa[4][4];
#pragma unroll
  for (int m = 0; m < C::NQB; ++m)
#pragma unroll
    for (int i = 0; i < 32; ++i) dqa[m][i] = 0.f;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) fa[kk][0] = fa[kk][1] = fa[kk][2] = fa[kk][3] = 0u;
  for (int step = 0; step < nqt; ++step) {
    const int s = step & 1;
    const int q0 = tile_of(step) * C::BQ;
    wg::mbar_wait(bar + 8 * s, (step >> 1) & 1);
    const uint32_t sQs = s0 + (2 + s) * C::TILE, sDOs = s0 + (4 + s) * C::TILE;
    float* st = sStats + 3 * s * C::BQ;  // m, l, delta of the tile's queries
    // only the last tile has query slots beyond T (their statistics are 0)
    const bool full = q0 + C::BQ <= Tlen;
    float sc[32];  // S^T (warpgroup 0) or dP_d^T (warpgroup 1)
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = 0.f;

    // S^T = K Q^T (warpgroup 0), dP_d^T = V dO^T (warpgroup 1)
    wg::fence();
#pragma unroll
    for (int kk = 0; kk < C::DP / 16; ++kk)
      wg::mma_ss(sc, wg::desc_k(wgi == 0 ? sK : sV, C::BKEY, kk),
                 wg::desc_k(wgi == 0 ? sQs : sDOs, C::BQ, kk), kk > 0);
    wg::commit();
    wg::fence_regs(sc);
    wg::wait<1>();  // the previous step's products
#pragma unroll
    for (int m = 0; m < C::NQB; ++m) wg::fence_regs(dqa[m]);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wg::fence_regs(fa[kk]);

    if (wgi == 0) {
      wg::wait<0>();
      wg::fence_regs(sc);
      wg::barrier_sync(2, 256);  // m has become lse2; warpgroup 1 is past its wait<1>
      if (step + 1 < nqt) load_q(step + 1, s ^ 1);
      // P^T and P_d^T; P^T goes to warpgroup 1 as bf16 pairs, a dropped entry
      // with its sign bit set (P >= 0, so the sign carries the mask)
      const uint32_t* kp = sKeep + (2 * s + (warp >> 1)) * C::BQ;  // this warp's key word
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float pv[2], pd[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = 8 * i + 2 * c + e;  // query q0 + col
            float p = prob(sc[4 * i + 2 * r + e], scale2, bk2[r], st[col]);
            if (!full && q0 + col >= Tlen) p = 0.f;
            pv[e] = p;
            pd[e] = p;
            if constexpr (DROP) {
              const bool kept = (kp[col] >> ((lrow + 8 * r) & 31)) & 1u;
              p = round_bf16_alu(p);
              pd[e] = kept ? p * inv_keep : 0.f;  // rounded by the packing
              pv[e] = kept ? p : -p;
            }
          }
          const uint32_t packed = wg::pack_bf16(pv[0], pv[1]);
          fa[i >> 1][2 * (i & 1) + r] = DROP ? wg::pack_bf16(pd[0], pd[1]) : packed;
          pscratch[(2 * i + r) * 128 + t128] = packed;
        }
      wg::barrier_arrive(1, 256);  // P^T is in the scratch

      // dV += P_d^T dO
      wg::fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wg::mma_rs_wide<64 * C::NB>(&acc[0][0], fa[kk], wg::desc_mn_wide(sDOs, C::BQ, kk, 0));
      wg::commit();
      if (step > 0) {
        wg::barrier_sync(4, 256);  // warpgroup 1's thread 0 has seen the turn
        add_partial(step - 1, 0, dqa);
      }
    } else {
      if (t128 < C::BQ)  // m becomes lse2 (a query beyond T: -inf, its P is set to 0)
        st[t128] = row_lse2(st[t128], st[C::BQ + t128], lg);
      wg::barrier_arrive(2, 256);
      if (step > 0) {
        if (t128 == 0) wait_for(step - 1);
        wg::barrier_sync(5, 128);
        wg::barrier_arrive(4, 256);
        add_partial(step - 1, 1, dqa);
      }
      wg::wait<0>();
      wg::fence_regs(sc);
      wg::barrier_sync(1, 256);
      // dS^T = P^T (dP^T - delta) * scale, dP^T taken back through dropout;
      // the packed pairs also go to a swizzled tile (row = key, 16-byte chunk
      // i of the row at i ^ (row % 8)) for dQ's product
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const uint32_t pp = pscratch[(2 * i + r) * 128 + t128];
          float ds[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = 8 * i + 2 * c + e;
            float p = e ? bf16_hi(pp) : bf16_lo(pp);
            float dpv = sc[4 * i + 2 * r + e];
            if constexpr (DROP) {
              dpv = signbit(p) ? 0.f : dpv * inv_keep;
              p = fabsf(p);
            }
            ds[e] = (p * (dpv - st[2 * C::BQ + col])) * scale;  // rounded by the packing
          }
          const uint32_t packed = wg::pack_bf16(ds[0], ds[1]);
          fa[i >> 1][2 * (i & 1) + r] = packed;
          asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(sDS + (lrow + 8 * r) * 128 +
                                                          ((i ^ g) << 4) + 4 * c),
                       "r"(packed)
                       : "memory");
        }
      wg::fence_proxy_async();

      // dK += dS^T Q
      wg::fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wg::mma_rs_wide<64 * C::NB>(&acc[0][0], fa[kk], wg::desc_mn_wide(sQs, C::BQ, kk, 0));
      wg::commit();
    }
    wg::barrier_sync(3, 256);  // dS^T is in shared memory for the tensor cores

    // the tile's dQ partial dS K: column blocks 2m + 1 - wgi
    wg::fence();
    if (wgi == 1) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wg::mma_ss_mn_wide<64 * C::NQB>(&dqa[0][0], wg::desc_mn(sDS, 64, kk, 0),
                                        wg::desc_mn_wide(sK, C::BKEY, kk, 0), kk > 0);
    } else if constexpr (C::NB > C::NQB) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wg::mma_ss_mn_wide<64 * (C::NB - C::NQB)>(&dqa[0][0], wg::desc_mn(sDS, 64, kk, 0),
                                                  wg::desc_mn_wide(sK, C::BKEY, kk, C::NQB),
                                                  kk > 0);
    }
    wg::commit();
#pragma unroll
    for (int m = 0; m < C::NQB; ++m) wg::fence_regs(dqa[m]);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wg::fence_regs(fa[kk]);
    // every thread's adds of the previous tile came before barrier 3
    if (step > 0) hand_on(step - 1);
  }
  wg::wait<0>();
#pragma unroll
  for (int n = 0; n < C::NB; ++n) wg::fence_regs(acc[n]);
#pragma unroll
  for (int m = 0; m < C::NQB; ++m) wg::fence_regs(dqa[m]);
  if (tid == 0) wait_for(nqt - 1);
  __syncthreads();
  add_partial(nqt - 1, wgi, dqa);
  __syncthreads();
  hand_on(nqt - 1);

  __nv_bfloat16* dst = wgi == 0 ? dv : dk;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int t = key0 + lrow + 8 * r;
    if (t < Tlen) {
      __nv_bfloat16* row = dst + base + (long long)t * row_stride;
#pragma unroll
      for (int n = 0; n < C::NB; ++n)
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int col = 64 * n + 8 * i + 2 * c;
          if (col < D)
            *reinterpret_cast<uint32_t*>(row + col) =
                wg::pack_bf16(acc[n][4 * i + 2 * r], acc[n][4 * i + 2 * r + 1]);
        }
    }
  }
}

// The current device's number of SMs (0 where it cannot be read).
inline int sm_count() {
  static std::atomic<int> counts[64];
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  n = counts[dev].load();
  if (n == 0 && cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) == cudaSuccess)
    counts[dev].store(n);
  return n;
}

// static: each library keeps its own record of the attribute it set
template <int D, bool DROP>
static int launch_attention_bwd_tc(const BwdArgs& a) {
  using CD = BwdDeltaTc<D>;
  using CF = BwdFusedTc<D>;
  static_assert(CD::SMEM <= kMaxSmemBytes && CF::SMEM <= kMaxSmemBytes,
                "backward tiles do not fit");
  auto delta_kern = attention_bwd_delta_tc_kernel<D, DROP>;
  auto fused_kern = attention_bwd_fused_tc_kernel<D, DROP>;
  static std::atomic<unsigned long long> delta_smem_set{0}, fused_smem_set{0};
  cudaError_t err = set_max_dynamic_smem(delta_kern, CD::SMEM, delta_smem_set);
  if (err != cudaSuccess) return (int)err;
  err = set_max_dynamic_smem(fused_kern, CF::SMEM, fused_smem_set);
  if (err != cudaSuccess) return (int)err;
  // tensor maps: 128-row tiles of Q and dO and key tiles for the delta pass,
  // 64-row tiles of all four for the fused pass
  CUtensorMap q128, do128, kd, vd, q64, k64, v64, do64;
  const int B = a.B, T = a.T, H = a.H;
  if (int e = tile_map(&q128, a.q, B, T, H, D, CD::BQ)) return e;
  if (int e = tile_map(&do128, a.dout, B, T, H, D, CD::BQ)) return e;
  if (int e = tile_map(&kd, a.k, B, T, H, D, CD::BK)) return e;
  if (int e = tile_map(&vd, a.v, B, T, H, D, CD::BK)) return e;
  if (int e = tile_map(&q64, a.q, B, T, H, D, 64)) return e;
  if (int e = tile_map(&do64, a.dout, B, T, H, D, 64)) return e;
  if (int e = tile_map(&k64, a.k, B, T, H, D, 64)) return e;
  if (int e = tile_map(&v64, a.v, B, T, H, D, 64)) return e;
  const float scale = 1.0f / sqrtf((float)D);
  using bf = __nv_bfloat16;
  dim3 grid_d((T + CD::BQ - 1) / CD::BQ, H, B);
  delta_kern<<<grid_d, CD::THREADS, CD::SMEM, a.stream>>>(
      q128, kd, vd, do128, a.bias, a.seeds, a.stats, a.delta, a.keep, a.counters,
      T, H, scale, a.thresh, a.inv_keep);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // reads delta, the keep words and the zeroed counters the delta pass
  // wrote: same stream, so ordered after it.  The key tile is the fastest
  // grid index (the dQ adds rely on it).
  dim3 grid_f((T + CF::BKEY - 1) / CF::BKEY, H, B);
  fused_kern<<<grid_f, CF::THREADS, CF::SMEM, a.stream>>>(
      q64, k64, v64, do64, a.bias, a.stats, a.delta, a.keep, static_cast<bf*>(a.dq),
      static_cast<bf*>(a.dk), static_cast<bf*>(a.dv), a.dq_acc, a.counters, T, H,
      scale, a.inv_keep, grid_f.x <= (unsigned)sm_count() ? 1 : 0);
  return (int)cudaGetLastError();
}

template <bool DROP>
int dispatch_attention_bwd_tc(const BwdArgs& a, int D) {
  switch (D) {
    case 32: return launch_attention_bwd_tc<32, DROP>(a);
    case 64: return launch_attention_bwd_tc<64, DROP>(a);
    case 96: return launch_attention_bwd_tc<96, DROP>(a);
    case 128: return launch_attention_bwd_tc<128, DROP>(a);
    case 192: return launch_attention_bwd_tc<192, DROP>(a);
    case 256: return launch_attention_bwd_tc<256, DROP>(a);
    default: return kErrUnsupportedShape;
  }
}

// ---------------------------------------------------------------------------
// fp32 on the tensor cores (mma.sync, 3xTF32)
// ---------------------------------------------------------------------------

// An mbarrier's expected byte count raised without an arrival (the stage's
// arrivals come after the copies and stores that fill it).
__device__ __forceinline__ void mbar_expect_tx_only(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.expect_tx.relaxed.cta.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

// Wait until a counter has reached `at_least` (acquire), trapping as
// `wait_turn` does.
__device__ __forceinline__ void wait_count(const int* counter, int at_least) {
  for (uint32_t n = 0; ld_acquire_gpu(counter) < at_least; ++n) {
    if (n == (1u << 22)) __trap();
    __nanosleep(64);
  }
}

// The 3xTF32 split without the conversion unit: hi = v rounded to TF32 to
// nearest, ties away from zero, in integer arithmetic (the bits of
// cvt.rna.tf32.f32), and lo = v - hi (exact) as fp32 bits, which the tensor
// cores read truncated to TF32 (an error below 2^-21 of v, against the
// 2^-22 of rounding it).  cvt runs at a quarter of the ALU's rate, and the
// fp32 backward splits about one operand value a product: with two cvt a
// value the splits, not the products, set its time (PERF.md, PR 16).
__device__ __forceinline__ void split_tf32_alu(float v, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(v) + 0x1000u) & 0xFFFFE000u;
  lo = __float_as_uint(v - __uint_as_float(hi));
}

// mma_abt (attention_common.cuh) with split_tf32_alu: acc (16 x 8N a warp)
// += A B^T over depth D in 3xTF32, A a 16-row tile read at `a` (row g,
// column t of the warp's rows), B N n8 tiles of rows read at `b`.
template <int D, int N>
__device__ __forceinline__ void mma_abt_alu(float (&acc)[N][4], const float* a,
                                            const float* b) {
  constexpr int LD = F32Tile<D>::LD;
#pragma unroll
  for (int kk = 0; kk < D; kk += 8) {
    uint32_t ah[4], al[4], bh[N][2], bl[N][2];
    split_tf32_alu(a[kk], ah[0], al[0]);
    split_tf32_alu(a[8 * LD + kk], ah[1], al[1]);
    split_tf32_alu(a[kk + 4], ah[2], al[2]);
    split_tf32_alu(a[8 * LD + kk + 4], ah[3], al[3]);
#pragma unroll
    for (int n = 0; n < N; ++n) {
      split_tf32_alu(b[8 * n * LD + kk], bh[n][0], bl[n][0]);
      split_tf32_alu(b[8 * n * LD + kk + 4], bh[n][1], bl[n][1]);
    }
    mma_3xtf32<N>(acc, 0, ah, al, bh, bl);
  }
}

// Rows t0 .. t0 + ROWS - 1 of one (batch, head) of a contiguous fp32 (B, T,
// H, D) tensor into a tile of stride D + 4, by one warp: a bulk copy of D
// floats a row on barrier `bar` (the caller has raised its byte count by
// 4 * D a row below T), zeros stored for rows at or beyond T.
template <int D, int ROWS>
__device__ __forceinline__ void bulk_rows_f32(float* dst, const float* src,
                                              long long row_stride, int t0, int Tlen,
                                              uint32_t bar, int lane) {
  constexpr int LD = F32Tile<D>::LD;
  for (int r = lane; r < ROWS; r += 32) {
    const int t = t0 + r;
    if (t < Tlen) {
      wg::bulk_load(wg::smem_addr(dst + r * LD), src + (long long)t * row_stride, D * 4, bar);
    } else {
      float4* z = reinterpret_cast<float4*>(dst + r * LD);
#pragma unroll 4
      for (int c = 0; c < D / 4; ++c) z[c] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
}

template <int D>
struct BwdDeltaF32 {
  static constexpr int BQ = 64;                 // queries per block, 16 a warp
  static constexpr int THREADS = 256;           // two groups of four warps
  static constexpr int BK = D > 192 ? 16 : 32;  // keys per tile, half to a group
  static constexpr int KH = BK / 2;
  static constexpr int LD = F32Tile<D>::LD;
  static constexpr int Q_FLOATS = BQ * LD;      // Q or dO
  static constexpr int KV_FLOATS = BK * LD;     // one K or V tile
  // Q, dO; stage s: K at 2s, V at 2s + 1 (in KV tiles); the bias of stage s;
  // each group's share of delta
  static constexpr int KV = 2 * Q_FLOATS;
  static constexpr int BIAS = KV + 4 * KV_FLOATS;
  static constexpr int PART = BIAS + 2 * BK;
  static constexpr int SMEM = (PART + 2 * BQ) * 4;
};

template <int D>
struct BwdFusedF32 {
  static constexpr int BKEY = 64;               // keys per block, 16 a warp of a group
  static constexpr int THREADS = 512;           // four groups of four warps
  static constexpr int BQ = D > 192 ? 16 : 32;  // queries per tile (step)
  static constexpr int R = BKEY / BQ;           // query tiles per key tile
  static constexpr int LD = F32Tile<D>::LD;
  static constexpr int NQ = BQ / 8;             // n8 query tiles of a step
  static constexpr int NH = NQ / 2;             // ... of a group's half of S^T or dP^T
  static constexpr int NTH = D / 16;            // n8 column tiles of a group's half of dV or dK
  static constexpr int LDS = BQ + 4;            // row stride of the dS^T tile
  static constexpr int KV_FLOATS = BKEY * LD;   // K or V
  static constexpr int Q_FLOATS = BQ * LD;      // one Q or dO tile
  static constexpr int PSCR = 128 * NQ * 4;     // one P^T scratch (floats)
  // the dQ partial of a tile: warp w < DQW takes query rows 16 (w % MT) ..
  // and NC n8 column tiles from column 8 NC (w / MT)
  static constexpr int MT = BQ / 16;
  static constexpr int NCP = (D / 8) % (16 / MT) == 0 ? 16 / MT : (D / 8) % 6 == 0 ? 6 : 4;
  static constexpr int NC = D / 8 / NCP;
  static constexpr int DQW = MT * NCP;          // warps that take part in dQ
  // K, V; stage s: Q at 2s, dO at 2s + 1 (in Q tiles); the P^T scratch of
  // even and of odd steps (fp32, register-major); dS^T (keys x queries,
  // stride LDS); m, l, delta of stage s; the keep words of stage s
  // ([stage][word][query]); the barriers (K and V, then each stage)
  static constexpr int SCRATCH = 2 * KV_FLOATS + 4 * Q_FLOATS;
  static constexpr int DST = SCRATCH + 2 * PSCR;
  static constexpr int STATS = DST + BKEY * LDS;
  static constexpr int KEEP = STATS + 2 * 3 * BQ;
  static constexpr int BARS = KEEP + 2 * 2 * BQ;
  static constexpr int SMEM = BARS * 4 + 3 * 8;
  static_assert(D % 32 == 0 && (D / 8) % NCP == 0 && DQW <= 16, "dQ partial split");
};

// acc (16 x 8 NT a warp) += P B over K8 k-steps of 8 rows of B in 3xTF32:
// mma_pb (attention_common.cuh) for NT n8 column tiles from the column of b0
// and b1, the first K8 / 2 k-steps' rows read from b0, the others' from b1.
template <int NT, int K8, int LD>
__device__ __forceinline__ void mma_pb_cols(float (&acc)[NT][4], const uint32_t (&ph)[K8][4],
                                            const uint32_t (&pl)[K8][4], const float* b0,
                                            const float* b1) {
  constexpr int G = NT % 4 == 0 ? 4 : NT % 3 == 0 ? 3 : 2;  // n8 tiles a group of products
#pragma unroll
  for (int j = 0; j < K8; ++j) {
    const float* b = j < K8 / 2 ? b0 + 8 * j * LD : b1 + 8 * (j - K8 / 2) * LD;
#pragma unroll
    for (int c0 = 0; c0 < NT; c0 += G) {
      uint32_t bh[G][2], bl[G][2];
#pragma unroll
      for (int c = 0; c < G; ++c) {
        split_tf32_alu(b[8 * (c0 + c)], bh[c][0], bl[c][0]);
        split_tf32_alu(b[LD + 8 * (c0 + c)], bh[c][1], bl[c][1]);
      }
      mma_3xtf32<G>(acc, c0, ph[j], pl[j], bh, bl);
    }
  }
}

// The delta pass: one block per 64 queries, a sweep over the key tiles.
// Writes delta = rowsum(dP * P) and, with dropout, the keep bits of every
// (query, key) as words of 32 keys; sets the fused pass's dQ counters of its
// query tiles to 0.
template <int D, bool DROP>
__global__ void __launch_bounds__(BwdDeltaF32<D>::THREADS, 1)
attention_bwd_delta_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                               const float* __restrict__ v, const float* __restrict__ bias,
                               const int* __restrict__ seeds,
                               const float* __restrict__ stats,
                               const float* __restrict__ dout,
                               float* __restrict__ delta_out,
                               uint32_t* __restrict__ keep_out, int* __restrict__ counters,
                               int Tlen, int H, float scale, uint32_t thresh,
                               float inv_keep) {
  using C = BwdDeltaF32<D>;
  constexpr int LD = C::LD, BK = C::BK, KH = C::KH, NK = KH / 8;
  constexpr int FQ = BwdFusedF32<D>::BQ;  // the fused pass's query tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sQ = reinterpret_cast<float*>(smem_raw);
  float* sDO = sQ + C::Q_FLOATS;
  float* sKV = sQ + C::KV;
  const float* sBias = sQ + C::BIAS;
  float* sPart = sQ + C::PART;

  const int tid = threadIdx.x;
  const int grp = tid >> 7;  // keys grp * KH .. of every tile
  const int warp = (tid >> 5) & 3;
  const int g = (tid & 31) >> 2, t = tid & 3;
  const int q0 = blockIdx.x * C::BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const long long row_stride = (long long)H * D;
  const long long base = (long long)b * Tlen * row_stride + (long long)h * D;
  const long long bh = (long long)b * H + h;
  const long long stat_row = bh * Tlen;
  const long long stat_plane = (long long)gridDim.z * H * Tlen;
  const float* bias_b = bias + (long long)b * Tlen;
  const int nkt = (Tlen + BK - 1) / BK;
  const int kwords = (Tlen + 31) / 32;
  const int lrow = 16 * warp + g;  // this thread's rows q0 + lrow, + 8
  const int row0 = q0 + lrow;
  const int kofs = grp * KH;
  const uint32_t key = DROP ? dropout_key(seeds[b], h) : 0u;

  if (tid < C::BQ / FQ) {
    const int nqt = (Tlen + FQ - 1) / FQ, qt = blockIdx.x * (C::BQ / FQ) + tid;
    if (qt < nqt) counters[bh * nqt + qt] = 0;
  }

  auto load_kv = [&](int j, int s) {
    float* sK = sKV + 2 * s * C::KV_FLOATS;
    copy_rows_f32<D, BK, C::THREADS>(sK, k + base, row_stride, j * BK, Tlen, tid);
    copy_rows_f32<D, BK, C::THREADS>(sK + C::KV_FLOATS, v + base, row_stride,
                                     j * BK, Tlen, tid);
    copy_floats(wg::smem_addr(sBias + s * BK), bias_b, j * BK, BK, Tlen, tid);
    cp_async_commit_group();
  };
  copy_rows_f32<D, C::BQ, C::THREADS>(sQ, q + base, row_stride, q0, Tlen, tid);
  copy_rows_f32<D, C::BQ, C::THREADS>(sDO, dout + base, row_stride, q0, Tlen, tid);
  load_kv(0, 0);  // one group with Q and dO

  const float lg = log2e_for(stats[stat_row]);
  const float scale2 = scale * lg;
  float lse2[2], dsum[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    // a row beyond T gets lse2 = inf, hence P = 0
    lse2[r] = row < Tlen ? row_lse2(stats[stat_row + row],
                                    stats[stat_plane + stat_row + row], lg)
                         : INFINITY;
  }
  const float* qa = sQ + lrow * LD + t;
  const float* ga = sDO + lrow * LD + t;

  for (int it = 0; it < nkt; ++it) {
    const int s = it & 1;
    const int k0 = it * BK;
    cp_async_wait_group<0>();
    __syncthreads();
    if (it + 1 < nkt) load_kv(it + 1, s ^ 1);
    const float* sK = sKV + 2 * s * C::KV_FLOATS + kofs * LD;  // the group's keys
    const float* sV = sK + C::KV_FLOATS;

    // S = Q K^T, dP_d = dO V^T: 16 x KH a warp each
    float sc[NK][4], dp[NK][4];
#pragma unroll
    for (int n = 0; n < NK; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) sc[n][i] = dp[n][i] = 0.f;
    mma_abt_alu<D, NK>(sc, qa, sK + g * LD + t);
    mma_abt_alu<D, NK>(dp, ga, sV + g * LD + t);

    // only the last tile has key slots beyond T
    const bool full = k0 + BK <= Tlen;
    uint32_t kbits[2] = {0u, 0u};  // keep bits of rows row0, row0 + 8: bit key - k0 - kofs
#pragma unroll
    for (int n = 0; n < NK; ++n) {
      // keys k0 + kofs + 8n + 2t + e are words 2(t & 1) + e of group
      // (k0 + kofs) / 4 + 2n + t / 2: lanes t and t ^ 1 share the group, so
      // the even lane draws it for row0 and the odd one for row0 + 8, and
      // each hands the other the two words it keeps of its row.  One draw a
      // word.
      uint32_t word[2][2] = {{0u, 0u}, {0u, 0u}};  // [row][e]
      if constexpr (DROP) {
        const int odd = t & 1;
        const uint4 w = dropout_bits(key, (uint32_t)(row0 + 8 * odd),
                                     (uint32_t)(((k0 + kofs) >> 2) + 2 * n + (t >> 1)));
        const uint32_t got0 = __shfl_xor_sync(0xffffffffu, odd ? w.x : w.z, 1);
        const uint32_t got1 = __shfl_xor_sync(0xffffffffu, odd ? w.y : w.w, 1);
        word[0][0] = odd ? got0 : w.x;
        word[0][1] = odd ? got1 : w.y;
        word[1][0] = odd ? w.z : got0;
        word[1][1] = odd ? w.w : got1;
      }
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = kofs + 8 * n + 2 * t + e;  // key k0 + col
          const int idx = 2 * r + e;
          float p = prob(sc[n][idx], scale2, sBias[s * BK + col] * lg, lse2[r]);
          if (!full && k0 + col >= Tlen) p = 0.f;
          float dpv = dp[n][idx];
          if constexpr (DROP) {
            const bool keep = word[r][e] >= thresh;
            dpv = keep ? dpv * inv_keep : 0.f;
            kbits[r] |= (uint32_t)keep << (8 * n + 2 * t + e);
          }
          dsum[r] = fmaf(dpv, p, dsum[r]);
        }
    }
    if constexpr (DROP) {
      // the four lanes of a row hold disjoint bits; lane r stores row r's
      // KH bits, bits (k0 + kofs) % 32 .. of word (k0 + kofs) / 32, as a
      // store of their own bytes (the other group stores the rest)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        kbits[r] |= __shfl_xor_sync(0xffffffffu, kbits[r], 1);
        kbits[r] |= __shfl_xor_sync(0xffffffffu, kbits[r], 2);
      }
      const int row = row0 + 8 * t;
      if (t < 2 && row < Tlen) {
        const int kk = k0 + kofs;
        unsigned char* w = reinterpret_cast<unsigned char*>(
                               keep_out + (bh * kwords + (kk >> 5)) * Tlen + row) +
                           ((kk & 31) >> 3);
        const uint32_t bits = t == 0 ? kbits[0] : kbits[1];
        if constexpr (KH == 16)
          *reinterpret_cast<uint16_t*>(w) = (uint16_t)bits;
        else
          *w = (unsigned char)bits;
      }
    }
  }

  // the four lanes of a row add their shares in a fixed order, then the two
  // groups' shares are added in a fixed order
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    dsum[r] += __shfl_xor_sync(0xffffffffu, dsum[r], 1);
    dsum[r] += __shfl_xor_sync(0xffffffffu, dsum[r], 2);
    if (t == 0) sPart[grp * C::BQ + lrow + 8 * r] = dsum[r];
  }
  __syncthreads();
  if (grp == 0 && t == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      if (row < Tlen)
        delta_out[stat_row + row] = sPart[lrow + 8 * r] + sPart[C::BQ + lrow + 8 * r];
    }
  }
}

// The fused pass: one block per (key tile, head, example), the key tile the
// grid's fastest index.  Per query tile: S^T, P^T, dP^T, dS^T once; dV, dK
// accumulate in registers; the tile's dQ partial dS K is added into dq in a
// fixed order of key tiles.
template <int D, bool DROP>
__global__ void __launch_bounds__(BwdFusedF32<D>::THREADS, 1)
attention_bwd_fused_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                               const float* __restrict__ v, const float* __restrict__ bias,
                               const float* __restrict__ stats,
                               const float* __restrict__ dout,
                               const float* __restrict__ delta,
                               const uint32_t* __restrict__ keep, float* dq,
                               float* __restrict__ dk, float* __restrict__ dv,
                               int* counters, int Tlen, int H, float scale,
                               float inv_keep, int rotate) {
  using C = BwdFusedF32<D>;
  constexpr int LD = C::LD, BQ = C::BQ, NQ = C::NQ, NH = C::NH, NTH = C::NTH;
  constexpr int LDS = C::LDS, NC = C::NC;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sK = reinterpret_cast<float*>(smem_raw);
  float* sV = sK + C::KV_FLOATS;
  float* sQD = sV + C::KV_FLOATS;
  float* sDS = sK + C::DST;
  float* sStats = sK + C::STATS;
  const uint32_t* sKeep = reinterpret_cast<const uint32_t*>(sK + C::KEEP);
  const uint32_t sStatsAddr = wg::smem_addr(sStats);
  const uint32_t sKeepAddr = wg::smem_addr(sK + C::KEEP);
  const uint32_t bar_kv = wg::smem_addr(sK + C::BARS), bar = bar_kv + 8;  // stage s: bar + 8 s

  const int tid = threadIdx.x;
  // Group (role, half): role 0 forms S^T and P^T and accumulates dV, role 1
  // forms dP^T and dS^T and accumulates dK; a group takes half of each
  // step's queries for S^T or dP^T and half of the columns of dV or dK.
  const int grp = tid >> 7, role = grp & 1, half = grp >> 1;
  const int t128 = tid & 127, wid = tid >> 5, warp = wid & 3;
  const int lane = tid & 31, g = lane >> 2, t = tid & 3;
  // Blocks are launched in the order of their linear index, so the blocks of
  // one (b, h) start in key-tile order (the dQ turns below rely on it).
  const int kt = blockIdx.x, nkt = gridDim.x;
  const int key0 = kt * C::BKEY;
  const int h = blockIdx.y, b = blockIdx.z;
  const long long row_stride = (long long)H * D;
  const long long base = (long long)b * Tlen * row_stride + (long long)h * D;
  const long long bh = (long long)b * H + h;
  const long long stat_row = bh * Tlen;
  const long long stat_plane = (long long)gridDim.z * H * Tlen;
  const int nqt = (Tlen + BQ - 1) / BQ;
  const int kwords = (Tlen + 31) / 32;
  const int lrow = 16 * warp + g;  // this thread's key rows lrow, lrow + 8
  int* counter = counters + bh * nqt;
  // The query tile of step `step` and this block's turn in adding its dQ
  // partial to it.  With `rotate` (the host sets it when the blocks of one
  // (b, h) fit on the card together) block kt starts on query tile R kt, the
  // first of its own keys' rows, and walks on from there: tile i = R a + c is
  // visited first by block a, and then by blocks a - 1, a - 2, ... (mod nkt),
  // each R steps after the one before it, so the turn of block kt is
  // (a - kt) mod nkt and it waits only for a block one turn ahead.  Without
  // it every block takes tile `step` and its turn is kt (key-tile order): a
  // block then waits only for blocks launched before it.
  auto tile_of = [&](int step) { return rotate ? (C::R * kt + step) % nqt : step; };
  auto turn_of = [&](int step) {
    return rotate ? (tile_of(step) / C::R - kt + nkt) % nkt : kt;
  };

  // Q, dO of the tile of step `step` into stage s by bulk copies, their
  // queries' m, l, delta and keep words by cp.async, by warp 0: the stage's
  // barrier counts the copies' bytes and two arrivals a lane, one after its
  // stores (the zero rows), one when its cp.async copies land.
  auto load_stage = [&](int step, int s) {
    const int t0 = tile_of(step) * BQ;
    const int rows = min(BQ, Tlen - t0);
    const uint32_t full_bar = bar + 8 * s;
    if (lane == 0) mbar_expect_tx_only(full_bar, 2 * rows * D * 4);
    __syncwarp();
    wg::fence_proxy_async();  // the zero rows stored earlier, before the copies
    float* sQs = sQD + 2 * s * C::Q_FLOATS;
    bulk_rows_f32<D, BQ>(sQs, q + base, row_stride, t0, Tlen, full_bar, lane);
    bulk_rows_f32<D, BQ>(sQs + C::Q_FLOATS, dout + base, row_stride, t0, Tlen, full_bar, lane);
    constexpr int N = (DROP ? 5 : 3) * BQ;  // m, l, delta; keep words 0, 1
#pragma unroll
    for (int x = lane; x < N; x += 32) {
      const int which = x / BQ, qq = x - which * BQ;
      const int tq = t0 + qq;
      if (which < 3) {
        const float* src = which == 0 ? stats + stat_row
                           : which == 1 ? stats + stat_plane + stat_row
                                        : delta + stat_row;
        wg::cp_async4(sStatsAddr + ((3 * s + which) * BQ + qq) * 4,
                      src + (tq < Tlen ? tq : 0), tq < Tlen);
      } else {
        const int w = which - 3, kw = (key0 >> 5) + w;
        const bool ok = tq < Tlen && kw < kwords;
        wg::cp_async4(sKeepAddr + ((2 * s + w) * BQ + qq) * 4,
                      keep + (bh * kwords + (ok ? kw : 0)) * Tlen + (ok ? tq : 0), ok);
      }
    }
    wg::cp_async_mbar_arrive(full_bar);
    wg::mbar_arrive(full_bar);
  };

  if (tid == 0) {
    wg::mbar_init(bar_kv, 32);
    wg::mbar_init(bar, 64);
    wg::mbar_init(bar + 8, 64);
    wg::mbar_init_fence();
  }
  __syncthreads();
  if (wid == 1) {  // K and V of the block's keys
    if (lane == 0) mbar_expect_tx_only(bar_kv, 2 * min(C::BKEY, Tlen - key0) * D * 4);
    __syncwarp();
    bulk_rows_f32<D, C::BKEY>(sK, k + base, row_stride, key0, Tlen, bar_kv, lane);
    bulk_rows_f32<D, C::BKEY>(sV, v + base, row_stride, key0, Tlen, bar_kv, lane);
    wg::mbar_arrive(bar_kv);
  } else if (wid == 0) {
    load_stage(0, 0);
  }

  // the bias times log2(e) (or 0, `log2e_for`), as `prob` takes it; a key
  // beyond T gets -inf, hence P = 0 in every column
  const float lg = log2e_for(stats[stat_row]);
  const float scale2 = scale * lg;
  float bk[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int kr = key0 + lrow + 8 * r;
    bk[r] = kr < Tlen ? bias[(long long)b * Tlen + kr] * lg : -INFINITY;
  }
  float acc[NTH][4];  // the group's half of the columns of dV (role 0) or dK (role 1)
#pragma unroll
  for (int c = 0; c < NTH; ++c) acc[c][0] = acc[c][1] = acc[c][2] = acc[c][3] = 0.f;
  // A rows: the warp's 16 keys of K (role 0) or V (role 1)
  const float* ka = (role == 0 ? sK : sV) + lrow * LD + t;
  // the dQ partial's A (dS, read from the dS^T tile) and B (K) of this warp
  const int mt = wid % C::MT, col0 = 8 * NC * (wid / C::MT);
  const float* dsa = sDS + 2 * t * LDS + 16 * mt + g;
  const float* kb = sK + 2 * t * LD + col0 + g;
  wg::mbar_wait(bar_kv, 0);

  for (int step = 0; step < nqt; ++step) {
    const int s = step & 1;
    const int i = tile_of(step), q0 = i * BQ;
    wg::mbar_wait(bar + 8 * s, (step >> 1) & 1);
    const float* sQs = sQD + 2 * s * C::Q_FLOATS;
    const float* sDOs = sQs + C::Q_FLOATS;
    const float* st = sStats + 3 * s * BQ;  // m, l, delta of the tile's queries
    // P^T of this step: two scratches, so that a group writing the next
    // step's never meets a group still reading this one's
    float* pscr = sK + C::SCRATCH + s * C::PSCR;
    // only the last tile has query slots beyond T
    const bool full = q0 + BQ <= Tlen;

    // S^T = K Q^T (role 0) or dP_d^T = V dO^T (role 1): 16 keys x the
    // half's BQ / 2 queries a warp
    float sc[NH][4];
#pragma unroll
    for (int n = 0; n < NH; ++n) sc[n][0] = sc[n][1] = sc[n][2] = sc[n][3] = 0.f;
    mma_abt_alu<D, NH>(sc, ka, (role == 0 ? sQs : sDOs) + (8 * NH * half + g) * LD + t);

    // P_d^T (role 0) or dS^T (role 1) of all BQ queries, split: the A operand
    // of dV's or dK's product, the half's own k8 steps first (0 .. NH - 1),
    // then the other half's
    uint32_t fh[NQ][4], fl[NQ][4];
    if (role == 0) {
      // P^T and P_d^T of the half's queries; P^T goes to the scratch, a
      // dropped entry with its sign bit set (P >= 0, so the sign carries the
      // mask)
      const uint32_t* kp = sKeep + (2 * s + (warp >> 1)) * BQ;  // this warp's key word
#pragma unroll
      for (int n = 0; n < NH; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int nn = NH * half + n;
          const int col = 8 * nn + 2 * t + e;  // query q0 + col
          const bool in = full || q0 + col < Tlen;
          const float lse2 = in ? row_lse2(st[col], st[BQ + col], lg) : INFINITY;
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const float p = prob(sc[n][2 * r + e], scale2, bk[r], lse2);
            float pd = p, pv = p;
            if constexpr (DROP) {
              const bool kept = (kp[col] >> ((lrow + 8 * r) & 31)) & 1u;
              pd = kept ? p * inv_keep : 0.f;
              pv = kept ? p : -p;
            }
            split_tf32_alu(pd, fh[n][r + 2 * e], fl[n][r + 2 * e]);
            pscr[((nn * 2 + e) * 2 + r) * 128 + t128] = pv;
          }
        }
      wg::barrier_arrive(1, 512);  // P^T is in the scratch
    } else {
      wg::barrier_sync(1, 512);
      // dS^T = P^T (dP^T - delta) * scale of the half's queries, dP^T taken
      // back through dropout; stored to the dS^T tile for the other half's
      // dK and for dQ's product
#pragma unroll
      for (int n = 0; n < NH; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int nn = NH * half + n;
          const int col = 8 * nn + 2 * t + e;
          const float dlt = st[2 * BQ + col];
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            float p = pscr[((nn * 2 + e) * 2 + r) * 128 + t128];
            float dpv = sc[n][2 * r + e];
            if constexpr (DROP) {
              dpv = signbit(p) ? 0.f : dpv * inv_keep;
              p = fabsf(p);
            }
            const float ds = (p * (dpv - dlt)) * scale;
            split_tf32_alu(ds, fh[n][r + 2 * e], fl[n][r + 2 * e]);
            sDS[(lrow + 8 * r) * LDS + col] = ds;
          }
        }
    }
    wg::barrier_sync(2, 512);  // P^T and the dS^T tile are whole

    // the other half's queries of P_d^T (from the scratch) or dS^T (from the
    // tile), for the same keys
#pragma unroll
    for (int n = 0; n < NH; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int nn = NH * (1 - half) + n;
        const int col = 8 * nn + 2 * t + e;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float x;
          if (role == 0) {
            x = pscr[((nn * 2 + e) * 2 + r) * 128 + t128];
            if constexpr (DROP) x = signbit(x) ? 0.f : x * inv_keep;
          } else {
            x = sDS[(lrow + 8 * r) * LDS + col];
          }
          split_tf32_alu(x, fh[NH + n][r + 2 * e], fl[NH + n][r + 2 * e]);
        }
      }
    // dV += P_d^T dO (role 0) or dK += dS^T Q (role 1) over the half's
    // columns, the B rows read in the order of the A operand's C fragment
    {
      const float* bq = (role == 0 ? sDOs : sQs) + 2 * t * LD + half * (D / 2) + g;
      mma_pb_cols<NTH, NQ, LD>(acc, fh, fl, bq + 8 * NH * half * LD,
                               bq + 8 * NH * (1 - half) * LD);
    }
    // every thread is past step - 1, which read the other stage
    if (wid == 0 && step + 1 < nqt) load_stage(step + 1, s ^ 1);

    if (wid < C::DQW) {
      // the tile's dQ partial dS K (BQ x D over the block's 64 keys), a 16 x
      // 8 NC part a warp; the key slots of A in the C fragment's order (slot
      // t is key 2t, slot t + 4 key 2t + 1 of a k8 step), K's rows in the same
      float dqp[NC][4];
#pragma unroll
      for (int c = 0; c < NC; ++c) dqp[c][0] = dqp[c][1] = dqp[c][2] = dqp[c][3] = 0.f;
#pragma unroll
      for (int j = 0; j < C::BKEY / 8; ++j) {
        const float* aj = dsa + 8 * j * LDS;
        uint32_t ah[4], al[4], bh[NC][2], bl[NC][2];
        split_tf32_alu(aj[0], ah[0], al[0]);
        split_tf32_alu(aj[8], ah[1], al[1]);
        split_tf32_alu(aj[LDS], ah[2], al[2]);
        split_tf32_alu(aj[LDS + 8], ah[3], al[3]);
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          split_tf32_alu(kb[8 * j * LD + 8 * c], bh[c][0], bl[c][0]);
          split_tf32_alu(kb[(8 * j + 1) * LD + 8 * c], bh[c][1], bl[c][1]);
        }
        mma_3xtf32<NC>(dqp, 0, ah, al, bh, bl);
      }
      // Added into dq in the tile's fixed order of key tiles.  The counter
      // of (b, h, tile i) counts the warps whose adds are done, DQW a turn:
      // a warp waits for DQW * turn (acquire), the first turn stores, later
      // turns add (each element gets its adds in turn order), and lane 0
      // counts the warp in with release semantics after the warp's adds.
      const int turn = turn_of(step);
      if (lane == 0 && turn > 0) wait_count(counter + i, C::DQW * turn);
      __syncwarp();
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int tq = q0 + 16 * mt + g + 8 * r;
        if (tq < Tlen) {
          float* row = dq + base + (long long)tq * row_stride + col0 + 2 * t;
#pragma unroll
          for (int c = 0; c < NC; ++c) {
            const float2 val = make_float2(dqp[c][2 * r], dqp[c][2 * r + 1]);
            if (turn == 0)
              *reinterpret_cast<float2*>(row + 8 * c) = val;
            else
              atomicAdd(reinterpret_cast<float2*>(row + 8 * c), val);
          }
        }
      }
      __syncwarp();
      if (lane == 0 && turn + 1 < nkt) red_release_gpu_add(counter + i, 1);
    }
  }

  float* dst = (role == 0 ? dv : dk) + half * (D / 2);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int kr = key0 + lrow + 8 * r;
    if (kr < Tlen) {
      float* row = dst + base + (long long)kr * row_stride + 2 * t;
#pragma unroll
      for (int c = 0; c < NTH; ++c)
        *reinterpret_cast<float2*>(row + 8 * c) = make_float2(acc[c][2 * r], acc[c][2 * r + 1]);
    }
  }
}

// static: each library keeps its own record of the attribute it set
template <int D, bool DROP>
static int launch_attention_bwd_f32(const BwdArgs& a) {
  using CD = BwdDeltaF32<D>;
  using CF = BwdFusedF32<D>;
  static_assert(CD::SMEM <= kMaxSmemBytes && CF::SMEM <= kMaxSmemBytes,
                "backward tiles do not fit");
  auto delta_kern = attention_bwd_delta_f32_kernel<D, DROP>;
  auto fused_kern = attention_bwd_fused_f32_kernel<D, DROP>;
  static std::atomic<unsigned long long> delta_smem_set{0}, fused_smem_set{0};
  cudaError_t err = set_max_dynamic_smem(delta_kern, CD::SMEM, delta_smem_set);
  if (err != cudaSuccess) return (int)err;
  err = set_max_dynamic_smem(fused_kern, CF::SMEM, fused_smem_set);
  if (err != cudaSuccess) return (int)err;
  const float scale = 1.0f / sqrtf((float)D);
  const float* q = static_cast<const float*>(a.q);
  const float* k = static_cast<const float*>(a.k);
  const float* v = static_cast<const float*>(a.v);
  const float* dout = static_cast<const float*>(a.dout);
  dim3 grid_d((a.T + CD::BQ - 1) / CD::BQ, a.H, a.B);
  delta_kern<<<grid_d, CD::THREADS, CD::SMEM, a.stream>>>(
      q, k, v, a.bias, a.seeds, a.stats, dout, a.delta, a.keep, a.counters, a.T, a.H,
      scale, a.thresh, a.inv_keep);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // reads delta, the keep words and the zeroed counters the delta pass
  // wrote: same stream, so ordered after it.  The key tile is the fastest
  // grid index (the dQ adds rely on it).
  dim3 grid_f((a.T + CF::BKEY - 1) / CF::BKEY, a.H, a.B);
  fused_kern<<<grid_f, CF::THREADS, CF::SMEM, a.stream>>>(
      q, k, v, a.bias, a.stats, dout, a.delta, a.keep, static_cast<float*>(a.dq),
      static_cast<float*>(a.dk), static_cast<float*>(a.dv), a.counters, a.T, a.H, scale,
      a.inv_keep, grid_f.x <= (unsigned)sm_count() ? 1 : 0);
  return (int)cudaGetLastError();
}

template <bool DROP>
int dispatch_attention_bwd_f32(const BwdArgs& a, int D) {
  switch (D) {
    case 32: return launch_attention_bwd_f32<32, DROP>(a);
    case 64: return launch_attention_bwd_f32<64, DROP>(a);
    case 96: return launch_attention_bwd_f32<96, DROP>(a);
    case 128: return launch_attention_bwd_f32<128, DROP>(a);
    case 192: return launch_attention_bwd_f32<192, DROP>(a);
    case 256: return launch_attention_bwd_f32<256, DROP>(a);
    default: return kErrUnsupportedShape;
  }
}

}  // namespace emotts

// q, k, v, dout, dq, dk, dv: contiguous, 16-byte aligned (B, T, H, D) in
// fp32 (is_bf16 = 0) or bf16 (1); bias (B, T) fp32; stats (2, B, H, T) fp32
// as the forward kernel wrote them; delta (B, H, T) fp32 scratch; seeds (B,)
// int32 (may be null when drop == 0); keep (B, H, ceil(T / 32), T) uint32
// scratch (may be null when drop == 0); counters (B, H, ceil(T / BQ)) int32
// scratch, BQ the fused pass's query tile: 64 for bf16, 32 for fp32 (16 at
// D = 256).  bf16 only: dq_acc (B, H, ceil(T / 64), 64 * ceil(D / 64) * 64)
// fp32 scratch, 16-byte aligned (may be null for fp32, whose dQ partials
// are added into dq itself).  D in {32, 64, 96, 128, 192, 256}.  Two
// launches on `stream`, no synchronisation; returns 0 or an error code.
extern "C" int emotts_attention_bwd(
    const void* q, const void* k, const void* v, const float* bias,
    const int* seeds, const float* stats, const void* dout,
    void* dq, void* dk, void* dv, float* delta, void* keep, float* dq_acc,
    int* counters, int B, int T, int H, int D, int is_bf16, int drop,
    unsigned int thresh, float inv_keep, void* stream) {
  if (B <= 0 || T <= 0 || H <= 0 || H > 65535 || B > 65535)
    return emotts::kErrUnsupportedShape;
  if (drop && seeds == nullptr) return emotts::kErrUnsupportedShape;
  if (counters == nullptr || (drop && keep == nullptr) || (is_bf16 && dq_acc == nullptr))
    return emotts::kErrUnsupportedShape;
  const emotts::BwdArgs a{q, k, v, bias, seeds, stats, dout, dq, dk, dv,
                          delta, static_cast<uint32_t*>(keep), dq_acc, counters,
                          B, T, H, thresh, inv_keep,
                          static_cast<cudaStream_t>(stream)};
  if (!emotts::aligned16({q, k, v, dout, dq, dk, dv, dq_acc})) return emotts::kErrMisaligned;
  if (is_bf16)
    return drop ? emotts::dispatch_attention_bwd_tc<true>(a, D)
                : emotts::dispatch_attention_bwd_tc<false>(a, D);
  return drop ? emotts::dispatch_attention_bwd_f32<true>(a, D)
              : emotts::dispatch_attention_bwd_f32<false>(a, D);
}
