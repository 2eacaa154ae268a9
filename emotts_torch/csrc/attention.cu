// Fused self-attention forward for the FFT blocks, with dropout on the
// probabilities for training (rate 0 compiles to the kernels without it).
//
// Replaces the Pallas kernel `_fwd_kernel` of emotts/ops/attention.py
// (reached through `fused_attention`): per (batch, head)
//   S = (Q K^T) * scale + bias[key]   (summed in that order; scale = 1/sqrt(D);
//                                      bias additive: 0 valid, -1e9 pad)
//   P = softmax(S) in fp32, cast to the compute type
//   P = keep ? P / (1 - rate) : 0     (training only; rounded to the type)
//   O = P V with fp32 accumulation, cast to the compute type.
// The TPU kernel keeps the whole (T, T) score block on chip; a Hopper block
// has 227 KB, so both kernels here tile keys with an online softmax (running
// row maximum and row sum in fp32).  Nothing of size T x T reaches device
// memory, and q, k, v, out are read in the module's own (B, T, H, D) layout
// with strides.
//
// What bounds it on this card: 4*B*H*T^2*D operations against
// 4*B*T*H*D*itemsize bytes, so operations from T of a few hundred on.
//
// bf16: `attention_fwd_tc_kernel`, on the tensor cores (wgmma, sm_90a;
// building blocks in wgmma.cuh).
//  - Roles: a block is two consumer warpgroups of 128 threads, each owning 64
//    query rows (wgmma's M); thread 0 also starts the copies.  Blocks cover
//    (query tiles of 128, head, batch).
//  - Per 64-key tile: S = Q K^T is m64n64k16 with both operands in shared
//    memory (D / 16 steps; K = 192 is 12).  The softmax runs on S's
//    accumulator registers (a row's 64 keys sit in four neighbouring lanes).
//    P, packed to bf16 pairs, is already the register A operand of O += P V
//    (m64n64k16 with V read MN-major, one instruction per 64 columns of D),
//    as in FlashAttention-3: P never goes through shared memory.  O is
//    64 x D fp32 in registers (96 a thread at D = 192).
//  - Copies: K and V tiles are double-buffered and copied by TMA
//    (cp.async.bulk.tensor over the (D, H, T, B) strides of the (B, T, H, D)
//    tensor; rows beyond T and columns beyond D come in as zeros), completion
//    on one mbarrier per stage; tile j+1 is in flight while tile j is
//    multiplied, and one __syncthreads a tile hands a stage back.  The tiles
//    are 128-byte swizzled, D rounded up to whole 64-column blocks (D = 32
//    and 96 pay for 64 and 128).  The bias comes by 4-byte cp.async.
//  - Shared memory: Q (128 x DP), two stages of K and V (64 x DP), the bias
//    of both stages and two barriers: 145.5 KB at D = 192, 193.5 KB at
//    D = 256; one block an SM, 168 registers a thread at D = 192 (249 with
//    dropout, whose Philox words live beside the accumulators).
//  - What is left on the critical path: a block's two warpgroups run the
//    same phases at the same time, so the exponentials, the rescaling of O
//    and, with dropout, Philox are not hidden behind the products; their
//    share is what separates this kernel from its bound.
// fp32: `attention_fwd_f32_kernel`, on the tensor cores (mma.sync.m16n8k8
// with TF32 operands, sm_80 and later; helpers in common.cuh and
// attention_common.cuh).  One TF32 product a term misses the fp32 tolerance
// of 2e-4 (errors of 6e-4 to 1e-3), so every product is 3xTF32: each operand
// is split as its fragment is loaded into hi = tf32(v) and lo = tf32(v - hi)
// and lo*hi + hi*lo + hi*hi is accumulated in fp32 (common.cuh), within a
// few 1e-6 of an fp32 product.  What bounds it: operations, and the design
// does three TF32 products for each the bound counts, so bound / time stays
// under 1/3.
//  - Tiles: a block is 128 queries of one (query tile, head, batch), 8 warps
//    of 16 query rows; or 64 queries and 4 warps where those blocks fit in
//    one wave of the card's SMs, where T <= 64, and at D = 256
//    (`launch_attention_f32_tiles`).  K and V come in
//    tiles of 32 keys, double-buffered by 16-byte cp.async (rows beyond T
//    zero-filled), with the bias of each tile; one __syncthreads a tile
//    hands a stage back.  Every tile is fp32 at a row stride of D + 4
//    floats, so the fragment loads of a warp (lane (g, t) at row g, column
//    t, or at row 2t, column g) hit 32 different banks.
//  - Per tile and warp: S = Q K^T is 16 x 32 (4 n8 tiles, D / 8 k-steps),
//    its A fragments read from Q in shared memory and split at load.  The
//    online softmax runs on S's accumulator registers (a row's keys sit in
//    one quad of lanes).  O += P V needs P as an A fragment: the C fragment
//    gives thread (g, t) keys 2t and 2t + 1 of each n8 tile, where the A
//    layout wants t and t + 4; the sum over keys does not depend on their
//    order, so V's rows are read in the C fragment's order (A slot t is key
//    2t, slot t + 4 key 2t + 1) and P goes from its accumulator into the A
//    fragment, split, without a shuffle or shared memory.  O is 16 x D fp32
//    a warp: 96 registers a thread at D = 192, 128 at D = 256.
//  - Shared memory: Q (128 or 64 x (D + 4)), two stages of K and V (32 x
//    (D + 4)) and their bias: 200,960 bytes at D = 192 (150,784 for 64
//    queries), 199,936 at D = 256; one block an SM.  Registers at D = 192
//    (tools/profile_attention_f32.py prints ptxas' report): 201 a thread,
//    209 with dropout, no spills.
//
// Bias and padding.  The bias is additive and finite on purpose: a row whose
// keys are all padded has every score rounded to -1e9 in fp32 and comes out
// as the uniform mean of V, exactly as in the reference.  So padded key tiles
// are never skipped, and -inf is used only for key slots beyond T in the last
// tile; query rows beyond T are computed on zero rows and never written.
//
// Rounding: S is summed in fp32 (the tensor cores' accumulator), scaled and
// biased in fp32 in the reference's order.  With bf16 inputs the reference
// rounds the normalised P to bf16 before P V; an online softmax has no
// normalised P until the end, so the un-normalised exp(s - m) is rounded
// instead (the row sum stays fp32 and un-rounded) and O is divided by the
// row sum at the end.  The two differ by at most one bf16 rounding of each
// probability; in fp32 nothing is rounded, and the 3xTF32 products keep the
// results within about 1e-5 of the plain version.  The bf16 kernel's exp is
// the hardware's ex2 (a few ulp of fp32, far below a bf16 step), the fp32
// kernel's expf.
//
// Dropout.  The keep-mask is a pure function of (seed[b], head, query, key):
// Philox4x32-10 keyed by the reference's per-(example, head) mix of the seed,
// counter (query, key / 4), word key % 4, kept where the word >= rate * 2^32.
// The backward kernels (attention_bwd.cu) walk the tiles in other orders and
// regenerate the same bits.  The TPU kernel draws from that chip's own
// generator, so the bits differ from the reference's; the plain PyTorch
// version computes the same Philox bits and is compared value for value.
// A dropped entry still counts in the softmax row sum: dropping the
// un-normalised exp(s - m) and dividing by the full sum at the end equals
// dropping the normalised probability.  A kept value is rounded to the type,
// then scaled by 1 / (1 - rate) and rounded again.
//
// For the backward pass the kernels can also write each query row's running
// maximum and sum (`stats`, (2, B, H, T) fp32), from which the backward
// kernels form P tile by tile without a pass of their own.  Two numbers, not
// their log-sum-exp: a fully padded row has maximum -1e9, and -1e9 + log(T)
// is not representable in fp32.
#include "attention_common.cuh"

#include <math.h>

namespace emotts {

struct FwdArgs {
  const void *q, *k, *v;
  const float* bias;
  const int* seeds;
  void* out;
  float* stats;
  int B, T, H;
  uint32_t thresh;
  float inv_keep;
  cudaStream_t stream;
};

// ---------------------------------------------------------------------------
// fp32 on the tensor cores (mma.sync, 3xTF32)
// ---------------------------------------------------------------------------

template <int D, int BQ_>
struct FwdF32 {
  static constexpr int BQ = BQ_;                 // queries per block, 16 a warp
  static constexpr int THREADS = 2 * BQ;         // BQ / 16 warps
  static constexpr int BK = 32;                  // keys per tile
  static constexpr int LD = F32Tile<D>::LD;
  static constexpr int NT = D / 8;               // n8 tiles of a row of O
  static constexpr int Q_FLOATS = BQ * LD;
  static constexpr int KV_FLOATS = BK * LD;      // one K or V tile
  // Q; stage s: K at 2s, V at 2s + 1 (in KV tiles); the bias of stage s
  static constexpr int BIAS = Q_FLOATS + 4 * KV_FLOATS;
  static constexpr int SMEM = (BIAS + 2 * BK) * 4;
};

template <int D, int BQ, bool DROP>
__global__ void __launch_bounds__(FwdF32<D, BQ>::THREADS, 1)
attention_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, const float* __restrict__ bias,
                         const int* __restrict__ seeds, float* __restrict__ out,
                         float* __restrict__ stats, int Tlen, int H, float scale,
                         uint32_t thresh, float inv_keep) {
  using C = FwdF32<D, BQ>;
  constexpr int LD = C::LD, BK = C::BK, NT = C::NT;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sQ = reinterpret_cast<float*>(smem_raw);
  float* sKV = sQ + C::Q_FLOATS;
  const float* sBias = sQ + C::BIAS;

  const int tid = threadIdx.x, warp = tid >> 5;
  const int g = (tid & 31) >> 2, t = tid & 3;
  const int q0 = blockIdx.x * C::BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const long long row_stride = (long long)H * D;
  const long long base = (long long)b * Tlen * row_stride + (long long)h * D;
  const float* bias_b = bias + (long long)b * Tlen;
  const int nkt = (Tlen + BK - 1) / BK;
  const int row0 = q0 + 16 * warp + g;  // this thread's rows row0, row0 + 8
  const uint32_t key = DROP ? dropout_key(seeds[b], h) : 0u;

  // K, V and the bias of tile j into stage s, one cp.async group
  auto load_kv = [&](int j, int s) {
    float* sK = sKV + 2 * s * C::KV_FLOATS;
    copy_rows_f32<D, BK, C::THREADS>(sK, k + base, row_stride, j * BK, Tlen, tid);
    copy_rows_f32<D, BK, C::THREADS>(sK + C::KV_FLOATS, v + base, row_stride,
                                     j * BK, Tlen, tid);
    copy_floats(wg::smem_addr(sBias + s * BK), bias_b, j * BK, BK, Tlen, tid);
    cp_async_commit_group();
  };
  copy_rows_f32<D, C::BQ, C::THREADS>(sQ, q + base, row_stride, q0, Tlen, tid);
  load_kv(0, 0);  // one group with Q

  float o[NT][4];
#pragma unroll
  for (int c = 0; c < NT; ++c) o[c][0] = o[c][1] = o[c][2] = o[c][3] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};
  const float* qa = sQ + (16 * warp + g) * LD + t;

  for (int j = 0; j < nkt; ++j) {
    const int s = j & 1, k0 = j * BK;
    cp_async_wait_group<0>();  // this thread's copies of tile j
    __syncthreads();           // everyone's; tile j - 1 is done with
    if (j + 1 < nkt) load_kv(j + 1, s ^ 1);
    const float* sK = sKV + 2 * s * C::KV_FLOATS;
    const float* sV = sK + C::KV_FLOATS;

    // S = Q K^T: 16 x 32 a warp, row g in sc[n][0..1], row g + 8 in [2..3]
    float sc[BK / 8][4];
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) sc[n][0] = sc[n][1] = sc[n][2] = sc[n][3] = 0.f;
    mma_abt<D, BK / 8>(sc, qa, sK + g * LD + t);

    // scale and bias in the reference's order; only the last tile has key
    // slots beyond T
    const bool full = k0 + BK <= Tlen;
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < BK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * n + 2 * t + e;
        const float bj = sBias[s * BK + col];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float& x = sc[n][2 * r + e];
          x = __fadd_rn(__fmul_rn(x, scale), bj);
          if (!full && k0 + col >= Tlen) x = -INFINITY;
          mx[r] = fmaxf(mx[r], x);
        }
      }
    float alpha[2], psum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      // key 0 of the first tile is always inside T and every bias is finite,
      // so the maximum is finite from the first tile on
      const float m_new = fmaxf(m_run[r], mx[r]);
      alpha[r] = expf(m_run[r] - m_new);
      m_run[r] = m_new;
    }
    // P = exp(s - m) straight into the split A fragments of O += P V: keys
    // 8n + 2t, +1 of row g (g + 8) are slots t, t + 4 of k-step n, i.e.
    // fragment registers 0, 2 (1, 3)
    uint32_t ph[BK / 8][4], pl[BK / 8][4];
#pragma unroll
    for (int n = 0; n < BK / 8; ++n)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        uint4 w = make_uint4(0u, 0u, 0u, 0u);
        if constexpr (DROP)
          // keys 8n + 2t, +1 are words 2(t & 1), +1 of group k0/4 + 2n + t/2
          w = dropout_bits(key, (uint32_t)(row0 + 8 * r),
                           (uint32_t)((k0 >> 2) + 2 * n + (t >> 1)));
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float p = expf(sc[n][2 * r + e] - m_run[r]);
          psum[r] += p;  // a dropped entry still counts in the row sum
          if constexpr (DROP) {
            const uint32_t word = (t & 1) ? (e ? w.w : w.z) : (e ? w.y : w.x);
            p = word >= thresh ? p * inv_keep : 0.f;
          }
          split_tf32<true>(p, ph[n][r + 2 * e], pl[n][r + 2 * e]);
        }
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      psum[r] += __shfl_xor_sync(0xffffffffu, psum[r], 1);
      psum[r] += __shfl_xor_sync(0xffffffffu, psum[r], 2);
      l_run[r] = l_run[r] * alpha[r] + psum[r];
    }
#pragma unroll
    for (int c = 0; c < NT; ++c) {
      o[c][0] *= alpha[0];
      o[c][1] *= alpha[0];
      o[c][2] *= alpha[1];
      o[c][3] *= alpha[1];
    }

    // O += P V, V's rows read in the order of P's C fragment
    mma_pb<D, BK / 8>(o, ph, pl, sV + 2 * t * LD + g);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row < Tlen) {
      const float inv = 1.f / l_run[r];
      float* orow = out + base + (long long)row * row_stride + 2 * t;
#pragma unroll
      for (int c = 0; c < NT; ++c)
        *reinterpret_cast<float2*>(orow + 8 * c) =
            make_float2(o[c][2 * r] * inv, o[c][2 * r + 1] * inv);
      if (stats != nullptr && t == 0) {
        const long long st = ((long long)b * H + h) * Tlen + row;
        stats[st] = m_run[r];
        stats[(long long)gridDim.z * H * Tlen + st] = l_run[r];
      }
    }
  }
}

// static: each library keeps its own record of the attribute it set
template <int D, int BQ, bool DROP>
static int launch_attention_f32(const FwdArgs& a) {
  using C = FwdF32<D, BQ>;
  static_assert(C::SMEM <= kMaxSmemBytes, "forward tile does not fit");
  auto kern = attention_fwd_f32_kernel<D, BQ, DROP>;
  static std::atomic<unsigned long long> smem_set{0};
  cudaError_t err = set_max_dynamic_smem(kern, C::SMEM, smem_set);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((a.T + C::BQ - 1) / C::BQ, a.H, a.B);
  const float scale = 1.0f / sqrtf((float)D);
  kern<<<grid, C::THREADS, C::SMEM, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), a.bias, a.seeds, static_cast<float*>(a.out),
      a.stats, a.T, a.H, scale, a.thresh, a.inv_keep);
  return (int)cudaGetLastError();
}

// A block takes one SM either way, for its shared memory.  64 queries a
// block (4 warps) where those blocks fit in one wave of the card's SMs, or
// where T <= 64 (a 128-query tile would be half padding); else 128 (8 warps:
// a 64-query block of 4 warps takes much more than half a 128-query block's
// time, so two waves of them lose to one wave of 128-query blocks).  At
// D = 256 a 128-query tile does not fit.
template <int D, bool DROP>
static int launch_attention_f32_tiles(const FwdArgs& a) {
  if constexpr (D <= 192) {
    int dev = 0, sms = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    if (a.T > 64 && (long long)((a.T + 63) / 64) * a.H * a.B > sms)
      return launch_attention_f32<D, 128, DROP>(a);
  }
  return launch_attention_f32<D, 64, DROP>(a);
}

template <bool DROP>
int dispatch_attention_f32(const FwdArgs& a, int D) {
  switch (D) {
    case 32: return launch_attention_f32_tiles<32, DROP>(a);
    case 64: return launch_attention_f32_tiles<64, DROP>(a);
    case 96: return launch_attention_f32_tiles<96, DROP>(a);
    case 128: return launch_attention_f32_tiles<128, DROP>(a);
    case 192: return launch_attention_f32_tiles<192, DROP>(a);
    case 256: return launch_attention_f32_tiles<256, DROP>(a);
    default: return kErrUnsupportedShape;
  }
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores
// ---------------------------------------------------------------------------

template <int D>
struct FwdTc {
  static constexpr int DP = TcWidth<D>::DP;
  static constexpr int NB = TcWidth<D>::NB;
  static constexpr int BQ = 128;  // two warpgroups of 64 query rows
  static constexpr int BK = 64;   // keys per tile
  static constexpr int THREADS = 256;
  static constexpr int Q_BYTES = BQ * DP * 2;
  static constexpr int KV_BYTES = BK * DP * 2;  // one K or V tile
  // Q; stage s: K at 2s, V at 2s + 1 (in KV tiles); the bias of both
  // stages; the copy barrier of each stage
  static constexpr int BIAS = Q_BYTES + 4 * KV_BYTES;
  static constexpr int BARS = BIAS + 2 * BK * 4;
  static constexpr int SMEM = 1024 + BARS + 2 * 8;
};

template <int D, bool DROP>
__global__ void __launch_bounds__(FwdTc<D>::THREADS, 1)
attention_fwd_tc_kernel(const __grid_constant__ CUtensorMap tm_q,
                        const __grid_constant__ CUtensorMap tm_k,
                        const __grid_constant__ CUtensorMap tm_v,
                        const float* __restrict__ bias,
                        const int* __restrict__ seeds,
                        __nv_bfloat16* __restrict__ out,
                        float* __restrict__ stats, int Tlen, int H,
                        float scale, uint32_t thresh, float inv_keep) {
  using C = FwdTc<D>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = wg::align_1024(smem_raw);
  const uint32_t sQ = wg::smem_addr(smem);
  const uint32_t sKV = sQ + C::Q_BYTES;
  const float* sBias = reinterpret_cast<const float*>(smem + C::BIAS);
  const uint32_t sBiasAddr = sQ + C::BIAS;
  const uint32_t bar = sQ + C::BARS;  // stage s: bar + 8 s

  const int tid = threadIdx.x;
  const int wgi = tid >> 7;           // warpgroup: query rows 64 wgi ..
  const int warp = (tid >> 5) & 3;    // warp in the warpgroup: 16 rows each
  const int g = (tid & 31) >> 2, c = tid & 3;
  const int q0 = blockIdx.x * C::BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const long long row_stride = (long long)H * D;
  const long long base = (long long)b * Tlen * row_stride + (long long)h * D;
  const float* bias_b = bias + (long long)b * Tlen;
  const int nkt = (Tlen + C::BK - 1) / C::BK;
  // this thread's two query rows
  const int row0 = q0 + 64 * wgi + 16 * warp + g;
  const uint32_t sQw = sQ + wgi * 64 * 128;  // the warpgroup's 64 rows
  const uint32_t key = DROP ? dropout_key(seeds[b], h) : 0u;

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
  load_kv(0, 0, C::Q_BYTES);
  if (tid == 0) tma_tile<D, C::BQ>(sQ, tm_q, bar, h, q0, b);

  float o[C::NB][32];
  float sc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    sc[i] = 0.f;
#pragma unroll
    for (int n = 0; n < C::NB; ++n) o[n][i] = 0.f;
  }
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};

  for (int j = 0; j < nkt; ++j) {
    const int s = j & 1;
    const int k0 = j * C::BK;
    wg::mbar_wait(bar + 8 * s, (j >> 1) & 1);  // K, V (and at j = 0, Q)
    wg::cp_async_wait<0>();                     // this thread's bias copy
    __syncthreads();  // every bias copy has landed; tile j-1 is done with
    if (j + 1 < nkt) load_kv(j + 1, s ^ 1, 0);
    const uint32_t sK = sKV + 2 * s * C::KV_BYTES, sV = sK + C::KV_BYTES;

    // S = Q K^T
    wg::fence();
#pragma unroll
    for (int kk = 0; kk < C::DP / 16; ++kk)
      wg::mma_ss(sc, wg::desc_k(sQw, C::BQ, kk),
                        wg::desc_k(sK, C::BK, kk), kk > 0);
    wg::commit();
    wg::wait<0>();
    wg::fence_regs(sc);

    // online softmax on rows row0 (registers 4i, 4i+1) and row0 + 8 (4i+2,
    // 4i+3); only the last tile has key slots beyond T
    const bool full = k0 + C::BK <= Tlen;
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * i + 2 * c + e;
        const float bj = sBias[s * C::BK + col];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float& x = sc[4 * i + 2 * r + e];
          x = __fadd_rn(__fmul_rn(x, scale), bj);
          if (!full && k0 + col >= Tlen) x = -INFINITY;
          mx[r] = fmaxf(mx[r], x);
        }
      }
    float alpha[2], psum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      // key 0 of the first tile is always inside T and every bias is finite,
      // so the maximum is finite from the first tile on
      const float m_new = fmaxf(m_run[r], mx[r]);
      alpha[r] = __expf(m_run[r] - m_new);
      m_run[r] = m_new;
    }
    // P, rounded to bf16 by the packing, straight into the A fragments of
    // O += P V: keys 8i + 2c, +1 of row r are word 2 (i & 1) + r of step i / 2
    uint32_t pa[4][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float p0 = __expf(sc[4 * i + 2 * r] - m_run[r]);
        const float p1 = __expf(sc[4 * i + 2 * r + 1] - m_run[r]);
        psum[r] += p0 + p1;
        uint32_t packed = wg::pack_bf16(p0, p1);
        if constexpr (DROP) {
          // keys 8i + 2c, +1 are words 2(c & 1), +1 of group k0/4 + 2i + c/2;
          // kept values are scaled after the cast to the compute type
          const uint4 w = dropout_bits(key, (uint32_t)(row0 + 8 * r),
                                       (uint32_t)((k0 >> 2) + 2 * i + (c >> 1)));
          const uint32_t w0 = (c & 1) ? w.z : w.x, w1 = (c & 1) ? w.w : w.y;
          packed = wg::pack_bf16(w0 >= thresh ? bf16_lo(packed) * inv_keep : 0.f,
                                 w1 >= thresh ? bf16_hi(packed) * inv_keep : 0.f);
        }
        pa[i >> 1][2 * (i & 1) + r] = packed;
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      psum[r] += __shfl_xor_sync(0xffffffffu, psum[r], 1);
      psum[r] += __shfl_xor_sync(0xffffffffu, psum[r], 2);
      l_run[r] = l_run[r] * alpha[r] + psum[r];
    }
#pragma unroll
    for (int n = 0; n < C::NB; ++n)
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        o[n][4 * i] *= alpha[0];
        o[n][4 * i + 1] *= alpha[0];
        o[n][4 * i + 2] *= alpha[1];
        o[n][4 * i + 3] *= alpha[1];
      }

    // O += P V
    wg::fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int n = 0; n < C::NB; ++n)
        wg::mma_rs(o[n], pa[kk], wg::desc_mn(sV, C::BK, kk, n), 1);
    wg::commit();
    wg::wait<0>();
#pragma unroll
    for (int n = 0; n < C::NB; ++n) wg::fence_regs(o[n]);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wg::fence_regs(pa[kk]);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int t = row0 + 8 * r;
    if (t < Tlen) {
      const float inv = 1.f / l_run[r];
      __nv_bfloat16* orow = out + base + (long long)t * row_stride;
#pragma unroll
      for (int n = 0; n < C::NB; ++n)
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int col = 64 * n + 8 * i + 2 * c;
          if (col < D)
            *reinterpret_cast<uint32_t*>(orow + col) = wg::pack_bf16(
                o[n][4 * i + 2 * r] * inv, o[n][4 * i + 2 * r + 1] * inv);
        }
      if (stats != nullptr && c == 0) {
        const long long row = ((long long)b * H + h) * Tlen + t;
        stats[row] = m_run[r];
        stats[(long long)gridDim.z * H * Tlen + row] = l_run[r];
      }
    }
  }
}

// static: each library keeps its own record of the attribute it set
template <int D, bool DROP>
static int launch_attention_tc(const FwdArgs& a) {
  using C = FwdTc<D>;
  static_assert(C::SMEM <= kMaxSmemBytes, "forward tile does not fit");
  auto kern = attention_fwd_tc_kernel<D, DROP>;
  static std::atomic<unsigned long long> smem_set{0};
  cudaError_t err = set_max_dynamic_smem(kern, C::SMEM, smem_set);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap tq, tk, tv;
  if (int e = tile_map(&tq, a.q, a.B, a.T, a.H, D, C::BQ)) return e;
  if (int e = tile_map(&tk, a.k, a.B, a.T, a.H, D, C::BK)) return e;
  if (int e = tile_map(&tv, a.v, a.B, a.T, a.H, D, C::BK)) return e;
  dim3 grid((a.T + C::BQ - 1) / C::BQ, a.H, a.B);
  const float scale = 1.0f / sqrtf((float)D);
  kern<<<grid, C::THREADS, C::SMEM, a.stream>>>(
      tq, tk, tv, a.bias, a.seeds, static_cast<__nv_bfloat16*>(a.out), a.stats,
      a.T, a.H, scale, a.thresh, a.inv_keep);
  return (int)cudaGetLastError();
}

template <bool DROP>
int dispatch_attention_tc(const FwdArgs& a, int D) {
  switch (D) {
    case 32: return launch_attention_tc<32, DROP>(a);
    case 64: return launch_attention_tc<64, DROP>(a);
    case 96: return launch_attention_tc<96, DROP>(a);
    case 128: return launch_attention_tc<128, DROP>(a);
    case 192: return launch_attention_tc<192, DROP>(a);
    case 256: return launch_attention_tc<256, DROP>(a);
    default: return kErrUnsupportedShape;
  }
}

}  // namespace emotts

// q, k, v, out: contiguous, 16-byte aligned (B, T, H, D) in fp32 (is_bf16 =
// 0) or bf16 (1); bias: contiguous (B, T) fp32.  D in {32, 64, 96, 128,
// 192, 256}.  drop != 0 applies dropout: seeds (B,) int32, an entry kept where
// its random word >= thresh and scaled by inv_keep; with drop == 0 seeds may
// be null.  stats: null, or (2, B, H, T) fp32 to receive each row's maximum
// and sum.  Launches on `stream`, does not synchronise; returns 0 or an error
// code.
extern "C" int emotts_attention_fwd(const void* q, const void* k, const void* v,
                                    const float* bias, const int* seeds,
                                    void* out, float* stats, int B, int T,
                                    int H, int D, int is_bf16, int drop,
                                    unsigned int thresh, float inv_keep,
                                    void* stream) {
  if (B <= 0 || T <= 0 || H <= 0 || H > 65535 || B > 65535)
    return emotts::kErrUnsupportedShape;
  if (drop && seeds == nullptr) return emotts::kErrUnsupportedShape;
  const emotts::FwdArgs a{q, k, v, bias, seeds, out, stats, B, T, H, thresh,
                          inv_keep, static_cast<cudaStream_t>(stream)};
  if (!emotts::aligned16({q, k, v, out})) return emotts::kErrMisaligned;
  if (is_bf16)
    return drop ? emotts::dispatch_attention_tc<true>(a, D)
                : emotts::dispatch_attention_tc<false>(a, D);
  return drop ? emotts::dispatch_attention_f32<true>(a, D)
              : emotts::dispatch_attention_f32<false>(a, D);
}
