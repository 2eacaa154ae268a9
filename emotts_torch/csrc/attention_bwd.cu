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
// Two reduction directions, two launches and no atomics, so that a repeated
// call gives the same bits: every sum is taken by one thread or one
// warpgroup's tensor-core accumulator in a fixed order, and each output
// element is written once.
//   dq kernel    one block per query tile; a first sweep over the key tiles
//                sums rowsum(dP * P) and stores it (`delta`) for the second
//                kernel, a second sweep accumulates dQ;
//   dkv kernel   one block per key tile, a sweep over the query tiles.
// Every sweep recomputes S and dP_d for its tile pairs, so the design does
// nine T x T x D products where the algorithm has five (18 against
// 10 * B*H*T^2*D operations).  The tensor-core version keeps that: there the
// products are not what the time goes to (the exponentials, the roundings
// and the copies around them are).  The dropout mask is regenerated from (seed, head, query, key)
// exactly as in the forward kernel (attention_common.cuh).
//
// Padding: the bias is additive -1e9, so a padded key has P = 0 exactly and
// a fully padded query row has uniform P and a finite gradient, as in the
// reference.  Query and key slots beyond T in a last tile are given P = 0,
// so they add nothing to rows that exist, and are never written.
//
// What bounds it on this card: 10*B*H*T^2*D operations against
// (4 reads + 3 writes)*B*T*H*D*itemsize + statistics bytes, so operations
// from T of a few hundred on.
//
// bf16: on the tensor cores (wgmma, sm_90a; building blocks in wgmma.cuh).
// The products are m64n64k16 (m64n32k16 for S and dP at D = 256): two
// operands in shared memory where both are tiles, a register A operand where
// one side is a fresh result (P or dS, packed to bf16 pairs from its
// accumulator registers), a tile read MN-major where the head dim is the
// output (one instruction per 64 columns).  Tiles are copied by TMA into
// 128-byte swizzled, double-buffered stages with one mbarrier each (rows
// beyond T and columns beyond D come in as zeros; D rounded up to whole
// 64-column blocks); the statistics and the bias come by 4-byte cp.async;
// one __syncthreads a tile hands a stage back.
//  - dq kernel (`attention_bwd_dq_tc_kernel`): two warpgroups, each owning 64
//    query rows, share the K and V tiles (64 keys; 32 at D = 256, for
//    registers).  Per tile S = Q K^T and dP_d = dO V^T; P, dP and dS are
//    formed on their accumulator registers; in the second sweep dS is the
//    register A operand of dQ += dS K.  dQ is 64 x D fp32 in registers.
//    Shared memory: Q and dO of 128 rows, two stages of K and V: 193.5 KB at
//    D = 192, 193.3 KB at D = 256; 202 registers a thread at D = 192.
//  - dkv kernel (`attention_bwd_dkv_tc_kernel`): one block per 64 keys, two
//    warpgroups with their own roles, since dK and dV together would be
//    2 * 64 * D fp32 (192 registers a thread at D = 192).  Keys are the rows
//    of every product (M = 64), so a key's values sit in one row of
//    registers.  Per 64-query tile:
//      warpgroup 0: S^T = K Q^T; P^T = exp(S^T - m) / l rounded to bf16;
//                   P_d^T; P^T to a 8 KB scratch (bf16 pairs, register-major:
//                   thread t of the other warpgroup holds the same elements;
//                   a dropped entry carries its mask in the sign bit);
//                   dV += P_d^T dO with P_d^T as the register A operand;
//      warpgroup 1: dP_d^T = V dO^T, and 1 / l of the tile's queries while
//                   that product runs; dS^T = P^T (dP^T - delta) * scale;
//                   dK += dS^T Q with dS^T as the register A operand.
//    Two named barriers a tile order the hand-overs (1 / l to warpgroup 0,
//    P^T to warpgroup 1).  Shared memory: K and V of 64 rows, two stages of
//    Q and dO of 64 rows, the scratch, the statistics: 154.5 KB at D = 192,
//    202.5 KB at D = 256; 180 registers a thread at D = 192.
//  - Deterministic: each output element is one warpgroup's accumulator,
//    summed over the tiles in a fixed order, and delta is each thread's
//    fp32 sum over the key tiles in order, then the four lanes of a row in a
//    fixed butterfly.  No atomics.
//  - Rounding points as the reference: P rounded to bf16 before it enters
//    dS and (dropped out and rounded again) dV; dS rounded to bf16 before dQ
//    and dK.  Rounding of a single value is integer arithmetic
//    (round_bf16_alu), of a pair one conversion instruction: the conversion
//    unit is the one the exponentials use.
// fp32: `attention_bwd_dq_kernel` and `attention_bwd_dkv_kernel`, on the
// fp32 FMA units (64-query and 32-key tiles, products through shared
// memory); TF32 would change the numbers the fp32 comparisons hold to 2e-4.
#include "attention_common.cuh"

#include <math.h>

namespace emotts {

constexpr int kBwdBQ = 64;  // queries per tile
constexpr int kBwdBK = 32;  // keys per tile

template <typename T>
size_t attn_bwd_smem_bytes(int D) {
  const int ld = D + attn_row_pad<T>();
  return (size_t)(2 * kBwdBQ + 2 * kBwdBK) * ld * sizeof(T) +
         (size_t)(2 * kBwdBQ * kBwdBK + 3 * kBwdBQ + kBwdBK) * sizeof(float);
}

template <typename T, int D>
struct BwdSmem {
  static constexpr int LD = D + attn_row_pad<T>();
  T *sQ, *sDO, *sK, *sV;
  float *sS, *sDP;             // kBwdBQ x kBwdBK each
  float *sM, *sL, *sDelta;     // per query row: max, sum, rowsum(dP * P)
  float *sBias;                // per key
  __device__ explicit BwdSmem(unsigned char* raw) {
    sQ = reinterpret_cast<T*>(raw);
    sDO = sQ + kBwdBQ * LD;
    sK = sDO + kBwdBQ * LD;
    sV = sK + kBwdBK * LD;
    sS = reinterpret_cast<float*>(sV + kBwdBK * LD);
    sDP = sS + kBwdBQ * kBwdBK;
    sM = sDP + kBwdBQ * kBwdBK;
    sL = sM + kBwdBQ;
    sDelta = sL + kBwdBQ;
    sBias = sDelta + kBwdBQ;
  }
};

// For the tile pair (queries q0.., keys k0..) held in shared memory, either
// (DELTA_ONLY) add the tile's share of rowsum(dP * P) to sDelta, or
//   sS  <- P_d (the dropped-out probabilities, in the compute type's values)
//   sDP <- dS  (rounded to the compute type).
// Ends with a __syncthreads().
template <typename T, int D, bool DROP, bool DELTA_ONLY>
__device__ __forceinline__ void tile_probs_and_ds(
    const BwdSmem<T, D>& sm, int q0, int k0, int Tlen, float scale,
    uint32_t key, uint32_t thresh, float inv_keep, int tid) {
  constexpr int LD = BwdSmem<T, D>::LD;
  // 16 x 16 threads, each a 4 x 2 patch of both products
  const int tx = tid & 15;
  const int ty = tid >> 4;
  {
    float s[4][2], dp[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[4], gv[4], kv[2], vv[2];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qv[i] = to_float(sm.sQ[(4 * ty + i) * LD + d]);
        gv[i] = to_float(sm.sDO[(4 * ty + i) * LD + d]);
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        kv[j] = to_float(sm.sK[(tx + 16 * j) * LD + d]);
        vv[j] = to_float(sm.sV[(tx + 16 * j) * LD + d]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
          dp[i][j] = fmaf(gv[i], vv[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int kk = tx + 16 * j;
      const float bj = sm.sBias[kk];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        // same order as the forward pass: (dot * scale) + bias
        sm.sS[(4 * ty + i) * kBwdBK + kk] = s[i][j] * scale + bj;
        sm.sDP[(4 * ty + i) * kBwdBK + kk] = dp[i][j];
      }
    }
  }
  __syncthreads();

  // elementwise, by groups of 4 keys (one Philox call each): 512 groups,
  // two per thread
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int g = tid + kThreads * i;
    const int r = g >> 3, c4 = g & 7;
    const int qi = q0 + r;
    const float m = sm.sM[r], l = sm.sL[r];
    const float delta = DELTA_ONLY ? 0.f : sm.sDelta[r];
    float row_sum = 0.f;
    uint32_t bits[4] = {0u, 0u, 0u, 0u};
    if constexpr (DROP) {
      const uint4 w = dropout_bits(key, (uint32_t)qi, (uint32_t)((k0 >> 2) + c4));
      bits[0] = w.x; bits[1] = w.y; bits[2] = w.z; bits[3] = w.w;
    }
    float* ps = sm.sS + r * kBwdBK + 4 * c4;
    float* pg = sm.sDP + r * kBwdBK + 4 * c4;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const bool inside = qi < Tlen && (k0 + 4 * c4 + e) < Tlen;
      const float p =
          inside ? to_float(from_float<T>(expf(ps[e] - m) / l)) : 0.f;
      float pd = p, dpv = pg[e];
      if constexpr (DROP) {
        const bool keep = bits[e] >= thresh;
        pd = keep ? to_float(from_float<T>(p * inv_keep)) : 0.f;
        dpv = keep ? dpv * inv_keep : 0.f;
      }
      if constexpr (DELTA_ONLY) {
        row_sum = fmaf(dpv, p, row_sum);
      } else {
        ps[e] = pd;
        pg[e] = to_float(from_float<T>((p * (dpv - delta)) * scale));
      }
    }
    if constexpr (DELTA_ONLY) {
      // the 8 groups of a row sit in 8 neighbouring lanes; one of them owns
      // the row's sum, so the order of additions is fixed
      row_sum += __shfl_xor_sync(0xffffffffu, row_sum, 1);
      row_sum += __shfl_xor_sync(0xffffffffu, row_sum, 2);
      row_sum += __shfl_xor_sync(0xffffffffu, row_sum, 4);
      if (c4 == 0) sm.sDelta[r] += row_sum;
    }
  }
  __syncthreads();
}

template <typename T, int DJ, bool DROP>
__global__ void __launch_bounds__(kThreads)
attention_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const float* __restrict__ bias,
                        const int* __restrict__ seeds,
                        const float* __restrict__ stats,
                        const T* __restrict__ dout, T* __restrict__ dq,
                        float* __restrict__ delta_out, int Tlen, int H,
                        float scale, uint32_t thresh, float inv_keep) {
  constexpr int D = DJ * 32;
  constexpr int LD = BwdSmem<T, D>::LD;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const BwdSmem<T, D> sm(smem_raw);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int q0 = blockIdx.x * kBwdBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const long long row_stride = (long long)H * D;
  const long long base = ((long long)b * Tlen) * row_stride + (long long)h * D;
  const long long stat_row = ((long long)b * H + h) * Tlen;
  const long long stat_plane = (long long)gridDim.z * H * Tlen;
  const uint32_t key = DROP ? dropout_key(seeds[b], h) : 0u;

  load_rows<T, D, LD>(sm.sQ, q, base, row_stride, q0, kBwdBQ, Tlen, tid);
  load_rows<T, D, LD>(sm.sDO, dout, base, row_stride, q0, kBwdBQ, Tlen, tid);
  if (tid < kBwdBQ) {
    const int t = q0 + tid;
    sm.sM[tid] = t < Tlen ? stats[stat_row + t] : 0.f;
    sm.sL[tid] = t < Tlen ? stats[stat_plane + stat_row + t] : 1.f;
    sm.sDelta[tid] = 0.f;
  }

  // first sweep: rowsum(dP * P) of the 64 query rows
  for (int k0 = 0; k0 < Tlen; k0 += kBwdBK) {
    __syncthreads();
    load_rows<T, D, LD>(sm.sK, k, base, row_stride, k0, kBwdBK, Tlen, tid);
    load_rows<T, D, LD>(sm.sV, v, base, row_stride, k0, kBwdBK, Tlen, tid);
    if (tid < kBwdBK) {
      const int t = k0 + tid;
      sm.sBias[tid] = t < Tlen ? bias[(long long)b * Tlen + t] : 0.f;
    }
    __syncthreads();
    tile_probs_and_ds<T, D, DROP, true>(sm, q0, k0, Tlen, scale, key, thresh,
                                        inv_keep, tid);
  }
  if (tid < kBwdBQ && q0 + tid < Tlen)
    delta_out[stat_row + q0 + tid] = sm.sDelta[tid];

  float acc[8][DJ];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[r][j] = 0.f;

  for (int k0 = 0; k0 < Tlen; k0 += kBwdBK) {
    __syncthreads();  // the previous tile's sK and sDP are no longer read
    load_rows<T, D, LD>(sm.sK, k, base, row_stride, k0, kBwdBK, Tlen, tid);
    load_rows<T, D, LD>(sm.sV, v, base, row_stride, k0, kBwdBK, Tlen, tid);
    if (tid < kBwdBK) {
      const int t = k0 + tid;
      sm.sBias[tid] = t < Tlen ? bias[(long long)b * Tlen + t] : 0.f;
    }
    __syncthreads();
    tile_probs_and_ds<T, D, DROP, false>(sm, q0, k0, Tlen, scale, key, thresh,
                                         inv_keep, tid);
    // dQ += dS K
#pragma unroll 2
    for (int kk = 0; kk < kBwdBK; ++kk) {
      float kv[DJ];
#pragma unroll
      for (int j = 0; j < DJ; ++j) kv[j] = to_float(sm.sK[kk * LD + lane + 32 * j]);
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const float ds = sm.sDP[(8 * warp + r) * kBwdBK + kk];
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[r][j] = fmaf(ds, kv[j], acc[r][j]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int t = q0 + 8 * warp + r;
    if (t < Tlen) {
      T* row = dq + base + (long long)t * row_stride;
#pragma unroll
      for (int j = 0; j < DJ; ++j) row[lane + 32 * j] = from_float<T>(acc[r][j]);
    }
  }
}

template <typename T, int DJ, bool DROP>
__global__ void __launch_bounds__(kThreads)
attention_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const float* __restrict__ bias,
                         const int* __restrict__ seeds,
                         const float* __restrict__ stats,
                         const T* __restrict__ dout,
                         const float* __restrict__ delta, T* __restrict__ dk,
                         T* __restrict__ dv, int Tlen, int H, float scale,
                         uint32_t thresh, float inv_keep) {
  constexpr int D = DJ * 32;
  constexpr int LD = BwdSmem<T, D>::LD;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const BwdSmem<T, D> sm(smem_raw);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int k0 = blockIdx.x * kBwdBK;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const long long row_stride = (long long)H * D;
  const long long base = ((long long)b * Tlen) * row_stride + (long long)h * D;
  const long long stat_row = ((long long)b * H + h) * Tlen;
  const long long stat_plane = (long long)gridDim.z * H * Tlen;
  const uint32_t key = DROP ? dropout_key(seeds[b], h) : 0u;

  load_rows<T, D, LD>(sm.sK, k, base, row_stride, k0, kBwdBK, Tlen, tid);
  load_rows<T, D, LD>(sm.sV, v, base, row_stride, k0, kBwdBK, Tlen, tid);
  if (tid < kBwdBK) {
    const int t = k0 + tid;
    sm.sBias[tid] = t < Tlen ? bias[(long long)b * Tlen + t] : 0.f;
  }

  // warp w owns key rows 4w .. 4w+3, lane owns depth lane + 32 j
  float acc_k[4][DJ], acc_v[4][DJ];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc_k[r][j] = acc_v[r][j] = 0.f;

  for (int q0 = 0; q0 < Tlen; q0 += kBwdBQ) {
    __syncthreads();  // the previous tile's sQ, sDO, sS, sDP are no longer read
    load_rows<T, D, LD>(sm.sQ, q, base, row_stride, q0, kBwdBQ, Tlen, tid);
    load_rows<T, D, LD>(sm.sDO, dout, base, row_stride, q0, kBwdBQ, Tlen, tid);
    if (tid < kBwdBQ) {
      const int t = q0 + tid;
      const bool ok = t < Tlen;
      sm.sM[tid] = ok ? stats[stat_row + t] : 0.f;
      sm.sL[tid] = ok ? stats[stat_plane + stat_row + t] : 1.f;
      sm.sDelta[tid] = ok ? delta[stat_row + t] : 0.f;
    }
    __syncthreads();
    tile_probs_and_ds<T, D, DROP, false>(sm, q0, k0, Tlen, scale, key, thresh,
                                         inv_keep, tid);
    // dV += P_d^T dO ; dK += dS^T Q
#pragma unroll 2
    for (int qq = 0; qq < kBwdBQ; ++qq) {
      float gv[DJ], qv[DJ];
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        gv[j] = to_float(sm.sDO[qq * LD + lane + 32 * j]);
        qv[j] = to_float(sm.sQ[qq * LD + lane + 32 * j]);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float pd = sm.sS[qq * kBwdBK + 4 * warp + r];
        const float ds = sm.sDP[qq * kBwdBK + 4 * warp + r];
#pragma unroll
        for (int j = 0; j < DJ; ++j) {
          acc_v[r][j] = fmaf(pd, gv[j], acc_v[r][j]);
          acc_k[r][j] = fmaf(ds, qv[j], acc_k[r][j]);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int t = k0 + 4 * warp + r;
    if (t < Tlen) {
      T* krow = dk + base + (long long)t * row_stride;
      T* vrow = dv + base + (long long)t * row_stride;
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        krow[lane + 32 * j] = from_float<T>(acc_k[r][j]);
        vrow[lane + 32 * j] = from_float<T>(acc_v[r][j]);
      }
    }
  }
}

struct BwdArgs {
  const void *q, *k, *v;
  const float* bias;
  const int* seeds;
  const float* stats;
  const void* dout;
  void *dq, *dk, *dv;
  float* delta;
  int B, T, H;
  uint32_t thresh;
  float inv_keep;
  cudaStream_t stream;
};

template <typename T, int DJ, bool DROP>
int launch_attention_bwd(const BwdArgs& a) {
  constexpr int D = DJ * 32;
  const size_t smem = attn_bwd_smem_bytes<T>(D);
  if (smem > (size_t)kMaxSmemBytes) return kErrSharedMemory;
  auto dq_kern = attention_bwd_dq_kernel<T, DJ, DROP>;
  auto dkv_kern = attention_bwd_dkv_kernel<T, DJ, DROP>;
  cudaError_t err = cudaFuncSetAttribute(
      dq_kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(
      dkv_kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const float scale = 1.0f / sqrtf((float)D);
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* dout = static_cast<const T*>(a.dout);
  dim3 grid_q((a.T + kBwdBQ - 1) / kBwdBQ, a.H, a.B);
  dq_kern<<<grid_q, kThreads, smem, a.stream>>>(
      q, k, v, a.bias, a.seeds, a.stats, dout, static_cast<T*>(a.dq), a.delta, a.T, a.H, scale, a.thresh, a.inv_keep);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // reads the delta the first kernel wrote: same stream, so ordered after it
  dim3 grid_k((a.T + kBwdBK - 1) / kBwdBK, a.H, a.B);
  dkv_kern<<<grid_k, kThreads, smem, a.stream>>>(
      q, k, v, a.bias, a.seeds, a.stats, dout, a.delta, static_cast<T*>(a.dk),
      static_cast<T*>(a.dv), a.T, a.H, scale, a.thresh, a.inv_keep);
  return (int)cudaGetLastError();
}

template <typename T, bool DROP>
int dispatch_attention_bwd(const BwdArgs& a, int D) {
  switch (D) {
    case 32: return launch_attention_bwd<T, 1, DROP>(a);
    case 64: return launch_attention_bwd<T, 2, DROP>(a);
    case 96: return launch_attention_bwd<T, 3, DROP>(a);
    case 128: return launch_attention_bwd<T, 4, DROP>(a);
    case 192: return launch_attention_bwd<T, 6, DROP>(a);
    case 256: return launch_attention_bwd<T, 8, DROP>(a);
    default: return kErrUnsupportedShape;
  }
}


// ---------------------------------------------------------------------------
// bf16 on the tensor cores
// ---------------------------------------------------------------------------

template <int D>
struct BwdQTc {
  static constexpr int DP = TcWidth<D>::DP;
  static constexpr int NB = TcWidth<D>::NB;
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

template <int D, bool DROP>
__global__ void __launch_bounds__(BwdQTc<D>::THREADS, 1)
attention_bwd_dq_tc_kernel(const __grid_constant__ CUtensorMap tm_q,
                           const __grid_constant__ CUtensorMap tm_k,
                           const __grid_constant__ CUtensorMap tm_v,
                           const __grid_constant__ CUtensorMap tm_do,
                           const float* __restrict__ bias,
                           const int* __restrict__ seeds,
                           const float* __restrict__ stats,
                           __nv_bfloat16* __restrict__ dq,
                           float* __restrict__ delta_out, int Tlen, int H,
                           float scale, uint32_t thresh, float inv_keep) {
  using C = BwdQTc<D>;
  constexpr int NS = C::BK / 2;  // accumulator registers of an S tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = wg::align_1024(smem_raw);
  const uint32_t sQ = wg::smem_addr(smem);
  const uint32_t sDO = sQ + C::Q_BYTES;
  const uint32_t sKV = sDO + C::Q_BYTES;
  const float* sBias = reinterpret_cast<const float*>(smem + C::BIAS);
  const uint32_t sBiasAddr = sQ + C::BIAS;
  const uint32_t bar = sQ + C::BARS;  // stage s: bar + 8 s

  const int tid = threadIdx.x;
  const int wgi = tid >> 7;
  const int warp = (tid >> 5) & 3;
  const int g = (tid & 31) >> 2, c = tid & 3;
  const int q0 = blockIdx.x * C::BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const long long row_stride = (long long)H * D;
  const long long base = (long long)b * Tlen * row_stride + (long long)h * D;
  const long long stat_row = ((long long)b * H + h) * Tlen;
  const long long stat_plane = (long long)gridDim.z * H * Tlen;
  const float* bias_b = bias + (long long)b * Tlen;
  const int nkt = (Tlen + C::BK - 1) / C::BK;
  const int row0 = q0 + 64 * wgi + 16 * warp + g;  // rows row0, row0 + 8
  const uint32_t sQw = sQ + wgi * 64 * 128, sDOw = sDO + wgi * 64 * 128;
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
  load_kv(0, 0, 2 * C::Q_BYTES);
  if (tid == 0) {
    tma_tile<D, C::BQ>(sQ, tm_q, bar, h, q0, b);
    tma_tile<D, C::BQ>(sDO, tm_do, bar, h, q0, b);
  }

  float m[2], inv_l[2], dsum[2] = {0.f, 0.f}, delta[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int t = row0 + 8 * r;
    m[r] = t < Tlen ? stats[stat_row + t] : 0.f;
    // a row beyond T gets 1 / l = 0, hence P = 0
    inv_l[r] = t < Tlen ? 1.f / stats[stat_plane + stat_row + t] : 0.f;
  }
  float acc[C::NB][32];
  float sc[NS], dp[NS];
#pragma unroll
  for (int i = 0; i < NS; ++i) sc[i] = dp[i] = 0.f;
#pragma unroll
  for (int n = 0; n < C::NB; ++n)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[n][i] = 0.f;

  // sweep 0 (it < nkt): rowsum(dP * P); sweep 1: dQ.  Iteration `it` uses
  // stage it % 2 for the (it / 2)-th time.
  for (int it = 0; it < 2 * nkt; ++it) {
    const int s = it & 1;
    const bool second = it >= nkt;
    const int k0 = (second ? it - nkt : it) * C::BK;
    wg::mbar_wait(bar + 8 * s, (it >> 1) & 1);
    wg::cp_async_wait<0>();
    __syncthreads();
    if (it + 1 < 2 * nkt) load_kv(it + 1 < nkt ? it + 1 : it + 1 - nkt, s ^ 1, 0);
    if (it == nkt) {
      // the four lanes of a row add their shares in a fixed order
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        dsum[r] += __shfl_xor_sync(0xffffffffu, dsum[r], 1);
        dsum[r] += __shfl_xor_sync(0xffffffffu, dsum[r], 2);
        delta[r] = dsum[r];
        const int t = row0 + 8 * r;
        if (c == 0 && t < Tlen) delta_out[stat_row + t] = delta[r];
      }
    }
    const uint32_t sK = sKV + 2 * s * C::KV_BYTES, sV = sK + C::KV_BYTES;

    // S = Q K^T, dP_d = dO V^T
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
    uint32_t da[C::BK / 16][4];  // dS, the A fragments of dQ += dS K
#pragma unroll
    for (int i = 0; i < C::BK / 8; ++i)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        uint4 w = make_uint4(0u, 0u, 0u, 0u);
        if constexpr (DROP)
          w = dropout_bits(key, (uint32_t)(row0 + 8 * r),
                           (uint32_t)((k0 >> 2) + 2 * i + (c >> 1)));
        float ds[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = 8 * i + 2 * c + e;
          const int idx = 4 * i + 2 * r + e;
          const float sv = __fadd_rn(__fmul_rn(sc[idx], scale), sBias[s * C::BK + col]);
          float p = round_bf16_alu(__expf(sv - m[r]) * inv_l[r]);
          if (!full && k0 + col >= Tlen) p = 0.f;
          float dpv = dp[idx];
          if constexpr (DROP) {
            const uint32_t word = (c & 1) ? (e ? w.w : w.z) : (e ? w.y : w.x);
            dpv = word >= thresh ? dpv * inv_keep : 0.f;
          }
          if (second)
            ds[e] = (p * (dpv - delta[r])) * scale;  // rounded by the packing
          else
            dsum[r] = fmaf(dpv, p, dsum[r]);
        }
        if (second) da[i >> 1][2 * (i & 1) + r] = wg::pack_bf16(ds[0], ds[1]);
      }

    if (second) {
      // dQ += dS K
      wg::fence();
#pragma unroll
      for (int kk = 0; kk < C::BK / 16; ++kk)
#pragma unroll
        for (int n = 0; n < C::NB; ++n)
          wg::mma_rs(acc[n], da[kk], wg::desc_mn(sK, C::BK, kk, n), 1);
      wg::commit();
      wg::wait<0>();
#pragma unroll
      for (int n = 0; n < C::NB; ++n) wg::fence_regs(acc[n]);
#pragma unroll
      for (int kk = 0; kk < C::BK / 16; ++kk) wg::fence_regs(da[kk]);
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int t = row0 + 8 * r;
    if (t < Tlen) {
      __nv_bfloat16* row = dq + base + (long long)t * row_stride;
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

template <int D>
struct BwdKVTc {
  static constexpr int DP = TcWidth<D>::DP;
  static constexpr int NB = TcWidth<D>::NB;
  static constexpr int BKEY = 64;  // keys per block: the rows of every product
  static constexpr int BQ = 64;    // queries per tile
  static constexpr int THREADS = 256;
  static constexpr int TILE = 64 * DP * 2;  // one 64-row bf16 tile
  // K, V; Q of stage 0, 1; dO of stage 0, 1 (in tiles); P^T as bf16 pairs
  // (64 x 64, register-major); m, l (then 1 / l), delta of both stages; the
  // copy barriers (K and V, then each stage)
  static constexpr int PSCRATCH = 6 * TILE;
  static constexpr int STATS = PSCRATCH + 64 * 64 * 2;
  static constexpr int BARS = STATS + 2 * 3 * BQ * 4;
  static constexpr int SMEM = 1024 + BARS + 3 * 8;
};

template <int D, bool DROP>
__global__ void __launch_bounds__(BwdKVTc<D>::THREADS, 1)
attention_bwd_dkv_tc_kernel(const __grid_constant__ CUtensorMap tm_q,
                            const __grid_constant__ CUtensorMap tm_k,
                            const __grid_constant__ CUtensorMap tm_v,
                            const __grid_constant__ CUtensorMap tm_do,
                            const float* __restrict__ bias,
                            const int* __restrict__ seeds,
                            const float* __restrict__ stats,
                            const float* __restrict__ delta,
                            __nv_bfloat16* __restrict__ dk,
                            __nv_bfloat16* __restrict__ dv, int Tlen, int H,
                            float scale, uint32_t thresh, float inv_keep) {
  using C = BwdKVTc<D>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = wg::align_1024(smem_raw);
  const uint32_t s0 = wg::smem_addr(smem);
  const uint32_t sK = s0, sV = s0 + C::TILE;
  uint32_t* pscratch = reinterpret_cast<uint32_t*>(smem + C::PSCRATCH);
  float* sStats = reinterpret_cast<float*>(smem + C::STATS);
  const uint32_t sStatsAddr = s0 + C::STATS;
  const uint32_t bar_kv = s0 + C::BARS, bar = bar_kv + 8;  // stage s: bar + 8 s

  const int tid = threadIdx.x;
  const int wgi = tid >> 7;  // 0: S^T, P^T, dV; 1: dP^T, dS^T, dK
  const int t128 = tid & 127;
  const int warp = (tid >> 5) & 3;
  const int g = (tid & 31) >> 2, c = tid & 3;
  const int key0 = blockIdx.x * C::BKEY;
  const int h = blockIdx.y, b = blockIdx.z;
  const long long row_stride = (long long)H * D;
  const long long base = (long long)b * Tlen * row_stride + (long long)h * D;
  const long long stat_row = ((long long)b * H + h) * Tlen;
  const long long stat_plane = (long long)gridDim.z * H * Tlen;
  const int nqt = (Tlen + C::BQ - 1) / C::BQ;
  const int lrow = 16 * warp + g;  // this thread's key rows: lrow, lrow + 8
  const uint32_t key = DROP ? dropout_key(seeds[b], h) : 0u;

  // Q, dO of tile j into stage s by TMA (thread 0), its queries' m, l, delta
  // by cp.async; stage s: Q at tile 2 + s, dO at tile 4 + s; m, l, delta at
  // 3s, 3s+1, 3s+2 (in BQ floats)
  auto load_q = [&](int j, int s) {
    const int t0 = j * C::BQ;
    if (tid == 0) {
      wg::mbar_expect_tx(bar + 8 * s, 2 * C::TILE);
      tma_tile<D, C::BQ>(s0 + (2 + s) * C::TILE, tm_q, bar + 8 * s, h, t0, b);
      tma_tile<D, C::BQ>(s0 + (4 + s) * C::TILE, tm_do, bar + 8 * s, h, t0, b);
    }
    if (tid < 3 * C::BQ) {
      const int which = tid / C::BQ, qq = tid - which * C::BQ;
      const int t = t0 + qq;
      const float* src = which == 0 ? stats + stat_row
                         : which == 1 ? stats + stat_plane + stat_row
                                      : delta + stat_row;
      wg::cp_async4(sStatsAddr + ((3 * s + which) * C::BQ + qq) * 4,
                    src + (t < Tlen ? t : 0), t < Tlen);
    }
    wg::cp_async_commit();
  };

  if (tid == 0) {
    wg::mbar_init(bar_kv, 1);
    wg::mbar_init(bar, 1);
    wg::mbar_init(bar + 8, 1);
    wg::mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0) {
    wg::mbar_expect_tx(bar_kv, 2 * C::TILE);
    tma_tile<D, C::BKEY>(sK, tm_k, bar_kv, h, key0, b);
    tma_tile<D, C::BKEY>(sV, tm_v, bar_kv, h, key0, b);
  }
  load_q(0, 0);

  // a key beyond T gets bias -inf, hence P = 0 in every column
  float bk[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int t = key0 + lrow + 8 * r;
    bk[r] = t < Tlen ? bias[(long long)b * Tlen + t] : -INFINITY;
  }
  float acc[C::NB][32];  // dV (warpgroup 0) or dK (warpgroup 1)
  float sc[32];          // S^T (warpgroup 0) or dP_d^T (warpgroup 1)
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    sc[i] = 0.f;
#pragma unroll
    for (int n = 0; n < C::NB; ++n) acc[n][i] = 0.f;
  }
  wg::mbar_wait(bar_kv, 0);

  for (int j = 0; j < nqt; ++j) {
    const int s = j & 1;
    const int q0 = j * C::BQ;
    wg::mbar_wait(bar + 8 * s, (j >> 1) & 1);
    wg::cp_async_wait<0>();
    __syncthreads();
    if (j + 1 < nqt) load_q(j + 1, s ^ 1);
    const uint32_t sQs = s0 + (2 + s) * C::TILE, sDOs = s0 + (4 + s) * C::TILE;
    float* st = sStats + 3 * s * C::BQ;  // m, l, delta of the tile's queries
    // only the last tile has query slots beyond T (their statistics are 0)
    const bool full = q0 + C::BQ <= Tlen;
    uint32_t fa[4][4];  // A fragments: P_d^T (warpgroup 0) or dS^T (1)

    if (wgi == 0) {
      // S^T = K Q^T
      wg::fence();
#pragma unroll
      for (int kk = 0; kk < C::DP / 16; ++kk)
        wg::mma_ss(sc, wg::desc_k(sK, C::BKEY, kk),
                          wg::desc_k(sQs, C::BQ, kk), kk > 0);
      wg::commit();
      wg::wait<0>();
      wg::fence_regs(sc);
      wg::barrier_sync(2, 256);  // l has become 1 / l
      // P^T and P_d^T; P^T goes to warpgroup 1 as bf16 pairs, a dropped entry
      // with its sign bit set (P >= 0, so the sign carries the mask)
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float pv[2], pd[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = 8 * i + 2 * c + e;  // query q0 + col
            const float sv = __fadd_rn(__fmul_rn(sc[4 * i + 2 * r + e], scale), bk[r]);
            float p = __expf(sv - st[col]) * st[C::BQ + col];
            if (!full && q0 + col >= Tlen) p = 0.f;
            pv[e] = p;
            pd[e] = p;
            if constexpr (DROP) {
              // key kr is word kr % 4 = g % 4 of group kr / 4
              const int kr = key0 + lrow + 8 * r;
              const uint4 w = dropout_bits(key, (uint32_t)(q0 + col), (uint32_t)(kr >> 2));
              const int word = g & 3;
              const uint32_t bits = word == 0 ? w.x : word == 1 ? w.y : word == 2 ? w.z : w.w;
              const bool keep = bits >= thresh;
              p = round_bf16_alu(p);
              pd[e] = keep ? p * inv_keep : 0.f;  // rounded by the packing
              pv[e] = keep ? p : -p;
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
#pragma unroll
        for (int n = 0; n < C::NB; ++n)
          wg::mma_rs(acc[n], fa[kk], wg::desc_mn(sDOs, C::BQ, kk, n), 1);
      wg::commit();
      wg::wait<0>();
    } else {
      // dP_d^T = V dO^T; while it runs, l becomes 1 / l for warpgroup 0
      wg::fence();
#pragma unroll
      for (int kk = 0; kk < C::DP / 16; ++kk)
        wg::mma_ss(sc, wg::desc_k(sV, C::BKEY, kk),
                          wg::desc_k(sDOs, C::BQ, kk), kk > 0);
      wg::commit();
      if (t128 < C::BQ) st[C::BQ + t128] = 1.f / st[C::BQ + t128];
      wg::barrier_arrive(2, 256);
      wg::wait<0>();
      wg::fence_regs(sc);
      wg::barrier_sync(1, 256);
      // dS^T = P^T (dP^T - delta) * scale, dP^T taken back through dropout
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
          fa[i >> 1][2 * (i & 1) + r] = wg::pack_bf16(ds[0], ds[1]);
        }

      // dK += dS^T Q
      wg::fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int n = 0; n < C::NB; ++n)
          wg::mma_rs(acc[n], fa[kk], wg::desc_mn(sQs, C::BQ, kk, n), 1);
      wg::commit();
      wg::wait<0>();
    }
#pragma unroll
    for (int n = 0; n < C::NB; ++n) wg::fence_regs(acc[n]);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wg::fence_regs(fa[kk]);
  }

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

// static: each library keeps its own record of the attribute it set
template <int D, bool DROP>
static int launch_attention_bwd_tc(const BwdArgs& a) {
  using CQ = BwdQTc<D>;
  using CK = BwdKVTc<D>;
  static_assert(CQ::SMEM <= kMaxSmemBytes && CK::SMEM <= kMaxSmemBytes,
                "backward tiles do not fit");
  auto dq_kern = attention_bwd_dq_tc_kernel<D, DROP>;
  auto dkv_kern = attention_bwd_dkv_tc_kernel<D, DROP>;
  static std::atomic<unsigned long long> dq_smem_set{0}, dkv_smem_set{0};
  cudaError_t err = set_max_dynamic_smem(dq_kern, CQ::SMEM, dq_smem_set);
  if (err != cudaSuccess) return (int)err;
  err = set_max_dynamic_smem(dkv_kern, CK::SMEM, dkv_smem_set);
  if (err != cudaSuccess) return (int)err;
  // tensor maps: 128-row tiles of Q and dO and key tiles for the dq kernel,
  // 64-row tiles of all four for the dkv kernel
  CUtensorMap q128, do128, kq, vq, q64, k64, v64, do64;
  const int B = a.B, T = a.T, H = a.H;
  if (int e = tile_map(&q128, a.q, B, T, H, D, CQ::BQ)) return e;
  if (int e = tile_map(&do128, a.dout, B, T, H, D, CQ::BQ)) return e;
  if (int e = tile_map(&kq, a.k, B, T, H, D, CQ::BK)) return e;
  if (int e = tile_map(&vq, a.v, B, T, H, D, CQ::BK)) return e;
  if (int e = tile_map(&q64, a.q, B, T, H, D, 64)) return e;
  if (int e = tile_map(&do64, a.dout, B, T, H, D, 64)) return e;
  if (int e = tile_map(&k64, a.k, B, T, H, D, 64)) return e;
  if (int e = tile_map(&v64, a.v, B, T, H, D, 64)) return e;
  const float scale = 1.0f / sqrtf((float)D);
  using bf = __nv_bfloat16;
  dim3 grid_q((T + CQ::BQ - 1) / CQ::BQ, H, B);
  dq_kern<<<grid_q, CQ::THREADS, CQ::SMEM, a.stream>>>(
      q128, kq, vq, do128, a.bias, a.seeds, a.stats, static_cast<bf*>(a.dq),
      a.delta, T, H, scale, a.thresh, a.inv_keep);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // reads the delta the first kernel wrote: same stream, so ordered after it
  dim3 grid_k((T + CK::BKEY - 1) / CK::BKEY, H, B);
  dkv_kern<<<grid_k, CK::THREADS, CK::SMEM, a.stream>>>(
      q64, k64, v64, do64, a.bias, a.seeds, a.stats, a.delta,
      static_cast<bf*>(a.dk), static_cast<bf*>(a.dv), T, H, scale, a.thresh,
      a.inv_keep);
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

}  // namespace emotts

// q, k, v, dout, dq, dk, dv: contiguous (B, T, H, D) in fp32
// (is_bf16 = 0) or bf16 (1, 16-byte aligned); bias (B, T) fp32; stats
// (2, B, H, T) fp32 as the forward kernel wrote them; delta (B, H, T) fp32
// scratch; seeds (B,) int32 (may be null when drop == 0).  D in {32, 64, 96,
// 128, 192, 256}.  Two launches on `stream`, no synchronisation; returns 0 or
// an error code.
extern "C" int emotts_attention_bwd(
    const void* q, const void* k, const void* v, const float* bias,
    const int* seeds, const float* stats, const void* dout,
    void* dq, void* dk, void* dv, float* delta, int B, int T, int H, int D,
    int is_bf16, int drop, unsigned int thresh, float inv_keep, void* stream) {
  if (B <= 0 || T <= 0 || H <= 0 || H > 65535 || B > 65535)
    return emotts::kErrUnsupportedShape;
  if (drop && seeds == nullptr) return emotts::kErrUnsupportedShape;
  const emotts::BwdArgs a{q, k, v, bias, seeds, stats, dout, dq, dk, dv,
                          delta, B, T, H, thresh, inv_keep,
                          static_cast<cudaStream_t>(stream)};
  if (is_bf16) {
    if (!emotts::aligned16({q, k, v, dout, dq, dk, dv}))
      return emotts::kErrMisaligned;
    return drop ? emotts::dispatch_attention_bwd_tc<true>(a, D)
                : emotts::dispatch_attention_bwd_tc<false>(a, D);
  }
  return drop ? emotts::dispatch_attention_bwd<float, true>(a, D)
              : emotts::dispatch_attention_bwd<float, false>(a, D);
}
