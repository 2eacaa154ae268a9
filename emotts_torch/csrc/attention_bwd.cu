// Fused self-attention backward for the FFT blocks (training).
//
// Replaces the Pallas kernel `_bwd_kernel` of emotts/ops/attention.py
// (reached through the custom VJP of `fused_attention`).  Per (batch, head),
// with P the softmax of S = Q K^T / sqrt(D) + bias cast to the compute type
// and P_d = keep ? P / (1 - rate) : 0 its dropped-out form:
//   dV   = P_d^T dO
//   dP_d = dO V^T ;  dP = keep ? dP_d / (1 - rate) : 0
//   dS   = P * (dP - rowsum(dP * P)) * scale      (fp32, then cast)
//   dQ   = dS K ;  dK = dS^T Q
// All five products accumulate in fp32; P enters P_d^T dO and dS enters its
// two products in the compute type, as in the reference.
//
// The TPU kernel recomputes a whole (T, T) probability block on chip from q,
// k and the bias.  A Hopper block has 227 KB, so this one tiles, and a tile
// of P needs each query row's softmax maximum and sum before it can be
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
// Two reduction directions, and no atomics, so that a repeated call gives
// the same bits:
//   attention_bwd_dq_kernel    one block per 64 queries; a first loop over
//                              the key tiles sums rowsum(dP * P) and stores
//                              it (`delta`) for the second kernel, a second
//                              loop accumulates dQ;
//   attention_bwd_dkv_kernel   one block per 32 keys, loops over query tiles.
// Every loop recomputes S and dP_d for its tile pairs, so the design does
// nine T x T x D products where the algorithm has five (18 against
// 10 * B*H*T^2*D operations).  The dropout mask is regenerated from (seed,
// head, query, key) exactly as in the forward kernel (attention_common.cuh).
//
// Padding: the bias is additive -1e9, so a padded key has P = 0 exactly and
// a fully padded query row has uniform P and a finite gradient, as in the
// reference.  Query and key slots beyond T in a last tile are given P = 0,
// so they add nothing to rows that exist, and are never written.
//
// Shared memory at D = 192: Q, dO (64 rows) and K, V (32 rows) tiles plus two
// 64 x 32 fp32 tiles are 164 KB with fp32 inputs and 91 KB with bf16.
//
// Bound on this card: 10*B*H*T^2*D operations against (4 reads + 3 writes)
// *B*T*H*D*itemsize + statistics bytes: operations dominate from T of a few
// hundred on.  Like the forward kernel this version multiplies on the fp32
// FMA units; tensor cores are the next step and change no interface.
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

}  // namespace emotts

// q, k, v, dout, dq, dk, dv: contiguous (B, T, H, D) in fp32
// (is_bf16 = 0) or bf16 (1); bias (B, T) fp32; stats (2, B, H, T) fp32 as the
// forward kernel wrote them; delta (B, H, T) fp32 scratch; seeds (B,) int32
// (may be null when drop == 0).  D in {32, 64, 96, 128, 192, 256}.
// Two launches on `stream`, no synchronisation; returns 0 or an error code.
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
  if (is_bf16)
    return drop ? emotts::dispatch_attention_bwd<__nv_bfloat16, true>(a, D)
                : emotts::dispatch_attention_bwd<__nv_bfloat16, false>(a, D);
  return drop ? emotts::dispatch_attention_bwd<float, true>(a, D)
              : emotts::dispatch_attention_bwd<float, false>(a, D);
}
