// Fused self-attention forward for the FFT blocks, with dropout on the
// probabilities for training (rate 0 compiles to the kernel without it).
//
// Replaces the Pallas kernel `_fwd_kernel` of emotts/ops/attention.py
// (reached through `fused_attention`): per (batch, head)
//   S = Q K^T / sqrt(D) + bias[key]     (bias is additive: 0 valid, -1e9 pad)
//   P = softmax(S) in fp32, cast to the compute type
//   P = keep ? P / (1 - rate) : 0       (training only; rounded to the type)
//   O = P V with fp32 accumulation, cast to the compute type.
//
// The TPU kernel keeps the whole (T, T) score block in on-chip memory.  At
// T = 1024 that block is 4 MB in fp32 and a Hopper block has 227 KB, so this
// kernel tiles: one block per (batch, head, 64-query tile) walks over 64-key
// tiles with an online softmax (running row maximum and row sum in fp32).
// Nothing of size T x T reaches device memory.
//
// Layout: q, k, v, out are contiguous (B, T, H, D), the module's own layout,
// read with strides — the two transposes of the TPU wrapper are not needed.
//
// The bias is additive and finite on purpose: a row whose keys are all padded
// has every score rounded to -1e9 in fp32 and comes out as the uniform mean of
// V, exactly as in the reference.  So padded key tiles are never skipped and
// -inf is used only for key slots beyond T in the last tile.
//
// Rounding: with bf16 inputs the reference rounds the normalised P to bf16
// before P V; an online softmax has no normalised P until the end, so the
// un-normalised exp(s - m) is rounded instead (the row sum stays fp32 and
// un-rounded).  The two differ by at most one bf16 rounding of each
// probability; in fp32 nothing is rounded and the results agree to ~1e-6.
//
// Dropout.  The keep-mask is a pure function of (seed[b], head, query, key):
// Philox4x32-10 keyed by the reference's per-(example, head) mix of the seed,
// counter (query, key / 4), word key % 4, kept where the word >= rate * 2^32.
// The backward kernel (attention_bwd.cu) walks the tiles in another order and
// regenerates the same bits.  The TPU kernel draws from that chip's own
// generator, so the bits differ from the reference's; the plain PyTorch
// version computes the same Philox bits and is compared value for value.
// A dropped entry still counts in the softmax row sum: dropping the
// un-normalised exp(s - m) and dividing by the full sum at the end equals
// dropping the normalised probability.
//
// For the backward pass the kernel can also write each query row's running
// maximum and sum (`stats`, (2, B, H, T) fp32), from which the backward
// kernels form P tile by tile without a pass of their own.  Two numbers, not
// their log-sum-exp: a fully padded row has maximum -1e9, and -1e9 + log(T)
// is not representable in fp32.
//
// Bound on this card: 4*B*H*T^2*D operations against 2*4*B*T*H*D*itemsize
// bytes — operations dominate from T of a few hundred on.  This version
// multiplies on the fp32 FMA units (operands widened from bf16, which is
// exact), a long way below the tensor-core rate; moving both products to
// `wgmma` is the next step and changes no interface.
#include "attention_common.cuh"

#include <math.h>

namespace emotts {

constexpr int kBQ = 64;  // queries per block
constexpr int kBK = 64;  // keys per tile

template <typename T>
size_t attn_smem_bytes(int D) {
  const int ld = D + attn_row_pad<T>();
  return (size_t)(kBQ * ld + kBK * ld + kBK * D) * sizeof(T) +
         (size_t)(kBQ * kBK + kBK) * sizeof(float);
}

template <typename T, int DJ, bool DROP>
__global__ void __launch_bounds__(kThreads)
attention_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const float* __restrict__ bias,
                     const int* __restrict__ seeds, T* __restrict__ out,
                     float* __restrict__ stats, int Tlen, int H, float scale,
                     uint32_t thresh, float inv_keep) {
  constexpr int D = DJ * 32;
  constexpr int LD = D + attn_row_pad<T>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sQ = reinterpret_cast<T*>(smem_raw);        // kBQ x LD
  T* sK = sQ + kBQ * LD;                         // kBK x LD
  T* sV = sK + kBK * LD;                         // kBK x D
  float* sS = reinterpret_cast<float*>(sV + kBK * D);  // kBQ x kBK
  float* sBias = sS + kBQ * kBK;                 // kBK

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const long long row_stride = (long long)H * D;
  const long long base = ((long long)b * Tlen) * row_stride + (long long)h * D;

  // Q tile (rows beyond T are zero and never written back)
  for (int e = tid; e < kBQ * D; e += kThreads) {
    const int r = e / D, d = e - r * D;
    const int t = q0 + r;
    sQ[r * LD + d] = t < Tlen ? q[base + (long long)t * row_stride + d]
                              : from_float<T>(0.f);
  }

  // phase-1 mapping: 16 x 16 threads, each a 4 x 4 patch of the score tile
  const int tx = tid & 15;
  const int ty = tid >> 4;
  // phase-2/3 mapping: warp w owns query rows 8w .. 8w+7, lane owns depth
  // lane + 32 j
  float m_run[8], l_run[8], acc[8][DJ];
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    m_run[r] = -INFINITY;
    l_run[r] = 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[r][j] = 0.f;
  }

  for (int k0 = 0; k0 < Tlen; k0 += kBK) {
    __syncthreads();  // the previous tile's sK, sV, sS are no longer read
    for (int e = tid; e < kBK * D; e += kThreads) {
      const int r = e / D, d = e - r * D;
      const int t = k0 + r;
      const bool ok = t < Tlen;
      const long long g = base + (long long)t * row_stride + d;
      sK[r * LD + d] = ok ? k[g] : from_float<T>(0.f);
      sV[r * D + d] = ok ? v[g] : from_float<T>(0.f);
    }
    if (tid < kBK) {
      const int t = k0 + tid;
      sBias[tid] = t < Tlen ? bias[(long long)b * Tlen + t] : 0.f;
    }
    __syncthreads();

    // ---- phase 1: S = Q K^T * scale + bias --------------------------------
    {
      float s[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        float qv[4], kv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) qv[i] = to_float(sQ[(4 * ty + i) * LD + d]);
#pragma unroll
        for (int j = 0; j < 4; ++j) kv[j] = to_float(sK[(tx + 16 * j) * LD + d]);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kk = tx + 16 * j;
        const bool ok = (k0 + kk) < Tlen;
        const float bj = sBias[kk];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          // same order as the reference: (dot * scale) + bias
          const float sv = s[i][j] * scale + bj;
          sS[(4 * ty + i) * kBK + kk] = ok ? sv : -INFINITY;
        }
      }
    }
    __syncthreads();

    // ---- phase 2: online softmax on this warp's 8 rows ---------------------
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      float* srow = sS + (8 * warp + r) * kBK;
      const float s0 = srow[lane];
      const float s1 = srow[lane + 32];
      float mx = fmaxf(s0, s1);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      // key 0 of the first tile is always inside T and every bias is finite,
      // so m_new is finite from the first tile on
      const float m_new = fmaxf(m_run[r], mx);
      const float alpha = expf(m_run[r] - m_new);
      const float p0 = expf(s0 - m_new);
      const float p1 = expf(s1 - m_new);
      float sum = p0 + p1;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      l_run[r] = l_run[r] * alpha + sum;
      m_run[r] = m_new;
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[r][j] *= alpha;
      // probabilities enter P V in the compute type
      srow[lane] = to_float(from_float<T>(p0));
      srow[lane + 32] = to_float(from_float<T>(p1));
    }
    if constexpr (DROP) {
      // this warp's 8 rows x 64 keys are 128 groups of 4 keys, 4 per lane
      __syncwarp();
      const uint32_t key = dropout_key(seeds[b], h);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int g = lane + 32 * i;
        const int r = g >> 4, c4 = g & 15;
        const uint4 bits = dropout_bits(key, (uint32_t)(q0 + 8 * warp + r),
                                        (uint32_t)((k0 >> 2) + c4));
        float* p4 = sS + (8 * warp + r) * kBK + 4 * c4;
        // kept values are scaled after the cast to the compute type
        p4[0] = bits.x >= thresh ? to_float(from_float<T>(p4[0] * inv_keep)) : 0.f;
        p4[1] = bits.y >= thresh ? to_float(from_float<T>(p4[1] * inv_keep)) : 0.f;
        p4[2] = bits.z >= thresh ? to_float(from_float<T>(p4[2] * inv_keep)) : 0.f;
        p4[3] = bits.w >= thresh ? to_float(from_float<T>(p4[3] * inv_keep)) : 0.f;
      }
    }
    __syncwarp();

    // ---- phase 3: O += P V --------------------------------------------------
#pragma unroll 2
    for (int kk = 0; kk < kBK; ++kk) {
      float vv[DJ];
#pragma unroll
      for (int j = 0; j < DJ; ++j) vv[j] = to_float(sV[kk * D + lane + 32 * j]);
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const float p = sS[(8 * warp + r) * kBK + kk];
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[r][j] = fmaf(p, vv[j], acc[r][j]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int t = q0 + 8 * warp + r;
    if (t < Tlen) {
      const float inv = 1.f / l_run[r];
      T* orow = out + base + (long long)t * row_stride;
#pragma unroll
      for (int j = 0; j < DJ; ++j)
        orow[lane + 32 * j] = from_float<T>(acc[r][j] * inv);
      if (stats != nullptr && lane == 0) {
        const long long row = ((long long)b * H + h) * Tlen + t;
        stats[row] = m_run[r];
        stats[(long long)gridDim.z * H * Tlen + row] = l_run[r];
      }
    }
  }
}

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

template <typename T, int DJ, bool DROP>
int launch_attention(const FwdArgs& a) {
  constexpr int D = DJ * 32;
  const int B = a.B, Tlen = a.T, H = a.H;
  const size_t smem = attn_smem_bytes<T>(D);
  if (smem > (size_t)kMaxSmemBytes) return kErrSharedMemory;
  auto kern = attention_fwd_kernel<T, DJ, DROP>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Tlen + kBQ - 1) / kBQ, H, B);
  const float scale = 1.0f / sqrtf((float)D);
  kern<<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), a.bias, a.seeds, static_cast<T*>(a.out),
      a.stats, Tlen, H, scale, a.thresh, a.inv_keep);
  return (int)cudaGetLastError();
}

template <typename T, bool DROP>
int dispatch_attention(const FwdArgs& a, int D) {
  switch (D) {
    case 32: return launch_attention<T, 1, DROP>(a);
    case 64: return launch_attention<T, 2, DROP>(a);
    case 96: return launch_attention<T, 3, DROP>(a);
    case 128: return launch_attention<T, 4, DROP>(a);
    case 192: return launch_attention<T, 6, DROP>(a);
    case 256: return launch_attention<T, 8, DROP>(a);
    default: return kErrUnsupportedShape;
  }
}

}  // namespace emotts

// q, k, v, out: contiguous (B, T, H, D) in fp32 (is_bf16 = 0) or bf16 (1);
// bias: contiguous (B, T) fp32.  D in {32, 64, 96, 128, 192, 256}.
// drop != 0 applies dropout: seeds (B,) int32, an entry kept where its random
// word >= thresh and scaled by inv_keep; with drop == 0 seeds may be null.
// stats: null, or (2, B, H, T) fp32 to receive each row's maximum and sum.
// Launches on `stream`, does not synchronise; returns 0 or an error code.
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
  if (is_bf16)
    return drop ? emotts::dispatch_attention<__nv_bfloat16, true>(a, D)
                : emotts::dispatch_attention<__nv_bfloat16, false>(a, D);
  return drop ? emotts::dispatch_attention<float, true>(a, D)
              : emotts::dispatch_attention<float, false>(a, D);
}
