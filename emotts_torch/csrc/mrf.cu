// One whole HiFi-GAN multi-receptive-field (MRF) stage in one kernel.
//
// Replaces the Pallas kernel `_mrf_kernel` of emotts/ops/mrf.py (reached
// through `fused_mrf_stage`): the mean over the stage's ResBlock1s (kernel
// sizes 3, 7, 11) of
//   per dilation d in (1, 3, 5):  x += c2(lrelu(c1(lrelu(x), d))),
// zero outside [0, T) after every conv, fp32 accumulation, values between
// the ops kept in the input type.  Every activation tile is read from device
// memory once per ResBlock (the re-reads hit L2) and the averaged result is
// written once; the 18 intermediates never leave shared memory.
//
// What the TPU version does for its own hardware is dropped: polyphase
// packing of narrow stages into 128 lanes, the 8-row halo rounding, the
// double-buffered halo copy.  What is scarce here instead is shared memory:
// window, intermediate and running mean at C = 128 leave room for a 64-row
// tile beside a 60-row halo a side (emotts_torch/ops/mrf.py::stage_tile), so
// a k = 11 chain computes about 1.9 rows for every row it keeps.  Narrower
// stages take longer tiles and waste less.
//
// Bound on this card: 2*B*T*126*C^2 operations against 2*B*T*C*itemsize
// bytes: operations.  This version runs them as fp32 FMA (see
// resblock_common.cuh); `round_bf16` selects the reference's rounding points
// for bf16 activations, whose weights the caller rounds to bf16 beforehand.
#include "resblock_common.cuh"

namespace emotts {

constexpr int kMaxResBlocks = 4;

struct StageParams {
  int n_rb;
  int k[kMaxResBlocks];
  const float* w1[kMaxResBlocks];
  const float* b1[kMaxResBlocks];
  const float* w2[kMaxResBlocks];
  const float* b2[kMaxResBlocks];
};

template <typename T, int C, bool ROUND>
__global__ void __launch_bounds__(kThreads, 1)
mrf_stage_kernel(const T* __restrict__ x, T* __restrict__ out, StageParams p,
                 DilationList dl, long long t_len, int tile, int halo) {
  extern __shared__ __align__(16) float smem[];
  constexpr int LD = ConvGeom<C>::LD;
  const int n_rows = tile + 2 * halo;
  float* slab = smem;
  float* buf = smem + kSlabFloats;
  float* z = buf + (size_t)n_rows * LD;
  float* avg = z + (size_t)n_rows * LD;  // tile x C

  const long long batch = blockIdx.y;
  const long long t0 = (long long)blockIdx.x * tile;

  for (int rb = 0; rb < p.n_rb; ++rb) {
    const int h = chain_halo(p.k[rb], dl);
    // the previous ResBlock's centre rows have been added to `avg`
    __syncthreads();
    load_window<T, C>(buf, x, batch, t_len, t0 - halo, halo - h, halo + tile + h);
    __syncthreads();
    resblock_chain<C, ROUND>(buf, z, slab, n_rows, halo, tile, t0, t_len,
                             p.w1[rb], p.b1[rb], p.w2[rb], p.b2[rb], p.k[rb], dl);
    for (int e = threadIdx.x; e < tile * C; e += kThreads) {
      const int i = e / C, c = e % C;
      const float v = buf[(halo + i) * LD + c];
      avg[e] = rb == 0 ? v : avg[e] + v;
    }
  }
  __syncthreads();
  const float n = (float)p.n_rb;
  for (int e = threadIdx.x; e < tile * C; e += kThreads) {
    const int i = e / C, c = e % C;
    const long long t = t0 + i;
    if (t < t_len)
      out[(batch * t_len + t) * C + c] = from_float<T>(avg[e] / n);
  }
}

template <typename T, int C, bool ROUND>
int launch_stage(const void* x, void* out, const StageParams& p,
                 const DilationList& dl, int B, long long t_len, int tile,
                 cudaStream_t stream) {
  int halo = 0;
  for (int rb = 0; rb < p.n_rb; ++rb) {
    const int h = chain_halo(p.k[rb], dl);
    halo = h > halo ? h : halo;
  }
  const size_t smem =
      (chain_smem_floats(C, tile, halo) + (size_t)tile * C) * sizeof(float);
  if (smem > (size_t)kMaxSmemBytes) return kErrSharedMemory;
  auto kern = mrf_stage_kernel<T, C, ROUND>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((unsigned)((t_len + tile - 1) / tile), (unsigned)B);
  kern<<<grid, kThreads, smem, stream>>>(static_cast<const T*>(x),
                                         static_cast<T*>(out), p, dl, t_len,
                                         tile, halo);
  return (int)cudaGetLastError();
}

template <typename T, bool ROUND>
int dispatch_stage(int C, const void* x, void* out, const StageParams& p,
                   const DilationList& dl, int B, long long t_len, int tile,
                   cudaStream_t s) {
  switch (C) {
    case 32: return launch_stage<T, 32, ROUND>(x, out, p, dl, B, t_len, tile, s);
    case 64: return launch_stage<T, 64, ROUND>(x, out, p, dl, B, t_len, tile, s);
    case 128: return launch_stage<T, 128, ROUND>(x, out, p, dl, B, t_len, tile, s);
    default: return kErrUnsupportedShape;
  }
}

}  // namespace emotts

// x, out: contiguous (B, T, C), fp32 (is_bf16 = 0) or bf16 (1), out != x.
// weights: host array of 4*n_rb device pointers, per ResBlock (w1, b1, w2,
// b2) with w (n_dil, k, C, C) fp32 in (tap, in, out) order and b (n_dil, C).
// ks: n_rb odd kernel sizes on the host; dils: n_dil ints on the host, the
// same for every ResBlock.  C in {32, 64, 128}.  With bf16 activations the
// rounding points of the reference are repeated and the caller passes
// weights already rounded to bf16 values.  Launches on `stream`, does not
// synchronise; returns 0 or an error code.
extern "C" int emotts_mrf_stage(const void* x, void* out,
                                const void* const* weights, const int* ks,
                                int n_rb, const int* dils, int n_dil, int B,
                                long long T, int C, int tile, int is_bf16,
                                void* stream) {
  using namespace emotts;
  if (n_rb < 1 || n_rb > kMaxResBlocks || n_dil < 1 || n_dil > kMaxDilations ||
      B < 1 || B > 65535 || T < 1 || tile < 1)
    return kErrUnsupportedShape;
  StageParams p;
  p.n_rb = n_rb;
  for (int rb = 0; rb < kMaxResBlocks; ++rb) {
    const bool on = rb < n_rb;
    p.k[rb] = on ? ks[rb] : 1;
    if (on && (ks[rb] < 1 || ks[rb] % 2 == 0)) return kErrUnsupportedShape;
    p.w1[rb] = on ? static_cast<const float*>(weights[4 * rb + 0]) : nullptr;
    p.b1[rb] = on ? static_cast<const float*>(weights[4 * rb + 1]) : nullptr;
    p.w2[rb] = on ? static_cast<const float*>(weights[4 * rb + 2]) : nullptr;
    p.b2[rb] = on ? static_cast<const float*>(weights[4 * rb + 3]) : nullptr;
  }
  DilationList dl;
  dl.n = n_dil;
  for (int j = 0; j < kMaxDilations; ++j) dl.d[j] = j < n_dil ? dils[j] : 1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return dispatch_stage<__nv_bfloat16, true>(C, x, out, p, dl, B, T, tile, s);
  return dispatch_stage<float, false>(C, x, out, p, dl, B, T, tile, s);
}
