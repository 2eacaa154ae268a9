// One whole HiFi-GAN multi-receptive-field (MRF) stage: one launch, or one
// launch per dilation step of each ResBlock.
//
// Replaces the Pallas kernel `_mrf_kernel` of emotts/ops/mrf.py (reached
// through `fused_mrf_stage`): the mean over the stage's ResBlock1s (kernel
// sizes 3, 7, 11) of
//   per dilation d in (1, 3, 5):  x += c2(lrelu(c1(lrelu(x), d))),
// zero outside [0, T) after every conv, fp32 accumulation, values between
// the ops kept in the input type.  In one launch every activation tile is
// read from device memory once per ResBlock (the re-reads hit L2) and the 18
// intermediates never leave shared memory.  The running sum over the
// ResBlocks goes to the block's own rows of an fp32 buffer in device memory
// (`out` itself for fp32), and the mean is written once.
//
// What the TPU version does for its own hardware is dropped: polyphase
// packing of narrow stages into 128 lanes, the 8-row halo rounding, the
// double-buffered halo copy.  What is scarce here instead is shared memory.
// On a long sequence, at C = 32 window and intermediate leave room for a
// 442-row tile beside the 60-row halo a side, and the whole stage is one
// launch (`emotts_mrf_stage`, its passes covering 1.26 rows per row kept).
// At C = 64 and 128 the tile would be 186 and 46 rows (1.50 and 3.27), and
// 3xTF32 makes each computed row cost three products, so the stage runs as
// one launch per (ResBlock, dilation step) instead (`emotts_mrf_step`), each
// with the halo of its step only, the steps' fp32 results through device
// memory (1.03 and 1.06).  On a short one (a stream's window) the tiles are
// cut short enough to give every SM a block, and the whole stage is one
// launch.  Which one: emotts_torch/ops/mrf.py::launch_plan (the cost of the
// steps' round trips measured on an H100, PERF.md).
//
// Bound on this card: 2*B*T*126*C^2 operations against 2*B*T*C*itemsize
// bytes: operations.  The products run on the tensor cores through the conv
// core of resblock_common.cuh (`wgmma`, TF32, A from registers): 3xTF32 for
// fp32 (three TF32 products a term), one TF32 product a term for bf16, whose
// operands are exact in bf16 (the reference's rounding points, `ROUND`;
// weights rounded by the caller).  The weights come packed for the core's
// ring (ops/resblock.py::pack_weights).  What holds it back from that bound:
// resblock_common.cuh.
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

// What a launch does with its tile's result v, the centre rows of BUF:
// hand it to the next dilation step (kToNext), or add it to the running sum
// over the ResBlocks, which lives in device memory (the block's own rows,
// read back by the thread that wrote them): the first ResBlock starts it
// (kFirst), the last writes the mean (kLast).
constexpr int kFirst = 1, kLast = 2, kToNext = 4;

template <typename T, int C>
__device__ __forceinline__ void store_rows(const float* buf, int halo, int rows,
                                           size_t o0, int mode, float n,
                                           float* next, float* sum, T* out) {
  for (int e = threadIdx.x; e < rows * C; e += kConsumers) {
    const int i = e / C, c = e % C;
    const size_t o = o0 + (size_t)i * C + c;
    const float v = buf[Rows<C>::at(halo + i, c)];
    if (mode & kToNext) {
      next[o] = v;
      continue;
    }
    const float s = (mode & kFirst) ? v : sum[o] + v;
    if (mode & kLast)
      out[o] = from_float<T>(s / n);
    else
      sum[o] = s;
  }
}

// The whole stage in one launch.  The weights are packed (pack_weights):
// one part with ROUND, else two.
template <typename T, int C, bool ROUND>
__global__ void __launch_bounds__(kBlockThreads, 1)
mrf_stage_kernel(const T* __restrict__ x, T* out, float* sum, StageParams p,
                 DilationList dl, long long t_len, int tile, int halo, int zoff) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int n_rows = tile + 2 * halo;
  Ring<C> ring;
  float* buf;
  if (!start_block<C>(smem, ring, buf, [&] {
        for (int rb = 0; rb < p.n_rb; ++rb)
          produce_chain<C, ROUND ? 1 : 2>(ring, halo, tile, p.w1[rb], p.w2[rb], p.k[rb],
                                          dl);
      }))
    return;
  float* z = buf + (size_t)n_rows * Rows<C>::LDA;

  const long long batch = blockIdx.y;
  const long long t0 = (long long)blockIdx.x * tile;
  const int rows = (int)(t_len - t0 < tile ? t_len - t0 : tile);

  for (int rb = 0; rb < p.n_rb; ++rb) {
    const int h = chain_halo(p.k[rb], dl);
    // the previous ResBlock's centre rows have been stored
    consumer_sync();
    load_window<T, C>(buf, x, batch, t_len, t0 - halo, halo - h, halo + tile + h);
    consumer_sync();
    resblock_chain<C, ROUND>(buf, z, zoff, ring, n_rows, halo, tile, t0, t_len,
                             p.b1[rb], p.b2[rb], p.k[rb], dl);
    const int mode = (rb == 0 ? kFirst : 0) | (rb == p.n_rb - 1 ? kLast : 0);
    store_rows<T, C>(buf, halo, rows, (size_t)(batch * t_len + t0) * C, mode,
                     (float)p.n_rb, nullptr, sum, out);
  }
}

// One dilation step of one ResBlock: x is the stage input (TI = T) or the
// fp32 result of the step before (TI = float).
template <typename TI, typename T, int C, bool ROUND>
__global__ void __launch_bounds__(kBlockThreads, 1)
mrf_step_kernel(const TI* __restrict__ x, float* next, float* sum, T* out,
                const float* __restrict__ w1, const float* __restrict__ b1,
                const float* __restrict__ w2, const float* __restrict__ b2, int k,
                DilationList dl, long long t_len, int tile, int halo, int zoff,
                int mode, float n) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int n_rows = tile + 2 * halo;
  Ring<C> ring;
  float* buf;
  if (!start_block<C>(smem, ring, buf, [&] {
        produce_chain<C, ROUND ? 1 : 2>(ring, halo, tile, w1, w2, k, dl);
      }))
    return;
  float* z = buf + (size_t)n_rows * Rows<C>::LDA;

  const long long batch = blockIdx.y;
  const long long t0 = (long long)blockIdx.x * tile;
  const int rows = (int)(t_len - t0 < tile ? t_len - t0 : tile);
  load_window<TI, C>(buf, x, batch, t_len, t0 - halo, 0, n_rows);
  consumer_sync();
  resblock_chain<C, ROUND>(buf, z, zoff, ring, n_rows, halo, tile, t0, t_len, b1, b2,
                           k, dl);
  store_rows<T, C>(buf, halo, rows, (size_t)(batch * t_len + t0) * C, mode, n,
                   next, sum, out);
}

template <typename TI, typename T, int C, bool ROUND>
static int launch_step(const void* x, float* next, float* sum, void* out,
                       const float* w1, const float* b1, const float* w2,
                       const float* b2, int k, int d, int mode, int n_rb, int B,
                       long long t_len, int tile, cudaStream_t stream) {
  DilationList dl;
  dl.n = 1;
  for (int j = 0; j < kMaxDilations; ++j) dl.d[j] = j == 0 ? d : 1;
  const int halo = chain_halo(k, dl);
  const int zoff = z_offset(k, dl, halo);
  const size_t smem = chain_smem_bytes(C, tile, halo, zoff);
  if (smem > (size_t)kMaxSmemBytes) return kErrSharedMemory;
  auto kern = mrf_step_kernel<TI, T, C, ROUND>;
  static std::atomic<unsigned long long> smem_set{0};
  cudaError_t err = set_max_dynamic_smem(kern, kMaxSmemBytes, smem_set);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((unsigned)((t_len + tile - 1) / tile), (unsigned)B);
  kern<<<grid, kBlockThreads, smem, stream>>>(
      static_cast<const TI*>(x), next, sum, static_cast<T*>(out), w1, b1, w2, b2,
      k, dl, t_len, tile, halo, zoff, mode, (float)n_rb);
  return (int)cudaGetLastError();
}

template <typename T, bool ROUND>
static int dispatch_step(int C, bool x_is_input, const void* x, float* next,
                         float* sum, void* out, const float* w1, const float* b1,
                         const float* w2, const float* b2, int k, int d, int mode,
                         int n_rb, int B, long long t_len, int tile,
                         cudaStream_t s) {
#define EMOTTS_STEP(CC)                                                          \
  return x_is_input                                                              \
             ? launch_step<T, T, CC, ROUND>(x, next, sum, out, w1, b1, w2, b2,   \
                                            k, d, mode, n_rb, B, t_len, tile, s) \
             : launch_step<float, T, CC, ROUND>(x, next, sum, out, w1, b1, w2,   \
                                                b2, k, d, mode, n_rb, B, t_len,  \
                                                tile, s)
  switch (C) {
    case 32: EMOTTS_STEP(32);
    case 64: EMOTTS_STEP(64);
    case 128: EMOTTS_STEP(128);
    default: return kErrUnsupportedShape;
  }
#undef EMOTTS_STEP
}

// One launch of a stage.  `sum` is an fp32 (B, T, C) scratch for the running
// sum over the ResBlocks; with fp32 activations it may be `out` itself.
template <typename T, int C, bool ROUND>
static int launch_stage(const void* x, void* out, float* sum,
                        const StageParams& p, const DilationList& dl, int B,
                        long long t_len, int tile, cudaStream_t stream) {
  int halo = 0;
  for (int rb = 0; rb < p.n_rb; ++rb) {
    const int h = chain_halo(p.k[rb], dl);
    halo = h > halo ? h : halo;
  }
  int zoff = halo;
  for (int rb = 0; rb < p.n_rb; ++rb) {
    const int zo = z_offset(p.k[rb], dl, halo);
    zoff = zo < zoff ? zo : zoff;
  }
  const size_t smem = chain_smem_bytes(C, tile, halo, zoff);
  if (smem > (size_t)kMaxSmemBytes) return kErrSharedMemory;
  auto kern = mrf_stage_kernel<T, C, ROUND>;
  static std::atomic<unsigned long long> smem_set{0};
  cudaError_t err = set_max_dynamic_smem(kern, kMaxSmemBytes, smem_set);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((unsigned)((t_len + tile - 1) / tile), (unsigned)B);
  kern<<<grid, kBlockThreads, smem, stream>>>(static_cast<const T*>(x),
                                              static_cast<T*>(out), sum, p, dl,
                                              t_len, tile, halo, zoff);
  return (int)cudaGetLastError();
}

template <typename T, bool ROUND>
static int dispatch_stage(int C, const void* x, void* out, float* sum,
                          const StageParams& p, const DilationList& dl, int B,
                          long long t_len, int tile, cudaStream_t s) {
  switch (C) {
    case 32: return launch_stage<T, 32, ROUND>(x, out, sum, p, dl, B, t_len, tile, s);
    case 64: return launch_stage<T, 64, ROUND>(x, out, sum, p, dl, B, t_len, tile, s);
    case 128: return launch_stage<T, 128, ROUND>(x, out, sum, p, dl, B, t_len, tile, s);
    default: return kErrUnsupportedShape;
  }
}

}  // namespace emotts

// x, out: contiguous (B, T, C), fp32 (is_bf16 = 0) or bf16 (1), out != x.
// sum: fp32 (B, T, C) scratch for the running sum over the ResBlocks; with
// fp32 activations it may be `out`.  weights: host array of 4*n_rb device
// pointers, per ResBlock (w1, b1, w2, b2) with w the (n_dil, k, C, C)
// weights packed by emotts_torch/ops/resblock.py::pack_weights (one part
// with bf16 activations, two with fp32), 16-byte aligned, and b (n_dil, C).  ks: n_rb odd
// kernel sizes on the host; dils: n_dil ints on the host, the same for every
// ResBlock.  C in {32, 64, 128}.  With bf16 activations the rounding points
// of the reference are repeated and the caller passes weights already
// rounded to bf16 values.  Launches on `stream`, does not synchronise;
// returns 0 or an error code.
extern "C" int emotts_mrf_stage(const void* x, void* out, void* sum,
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
    if (on && !aligned16({p.w1[rb], p.w2[rb]})) return kErrMisaligned;
  }
  DilationList dl;
  dl.n = n_dil;
  for (int j = 0; j < kMaxDilations; ++j) dl.d[j] = j < n_dil ? dils[j] : 1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return dispatch_stage<__nv_bfloat16, true>(C, x, out, static_cast<float*>(sum),
                                               p, dl, B, T, tile, s);
  return dispatch_stage<float, false>(C, x, out, static_cast<float*>(sum), p, dl,
                                      B, T, tile, s);
}

// One dilation step d of one ResBlock (kernel size k) of a stage cut into
// launches (emotts_torch/ops/mrf.py::launch_plan).  x: the stage input, of
// the stage's type (x_is_input = 1), or the fp32 result of the step before
// (0); next: fp32 (B, T, C) for this step's result when `mode` has kToNext
// (4); else the result goes to the running sum: `sum` fp32 (B, T, C), `out`
// the stage output, and `mode` says whether this is the first ResBlock (1)
// and/or the last (2) of the n_rb.  w1, w2: one dilation step's (k, C, C)
// weights packed as for emotts_mrf_stage, 16-byte aligned; b1, b2: (C,).  Arithmetic and rounding points as
// emotts_mrf_stage.  Launches on `stream`; returns 0 or an error code.
extern "C" int emotts_mrf_step(const void* x, int x_is_input, void* next,
                               void* sum, void* out, const float* w1,
                               const float* b1, const float* w2, const float* b2,
                               int k, int d, int mode, int n_rb, int B,
                               long long T, int C, int tile, int is_bf16,
                               void* stream) {
  using namespace emotts;
  if (k < 1 || k % 2 == 0 || d < 1 || n_rb < 1 || B < 1 || B > 65535 || T < 1 ||
      tile < 1 || mode < 0 || mode > kToNext)
    return kErrUnsupportedShape;
  if (!aligned16({w1, w2})) return kErrMisaligned;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* nx = static_cast<float*>(next);
  float* sm = static_cast<float*>(sum);
  if (is_bf16)
    return dispatch_step<__nv_bfloat16, true>(C, x_is_input != 0, x, nx, sm, out, w1,
                                              b1, w2, b2, k, d, mode, n_rb, B, T,
                                              tile, s);
  return dispatch_step<float, false>(C, x_is_input != 0, x, nx, sm, out, w1, b1, w2,
                                     b2, k, d, mode, n_rb, B, T, tile, s);
}
