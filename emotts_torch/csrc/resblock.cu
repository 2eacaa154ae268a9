// One HiFi-GAN ResBlock1 (or a run of its dilation steps) on a tile that
// stays in shared memory.
//
// Replaces the Pallas kernel `_kernel` of emotts/ops/resblock.py (reached
// through `fused_resblock1`): per dilation d
//   x += c2(lrelu(c1(lrelu(x), d))),   slope 0.1,
// with rows outside [0, T) forced to 0 after both convs, fp32 throughout
// (bf16 activations are widened on load and rounded once on store).
//
// What the TPU version does for its own hardware is dropped: the 8-row halo
// rounding, the padding of channels to 128 lanes, the bf16 cast of large
// weight sets.  One thing carries over in another form: at C = 256 the
// window of a whole chain (tile + 2*12, 2*36 or 2*60 rows of 1 KB) leaves
// beside its intermediate and the weight ring no tile that computes few rows
// per row kept in the 227 KB a block has, so the caller runs such a block as
// one launch per dilation step, each with the halo of that step only (see
// emotts_torch/ops/resblock.py::launch_plan: 45-62-row tiles on a long
// sequence).  The extra passes over x through device memory cost far less
// than recomputing the halo per tile would; on a short sequence, whose
// blocks leave SMs idle, the plan may take the whole chain in one launch.
//
// Bound on this card: 2*B*T*6k*C^2 operations against 2*B*T*C*itemsize
// bytes: operations, at every shape the vocoder uses.  The products run on
// the tensor cores through the conv core of resblock_common.cuh (`wgmma`,
// TF32, A from registers), as 3xTF32 (three TF32 products a term, the
// documented emulation of fp32) for both instances: after the first step the
// bf16 instance's residual is an fp32 sum, not a bf16 value.  At C = 256 a
// pass is one m64 tile, so every 64 rows stream the conv's packed weights
// from L2 once (resblock_common.cuh).
#include "resblock_common.cuh"

namespace emotts {

// w1, w2: packed (pack_weights, two parts) per dilation step.
template <typename T, int C>
__global__ void __launch_bounds__(kBlockThreads, 1)
resblock1_kernel(const T* __restrict__ x, T* __restrict__ out,
                 const float* __restrict__ w1, const float* __restrict__ b1,
                 const float* __restrict__ w2, const float* __restrict__ b2,
                 int k, DilationList dl, long long t_len, int tile, int halo,
                 int zoff) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int n_rows = tile + 2 * halo;
  Ring<C> ring;
  float* buf;
  if (!start_block<C>(smem, ring, buf, [&] {
        produce_chain<C, 2>(ring, halo, tile, w1, w2, k, dl);
      }))
    return;
  float* z = buf + (size_t)n_rows * Rows<C>::LDA;

  const long long batch = blockIdx.y;
  const long long t0 = (long long)blockIdx.x * tile;

  load_window<T, C>(buf, x, batch, t_len, t0 - halo, 0, n_rows);
  consumer_sync();
  resblock_chain<C, false>(buf, z, zoff, ring, n_rows, halo, tile, t0, t_len, b1, b2,
                           k, dl);
  for (int e = threadIdx.x; e < tile * C; e += kConsumers) {
    const int i = e / C, c = e % C;
    const long long t = t0 + i;
    if (t < t_len)
      out[(batch * t_len + t) * C + c] = from_float<T>(buf[Rows<C>::at(halo + i, c)]);
  }
}

template <typename T, int C>
static int launch_resblock1(const void* x, void* out, const float* w1,
                            const float* b1, const float* w2, const float* b2,
                            int k, const DilationList& dl, int B, long long t_len,
                            int tile, cudaStream_t stream) {
  const int halo = chain_halo(k, dl);
  const int zoff = z_offset(k, dl, halo);
  const size_t smem = chain_smem_bytes(C, tile, halo, zoff);
  if (smem > (size_t)kMaxSmemBytes) return kErrSharedMemory;
  auto kern = resblock1_kernel<T, C>;
  static std::atomic<unsigned long long> smem_set{0};
  cudaError_t err = set_max_dynamic_smem(kern, kMaxSmemBytes, smem_set);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((unsigned)((t_len + tile - 1) / tile), (unsigned)B);
  kern<<<grid, kBlockThreads, smem, stream>>>(static_cast<const T*>(x),
                                              static_cast<T*>(out), w1, b1, w2, b2,
                                              k, dl, t_len, tile, halo, zoff);
  return (int)cudaGetLastError();
}

template <typename T>
static int dispatch_resblock1(int C, const void* x, void* out, const float* w1,
                              const float* b1, const float* w2, const float* b2,
                              int k, const DilationList& dl, int B,
                              long long t_len, int tile, cudaStream_t s) {
  switch (C) {
    case 32: return launch_resblock1<T, 32>(x, out, w1, b1, w2, b2, k, dl, B, t_len, tile, s);
    case 64: return launch_resblock1<T, 64>(x, out, w1, b1, w2, b2, k, dl, B, t_len, tile, s);
    case 128: return launch_resblock1<T, 128>(x, out, w1, b1, w2, b2, k, dl, B, t_len, tile, s);
    case 256: return launch_resblock1<T, 256>(x, out, w1, b1, w2, b2, k, dl, B, t_len, tile, s);
    default: return kErrUnsupportedShape;
  }
}

}  // namespace emotts

// x, out: contiguous (B, T, C), fp32 (is_bf16 = 0) or bf16 (1), out != x.
// w1, w2: the (n_dil, k, C, C) weights packed in two parts by
// emotts_torch/ops/resblock.py::pack_weights, contiguous, 16-byte aligned;
// b1, b2: (n_dil, C) fp32.  dils: n_dil ints on the host.  C in
// {32, 64, 128, 256}, k odd.  Launches on `stream`, does not synchronise; returns 0 or an error.
extern "C" int emotts_resblock1(const void* x, void* out, const float* w1,
                                const float* b1, const float* w2,
                                const float* b2, int k, const int* dils,
                                int n_dil, int B, long long T, int C, int tile,
                                int is_bf16, void* stream) {
  using namespace emotts;
  if (n_dil < 1 || n_dil > kMaxDilations || k < 1 || k % 2 == 0 || B < 1 ||
      B > 65535 || T < 1 || tile < 1)
    return kErrUnsupportedShape;
  if (!aligned16({w1, w2})) return kErrMisaligned;
  DilationList dl;
  dl.n = n_dil;
  for (int j = 0; j < kMaxDilations; ++j) dl.d[j] = j < n_dil ? dils[j] : 1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return dispatch_resblock1<__nv_bfloat16>(C, x, out, w1, b1, w2, b2, k, dl, B, T, tile, s);
  return dispatch_resblock1<float>(C, x, out, w1, b1, w2, b2, k, dl, B, T, tile, s);
}
