// Shared helpers for the hand-written kernels of emotts_torch.
//
// Every kernel here is built with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared -Xcompiler -fPIC
// into a shared library with a plain C interface (no PyTorch headers), loaded
// with ctypes by emotts_torch/ops/_build.py.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <initializer_list>

namespace emotts {

constexpr int kThreads = 256;

// Return codes of the C entry points beyond cudaError_t (which are < 1000).
constexpr int kErrUnsupportedShape = 1001;
constexpr int kErrSharedMemory = 1002;
constexpr int kErrMisaligned = 1003;
constexpr int kErrTensorMap = 1004;

// Largest dynamic shared memory a block may ask for on sm_90 (227 KB).
constexpr int kMaxSmemBytes = 232448;

template <typename T>
__device__ __forceinline__ float to_float(T v);
template <>
__device__ __forceinline__ float to_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_float<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Whether every pointer is 16-byte aligned (what a 16-byte copy needs).
inline bool aligned16(std::initializer_list<const void*> ptrs) {
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) & 15u) return false;
  return true;
}

// cudaFuncSetAttribute(kern, MaxDynamicSharedMemorySize, bytes) once per
// device: the attribute stays set, and setting it before every launch costs
// host time that a short launch notices.  `done` is the caller's per-kernel
// record of the devices it was set on.
template <typename Kernel>
cudaError_t set_max_dynamic_smem(Kernel kern, int bytes,
                                 std::atomic<unsigned long long>& done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = 1ull << (dev & 63);
  if (done.load(std::memory_order_acquire) & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err == cudaSuccess) done.fetch_or(bit, std::memory_order_release);
  return err;
}

// Round an fp32 value to the nearest bf16 and back (round half to even).
__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// TF32 on the tensor cores: the split (`split_tf32`) serves the vocoder's
// conv core (resblock_common.cuh, products on wgmma) and the fp32 attention
// kernels, `mma_tf32` the latter alone.  fp32 is emulated
// with 3xTF32: v splits into hi = cvt.rna.tf32(v) and lo = cvt.rna.tf32(v - hi)
// (both through cvt: the tensor cores ignore the low 13 bits of an
// unconverted operand), and a_lo*b_hi + a_hi*b_lo + a_hi*b_hi is accumulated
// in fp32; the dropped a_lo*b_lo is below 2^-22 of the product.
__device__ __forceinline__ uint32_t to_tf32(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r;
}

// d += a * b on the tensor cores, TF32 operands, fp32 accumulators.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// hi = tf32(v), lo = tf32(v - hi); without SPLIT v is already a TF32 value
// (exact in bf16) and only hi is used.
template <bool SPLIT>
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi, uint32_t& lo) {
  if (SPLIT) {
    hi = to_tf32(v);
    lo = to_tf32(v - __uint_as_float(hi));
  } else {
    hi = __float_as_uint(v);
  }
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit_group() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait_group() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The 16-byte copy with zero fill: `valid` false reads nothing and writes 16
// zero bytes (rows beyond T of an attention tile).
__device__ __forceinline__ void cp_async16_zfill(float* dst, const float* src,
                                                 bool valid) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

}  // namespace emotts
