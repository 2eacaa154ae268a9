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

}  // namespace emotts
