// Shared helpers for the hand-written kernels of emotts_torch.
//
// Every kernel here is built with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared -Xcompiler -fPIC
// into a shared library with a plain C interface (no PyTorch headers), loaded
// with ctypes by emotts_torch/ops/_build.py.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace emotts {

constexpr int kThreads = 256;

// Return codes of the C entry points beyond cudaError_t (which are < 1000).
constexpr int kErrUnsupportedShape = 1001;
constexpr int kErrSharedMemory = 1002;

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

// Round an fp32 value to the nearest bf16 and back (round half to even).
__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

}  // namespace emotts
