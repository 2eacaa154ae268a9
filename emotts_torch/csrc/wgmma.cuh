// Hopper building blocks of the bf16 attention kernels and the vocoder's
// conv core (TF32 products with A in registers, bulk copies into a ring on
// mbarriers: resblock_common.cuh): shared-memory tiles
// in the 128-byte swizzled layout that `wgmma` reads and TMA writes, their
// matrix descriptors, the `wgmma.mma_async` shapes the kernels issue (bf16
// or TF32 operands, fp32 accumulators), mbarriers, TMA and bulk copies,
// small `cp.async` copies and named barriers.  sm_90a only (wgmma does not exist on sm_90).
//
// Tile layout.  A tile of `rows` rows and a multiple of 64 columns of bf16 is
// stored as column blocks of 64 (one 128-byte swizzle row each), one block
// after the other; inside a block row r is 128 bytes at r * 128, and its
// eight 16-byte chunks are permuted: chunk c sits at c ^ (r % 8).  This is
// what a TMA copy of a 64-column box with CU_TENSOR_MAP_SWIZZLE_128B writes,
// and what `wgmma` reads through a descriptor of layout type "128B swizzle";
// each tile starts on a 1024-byte boundary (eight rows, the swizzle's period).
//
// The same tile serves as either operand shape of a product:
//  - K-major (the 64 columns are the reduction dimension): a 16-deep step
//    starts 32 bytes further inside a block, and every fourth step moves to
//    the next block; 8-row groups are 1024 bytes apart;
//  - MN-major (the columns are the output dimension N, or M of an A operand
//    read without a transpose; rows the reduction): a 16-deep step starts 16
//    rows (2048 bytes) further down; an instruction of N = 64 covers one
//    64-wide block, a wider one several, the blocks `rows * 128` bytes apart
//    (the descriptor's leading byte offset), and 8-row groups along the
//    reduction are again 1024 bytes apart.
// (Both were checked on the card against a host product, with the register
// A operand below, before the kernels were built on them.)
//
// Accumulator layout of an m64nN fp32 result, thread t of the warpgroup:
// warp w = t / 32 owns rows 16w .. 16w+15; with g = (t % 32) / 4 and
// c = t % 4, register 4i + e (e = 0, 1) holds (16w + g, 8i + 2c + e) and
// register 4i + 2 + e holds (16w + g + 8, 8i + 2c + e).  Columns 16j ..
// 16j+15 of it, packed to bf16 pairs (4i, 4i+1) of row g, then of row g + 8,
// for i = 2j and then i = 2j + 1, are exactly the four registers of the A
// operand of one 16-deep step: a result feeds the next product without a
// trip through shared memory.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace emotts {
namespace wg {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// A pointer into dynamic shared memory rounded up to the swizzle's period.
__device__ __forceinline__ unsigned char* align_1024(unsigned char* p) {
  return reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(p) + 1023) & ~static_cast<uintptr_t>(1023));
}

// Matrix descriptor of a 128-byte-swizzled operand at shared address `addr`:
// leading byte offset 16 (unused by the swizzled shapes issued here), stride
// byte offset 1024 between 8-row groups.
__device__ __forceinline__ uint64_t desc(uint32_t addr) {
  return (uint64_t)((addr >> 4) & 0x3FFF) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// Descriptor of 16-deep step `k` of a K-major tile of `rows` rows.
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int rows, int k) {
  return desc(tile + (uint32_t)((k >> 2) * rows * 128 + (k & 3) * 32));
}

// Descriptor of 16-deep step `k`, column block `n`, of an MN-major tile.
__device__ __forceinline__ uint64_t desc_mn(uint32_t tile, int rows, int k,
                                            int n) {
  return desc(tile + (uint32_t)(n * rows * 128 + k * 2048));
}

__device__ __forceinline__ void fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Pin registers an asynchronous wgmma reads or writes, so that the compiler
// moves none of their uses across the wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}
template <int A, int B, int N>
__device__ __forceinline__ void fence_regs(uint32_t (&d)[A][B][N]) {
#pragma unroll
  for (int a = 0; a < A; ++a)
#pragma unroll
    for (int b = 0; b < B; ++b) fence_regs(d[a][b]);
}

#define EMOTTS_ACC8(i)                                                  \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),           \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d (64 x 64) += A (64 x 16) * B (16 x 64), both in shared memory, both
// K-major (B stored N x K).  scale_d = 0 ignores the old d.
__device__ __forceinline__ void mma_ss(float (&d)[32], uint64_t a, uint64_t b,
                                       int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : EMOTTS_ACC8(0), EMOTTS_ACC8(8), EMOTTS_ACC8(16), EMOTTS_ACC8(24)
      : "l"(a), "l"(b), "r"(scale_d));
}

// The same with N = 32 (a 16-register accumulator).
__device__ __forceinline__ void mma_ss(float (&d)[16], uint64_t a, uint64_t b,
                                       int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : EMOTTS_ACC8(0), EMOTTS_ACC8(8)
      : "l"(a), "l"(b), "r"(scale_d));
}

// d (64 x 64) += A (64 x 16, four bf16-pair registers) * B (16 x 64, shared,
// MN-major: stored K x N).
__device__ __forceinline__ void mma_rs(float (&d)[32], const uint32_t* a,
                                       uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : EMOTTS_ACC8(0), EMOTTS_ACC8(8), EMOTTS_ACC8(16), EMOTTS_ACC8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

// TF32 products with the A operand in registers (the vocoder's conv core,
// resblock_common.cuh): d (64 x N) += A (64 x 8) * B (8 x N), B in shared
// memory, K-major (N rows of 8 TF32 values, 32 bytes of a 128-byte swizzled
// row: `desc` of the row block plus 32 bytes a k8 step).  A thread's four A
// registers are the m16n8k8 TF32 fragment of its warp's 16 rows: (g, c),
// (g + 8, c), (g, c + 4), (g + 8, c + 4), g = lane / 4, c = lane % 4.  TF32
// takes no transposed operand: both must be K-major.
__device__ __forceinline__ void mma_tf32_rs(float (&d)[16], const uint32_t (&a)[4],
                                            uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : EMOTTS_ACC8(0), EMOTTS_ACC8(8)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void mma_tf32_rs(float (&d)[32], const uint32_t (&a)[4],
                                            uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : EMOTTS_ACC8(0), EMOTTS_ACC8(8), EMOTTS_ACC8(16), EMOTTS_ACC8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void mma_tf32_rs(float (&d)[64], const uint32_t (&a)[4],
                                            uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : EMOTTS_ACC8(0), EMOTTS_ACC8(8), EMOTTS_ACC8(16), EMOTTS_ACC8(24), EMOTTS_ACC8(32), EMOTTS_ACC8(40), EMOTTS_ACC8(48), EMOTTS_ACC8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// Products whose N spans several 64-column blocks of an MN-major B tile in
// one instruction (N = 64 x blocks): the blocks lie `rows * 128` bytes apart,
// the descriptor's leading byte offset (`desc_mn_wide`).  d is the blocks'
// accumulators one after the other (32 registers a block, as the m64n64
// layout above), a is the register A operand or A's descriptor.
__device__ __forceinline__ uint64_t desc_mn_wide(uint32_t tile, int rows, int k, int n) {
  const uint32_t addr = tile + (uint32_t)(n * rows * 128 + k * 2048);
  return (uint64_t)((addr >> 4) & 0x3FFF) | ((uint64_t)((rows * 128) >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}
template <int N>
__device__ __forceinline__ void mma_rs_wide(float* d, const uint32_t* a, uint64_t b);
template <int N>
__device__ __forceinline__ void mma_ss_mn_wide(float* d, uint64_t a, uint64_t b, int scale_d);
template <>
__device__ __forceinline__ void mma_rs_wide<64>(float* d, const uint32_t* a, uint64_t b) {
  mma_rs(*reinterpret_cast<float(*)[32]>(d), a, b, 1);
}
template <>
__device__ __forceinline__ void mma_rs_wide<128>(float* d, const uint32_t* a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63}"
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : EMOTTS_ACC8(0), EMOTTS_ACC8(8), EMOTTS_ACC8(16), EMOTTS_ACC8(24),
        EMOTTS_ACC8(32), EMOTTS_ACC8(40), EMOTTS_ACC8(48), EMOTTS_ACC8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}
template <>
__device__ __forceinline__ void mma_rs_wide<192>(float* d, const uint32_t* a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, "
      "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95}"
      ", {%96, %97, %98, %99}, %100, p, 1, 1, 1;\n}\n"
      : EMOTTS_ACC8(0), EMOTTS_ACC8(8), EMOTTS_ACC8(16), EMOTTS_ACC8(24),
        EMOTTS_ACC8(32), EMOTTS_ACC8(40), EMOTTS_ACC8(48), EMOTTS_ACC8(56),
        EMOTTS_ACC8(64), EMOTTS_ACC8(72), EMOTTS_ACC8(80), EMOTTS_ACC8(88)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}
template <>
__device__ __forceinline__ void mma_rs_wide<256>(float* d, const uint32_t* a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, "
      "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, "
      "%100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, "
      "%124, %125, %126, %127}"
      ", {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : EMOTTS_ACC8(0), EMOTTS_ACC8(8), EMOTTS_ACC8(16), EMOTTS_ACC8(24),
        EMOTTS_ACC8(32), EMOTTS_ACC8(40), EMOTTS_ACC8(48), EMOTTS_ACC8(56),
        EMOTTS_ACC8(64), EMOTTS_ACC8(72), EMOTTS_ACC8(80), EMOTTS_ACC8(88),
        EMOTTS_ACC8(96), EMOTTS_ACC8(104), EMOTTS_ACC8(112), EMOTTS_ACC8(120)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}
template <>
__device__ __forceinline__ void mma_ss_mn_wide<64>(float* d, uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}"
      ", %32, %33, p, 1, 1, 1, 1;\n}\n"
      : EMOTTS_ACC8(0), EMOTTS_ACC8(8), EMOTTS_ACC8(16), EMOTTS_ACC8(24)
      : "l"(a), "l"(b), "r"(scale_d));
}
template <>
__device__ __forceinline__ void mma_ss_mn_wide<128>(float* d, uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63}"
      ", %64, %65, p, 1, 1, 1, 1;\n}\n"
      : EMOTTS_ACC8(0), EMOTTS_ACC8(8), EMOTTS_ACC8(16), EMOTTS_ACC8(24),
        EMOTTS_ACC8(32), EMOTTS_ACC8(40), EMOTTS_ACC8(48), EMOTTS_ACC8(56)
      : "l"(a), "l"(b), "r"(scale_d));
}

#undef EMOTTS_ACC8

// Two fp32 values rounded to bf16 (to nearest, ties to even) in one register,
// the first in the low half: one conversion instruction for the pair.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// mbarriers and the tensor memory accelerator (TMA).  A stage of tiles is
// copied by one thread: it sets the barrier's expected byte count
// (`mbar_expect_tx`, which is also the phase's one arrival) and starts one
// `tma_load_4d` per 64-column box; every thread then waits for the phase.
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count)
               : "memory");
}
// Makes initialised barriers visible to the copy engine; then __syncthreads.
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}
// Count this thread's arrival on barrier `bar` (a consumer releasing a stage).
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
// Wait until the phase of parity `parity` of barrier `bar` has completed.  A
// wait that has not ended after some seconds traps, so that a copy that
// never arrives fails the launch instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  for (uint32_t n = 0;; ++n) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (n == (1u << 24)) __trap();
  }
}
// One box of a 4-d tensor map at coordinates (c0 innermost, .., c3) into
// shared memory at `dst`; its bytes count on barrier `bar`.  Elements outside
// the tensor are written as zeros.
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const void* tmap,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(tmap)), "r"(bar), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

// `bytes` contiguous bytes global -> shared at `dst` in one bulk copy (16-byte
// aligned both sides, a multiple of 16 bytes); they count on barrier `bar`.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// 4-byte asynchronous copy global -> shared (zeros where `valid` is false;
// the caller still passes an address inside the tensor).
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}
// Count an arrival on barrier `bar` once this thread's earlier cp.async
// copies have landed (the barrier's expected count includes it).
__device__ __forceinline__ void cp_async_mbar_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(bar)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Named barrier `id` (1..15) over `threads` threads of the block: wait for
// all of them, or only count this thread in.
__device__ __forceinline__ void barrier_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void barrier_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// Orders this thread's ordinary shared-memory stores before later reads by
// the tensor cores (`wgmma`'s operands are read through the async proxy);
// every writer executes it, then a barrier hands the tile over.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

}  // namespace wg
}  // namespace emotts
