// Building blocks shared by the recurrent scans' kernels (recurrent.cu,
// recurrent_bwd.cu): TF32 tensor-core products at f32 accuracy (each operand
// cut into a TF32 hi part and the remainder), cp.async copies into shared
// memory, named barriers, and the loads and the shuffle reduce-scatter of
// the WKV kernels' row walk.  Everything is in namespace `scan` as inline
// functions, so a source that uses some of them warns about none of the
// rest.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace scan {

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

struct Split {
  uint32_t hi, lo;
};

// x = hi + lo: hi is x cut to TF32 (its 13 low mantissa bits cleared), lo
// the remainder (exact in f32), which the tensor cores cut to TF32 in turn
// as they read it (they ignore an operand's 13 low bits), so hi + lo holds
// x to 21 bits.  Hopper has no TF32 rounding instruction: cvt.rna.tf32
// costs five, the mask one.
__device__ __forceinline__ Split split(float x) {
  const uint32_t hi = __float_as_uint(x) & 0xffffe000u;
  return {hi, __float_as_uint(x - __uint_as_float(hi))};
}

// d += a b: a 16 x 8 row-major fragment, b an 8 x 8 column fragment, d a
// 16 x 8 f32 accumulator (PTX ISA, mma.m16n8k8 .tf32 fragments: with
// g = lane / 4 and q = lane % 4, a = (g, q), (g + 8, q), (g, q + 4),
// (g + 8, q + 4); b = (q, g), (q + 4, g); d = (g, 2q), (g, 2q + 1),
// (g + 8, 2q), (g + 8, 2q + 1))
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t bits(float x) { return __float_as_uint(x); }

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(s), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// named barrier ID over THREADS threads, which the warps of a CTA reach from
// loops of their own; bar_arrive signals it without waiting (a producer's
// half), bar_sync waits for all THREADS
template <int ID, int THREADS>
__device__ __forceinline__ void bar_sync() {
  asm volatile("bar.sync %0, %1;" ::"n"(ID), "n"(THREADS) : "memory");
}
template <int ID, int THREADS>
__device__ __forceinline__ void bar_arrive() {
  asm volatile("bar.arrive %0, %1;" ::"n"(ID), "n"(THREADS) : "memory");
}

// two consecutive elements from shared memory
__device__ __forceinline__ float2 lds2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 lds2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// One level of the reduce-scatter of a row's 16 parts of A over the lanes
// (bit O of the lane picks the half of the first 4 O values it keeps)
template <int O>
__device__ __forceinline__ void reduce_half(float (&m)[16], int lane) {
  const bool up = (lane & O) != 0;
#pragma unroll
  for (int i = 0; i < 2 * O; ++i) {
    const float send = up ? m[i] : m[i + 2 * O];
    const float keep = up ? m[i + 2 * O] : m[i];
    m[i] = keep + __shfl_xor_sync(0xffffffffu, send, O);
  }
}

}  // namespace scan
