// Warp-level building blocks shared by the port's mma.sync kernels
// (flash_attention.cu's split-KV walk, paged_attention.cu's split walk,
// ssd_scan.cu's tensor-core route): 16-byte cp.async copies, ldmatrix and
// mma.sync m16n8k16 over bf16 fragments, the quad reductions of its
// accumulator layout (four lanes hold one row), the exact power-of-two
// rescales of an online softmax whose running maximum is kept as an
// integer, and the three-term bf16 split of fp32 operands.
#pragma once
#include <cuda_bf16.h>

#include <cstdint>

#include "hopper.cuh"

namespace {

// 2^d for an integer-valued d <= 0 (the difference of two integer row
// maxima): exact, 0 below 2^-126.
__device__ __forceinline__ float pow2_int(float d) {
  return d < -126.f ? 0.f : __int_as_float((127 + static_cast<int>(d)) << 23);
}
// 2^x on the special-function unit (ex2.approx: relative error ~2^-22,
// far below P's bf16 rounding).
__device__ __forceinline__ float exp2_fast(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}
// Two fp32 values as three packed bf16 pairs: hi = bf16(v), mid = bf16(v −
// hi), lo = bf16(v − hi − mid), each rounded to nearest even.  The three
// hold all 24 bits of v's significand, so hi + mid + lo == v exactly
// wherever lo's last bit stays within bf16's range (|v| >= 2^-110; below
// it the sum is off by at most 2^-134): three bf16 products against an
// exact bf16 operand, summed in fp32, give the fp32 product.
__device__ __forceinline__ void split_bf16(float a, float b, uint32_t& hi,
                                           uint32_t& mid, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  const float ra = a - hf.x, rb = b - hf.y;
  const __nv_bfloat162 m = __floats2bfloat162_rn(ra, rb);
  const float2 mf = __bfloat1622float2(m);
  const __nv_bfloat162 l = __floats2bfloat162_rn(ra - mf.x, rb - mf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  mid = *reinterpret_cast<const uint32_t*>(&m);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}
__device__ __forceinline__ bool quad_any(bool v) {
  int x = v;
  x |= __shfl_xor_sync(0xffffffffu, x, 1);
  x |= __shfl_xor_sync(0xffffffffu, x, 2);
  return x != 0;
}
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t (&r)[2],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(smem_u32(p))
      : "memory");
}
// d (+)= a · b, m16n8k16, bf16 operands, fp32 accumulators.
__device__ __forceinline__ void mma_16816(float (&d)[4],
                                          const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

}  // namespace
