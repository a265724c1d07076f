// The warp-level tensor-core, ldmatrix and cp.async helpers shared by the
// kernels that run on the H100's tensor cores (rel_attention.cu, K1;
// rel_attention_bwd.cu, K2; resblock_trio.cu, K3; trio_shift.cu, K4): one
// copy, so they cannot drift.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t r[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t r[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

// c += a . b on a 16x8x16 bf16 tile, fp32 accumulation
__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a . b on a 16x8x8 tf32 tile, fp32 accumulation
__device__ __forceinline__ void mma_tf32(float c[4], const uint32_t a[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// x = hi + lo (+ a remainder below 2^-22 |x|), both exact tf32 values: each
// rounded to nearest, ties away from zero, as cvt.rna.tf32.f32 rounds, but by
// integer arithmetic, at the integer rate (the conversions were what fp32
// K2's 3xTF32 products waited on: 0.87 -> 0.74 ms at its training shape on an
// H100). A NaN x may lose its NaN in hi (the payload can carry into the sign
// bit), but x - hi is then the canonical NaN 0x7fffffff, which the signed min
// keeps from carrying: lo stays a NaN, so the product does, at one integer op
// (an isnan select on hi cost 25% of fp32 K2's first pass and spilled).
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  const int r = (int)__float_as_uint(x - __uint_as_float(hi));
  lo = ((uint32_t)min(r, 0x7fffefff) + 0x1000u) & 0xffffe000u;
}
// acc += a . b over one 8-deep step by 3xTF32 (lo.hi + hi.lo + hi.hi), the
// step's products summed from zero and added to acc in fp32, rounded to
// nearest (the tensor cores' own sums are not). K1's S and fp32 K2's replay
// of it (rel_attention_bwd.cu, pass (a)) both take it, in the same operand
// order and step order: K2's S is then K1's to the bit, so on a row with one
// key K2's p = exp(s - lse) is exactly 1.
__device__ __forceinline__ void mma_3xtf32_step(float acc[4], const uint32_t ah[4], const uint32_t al[4],
                                                float b0, float b1) {
  uint32_t bh0, bl0, bh1, bl1;
  split(b0, bh0, bl0);
  split(b1, bh1, bl1);
  float c[4] = {0.f, 0.f, 0.f, 0.f};
  mma_tf32(c, al, bh0, bh1);
  mma_tf32(c, ah, bl0, bl1);
  mma_tf32(c, ah, bh0, bh1);
#pragma unroll
  for (int e = 0; e < 4; ++e) acc[e] += c[e];
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);  // .x (lo) in the low half
  return *reinterpret_cast<uint32_t*>(&h);
}

}  // namespace
