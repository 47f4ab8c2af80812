// Tensor-core helpers shared by the bfloat16 kernels (head_conv_tc.cu,
// fusion_head_tc.cu): the swizzled 16-byte units of the channels-innermost
// shared-memory layouts, ldmatrix loads and mma.sync m16n8k16.
#pragma once

#include <cstdint>

// 16-byte unit of (pixel or weight row) p, channel half h: the halves swap
// where bit 2 of p is set, so 8 neighbouring rows read as one ldmatrix
// matrix sit in 8 distinct bank groups
__device__ __forceinline__ uint32_t unit(int p, int h) { return 2 * p + (h ^ ((p >> 2) & 1)); }

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void ldsm_x2(uint32_t addr, uint32_t& r0, uint32_t& r1) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(addr)
               : "memory");
}

// d += a (16x16, row) * b (16x8, col): bf16 in, float32 sums
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
