// bf16 tensor-core pieces shared by the port's CUDA sources: the exact
// three-part bf16 split of an f32 pair and the mma.sync.m16n8k16 product
// (bf16 in, f32 accumulators) that consumes it.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace bf16_mma {

// (v0, v1) = p[0] + p[1] + p[2] in bf16, each part the rounding of what the
// earlier ones leave, packed as the mma's pairs (v0 in the low half)
__device__ __forceinline__ void split_bf16(float v0, float v1,
                                           uint32_t (&p)[3]) {
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
    const float2 hf = __bfloat1622float2(h);
    p[i] = *reinterpret_cast<const uint32_t*>(&h);
    v0 -= hf.x;
    v1 -= hf.y;
  }
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

}  // namespace bf16_mma
