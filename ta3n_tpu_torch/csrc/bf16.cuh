// Building blocks of the kernels' bfloat16 staging and packing
// (gather_gemm.cu's bfloat16 store; gather_gemm_bf16.cu, trn_fused_bwd_bf16.cu
// and trn_fused_fwd_bf16.cu, whose products are wgmma_bf16.cuh's): relu
// and rounding of packed bfloat16 values, and staging of bfloat16 rows.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "tf32x3.cuh"

namespace ta3n {

using bf16 = __nv_bfloat16;

// relu of two packed bfloat16 values: one whose sign bit is set becomes +0
// (as fmaxf(x, 0) in the float32 variants)
__device__ __forceinline__ unsigned relu2(unsigned v) {
  return v & ~(((v >> 15) & 0x00010001u) * 0xffffu);
}

// Two bfloat16 values as one fragment register, lo in the low half.
__device__ __forceinline__ unsigned pack2(bf16 lo, bf16 hi) {
  return static_cast<unsigned>(__bfloat16_as_ushort(lo)) |
         (static_cast<unsigned>(__bfloat16_as_ushort(hi)) << 16);
}

// Two float32 values rounded to bfloat16 (to nearest, ties to even) and
// packed.
__device__ __forceinline__ unsigned pack2f(float lo, float hi) {
  return pack2(__float2bfloat16_rn(lo), __float2bfloat16_rn(hi));
}

// A run of 16 bfloat16 values from src into shared dst, of which the first
// `valid` exist (none when valid <= 0; src is then not read): two 16-byte
// cp.async (kVec: 16-byte aligned src and dst, valid a multiple of 8 or
// >= 16), else plain loads and shared stores, which the ring's barrier
// publishes like the asynchronous copies; the rest zero-filled.
template <bool kVec>
__device__ __forceinline__ void copy_run16(bf16* dst, const bf16* src,
                                           const bf16* fallback, int valid) {
  if constexpr (kVec) {
#pragma unroll
    for (int v = 0; v < 2; ++v) {
      const bool in = 8 * v < valid;
      cp_async16(dst + 8 * v, in ? src + 8 * v : fallback, in ? 16 : 0);
    }
  } else {
#pragma unroll
    for (int e = 0; e < 16; ++e)
      dst[e] = e < valid ? src[e] : __ushort_as_bfloat16(0);
  }
}

}  // namespace ta3n
