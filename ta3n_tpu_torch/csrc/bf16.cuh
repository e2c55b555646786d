// Building blocks of the kernels' bfloat16 work on mma.sync (K1's
// bfloat16 variant, trn_fused_fwd.cu) and of bfloat16 staging and
// packing (gather_gemm.cu's bfloat16 store; gather_gemm_bf16.cu and
// trn_fused_bwd_bf16.cu, whose products are wgmma_bf16.cuh's):
// bfloat16 products on the tensor cores with float32 accumulation, the
// fragments they take, and staging of bfloat16 rows.
//
// A product of two bfloat16 values (8 significant bits each) is exact in
// float32, so one mma.sync.m16n8k16 bf16 product per pair, accumulated in
// float32, is the float32 dot of the bfloat16 operands up to the order of
// the sum: what the JAX package's jnp.dot(bf16, bf16,
// preferred_element_type=f32) computes.  No split (tf32x3.cuh) is needed.
//
// Fragments of mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 (PTX
// ISA), with lane = 4*g + t (g = lane / 4, t = lane % 4); each register
// holds two bfloat16 values, the lower k in its low half:
//     A [16 x 16]: a0 (g, 2t..2t+1), a1 (g+8, 2t..), a2 (g, 2t+8..),
//                  a3 (g+8, 2t+8..)
//     B [16 x 8]:  b0 (k = 2t..2t+1, n = g), b1 (k = 2t+8.., n = g)
//     C [16 x 8]:  as m16n8k8: c0 (g, 2t), c1 (g, 2t+1), c2 (g+8, 2t),
//                  c3 (g+8, 2t+1)
// The tensor cores truncate as they add to an accumulator; summed
// directly into one accumulator over a long K that costs at most a few
// times 2^-23 of the sum (about 40 x float32's rounding at the TRN
// backward's depth, tf32x3.cuh::add_to), far below the 2^-9 of the one
// bfloat16 rounding of every output, so the bfloat16 variants accumulate
// directly.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "tf32x3.cuh"

namespace ta3n {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// A warp's [16*MT x 8*NT] tile over one k step of 16: acc[mt][nt] +=
// a[mt] (x) b[nt], all MT*NT products independent.
template <int MT, int NT>
__device__ __forceinline__ void mma_bf16_tiles(float (&acc)[MT][NT][4],
                                               const unsigned (&a)[MT][4],
                                               const unsigned (&b)[NT][2]) {
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j) mma_bf16(acc[i][j], a[i], b[j]);
}

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

// The two consecutive bfloat16 values at p (4-byte aligned) as one
// register.
__device__ __forceinline__ unsigned ld2(const bf16* p) {
  return *reinterpret_cast<const unsigned*>(p);
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }

template <class T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float v) {
  return __float2bfloat16_rn(v);
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
