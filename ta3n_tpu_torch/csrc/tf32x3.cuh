// Building blocks shared by the kernels: the TF32 split of the float32
// kernels' 3xTF32 products (gather_gemm.cu, trn_fused_fwd.cu and
// trn_fused_bwd.cu, on wgmma through tf32_wgmma.cuh), and the 16-byte
// cp.async copies of the bfloat16 kernels' plain-load rings
// (wgmma_bf16.cuh, bf16.cuh).
//
// 3xTF32 ("fast f32").  TF32 keeps 10 explicit mantissa bits, about three
// decimal digits, so one TF32 product per pair would miss the port's f32
// tolerances.  Each f32 operand a is split as a_hi = tf32(a) and
// a_lo = tf32(a - a_hi), both rounded to nearest with ties away from zero
// (the rounding of cvt.rna.tf32.f32), and each product accumulates
//     a_lo*b_hi + a_hi*b_lo + a_hi*b_hi
// in f32 on the tensor cores.  What it drops (a_lo*b_lo and the part of a
// below a_lo) is about 2^-22 of |a*b|: f32-level error, at three
// tensor-core products per pair.  An operand with at most 11 significant
// bits has a_lo = 0 and is multiplied exactly.

#pragma once

#include <cuda_runtime.h>

namespace ta3n {

// x rounded to TF32 as cvt.rna.tf32.f32 rounds it, bit for bit, by two
// integer operations (on the H100 a 3xTF32 step ran at about 210 TFLOP/s
// of TF32 products so and at about 170 with the conversion, PERF.md)
__device__ __forceinline__ unsigned to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & ~0x1fffu;
}

// a = hi + lo + (about 2^-22 |a|), hi and lo TF32 values
__device__ __forceinline__ void split_tf32(float a, unsigned& hi,
                                           unsigned& lo) {
  hi = to_tf32(a);
  lo = to_tf32(a - __uint_as_float(hi));
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously, bypassing L1; bytes past
// `src_bytes` (0 or 16) are zero-filled and not read.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

}  // namespace ta3n
