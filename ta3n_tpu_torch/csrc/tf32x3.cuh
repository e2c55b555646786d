// Building blocks shared by the tensor-core kernels (trn_fused_fwd.cu,
// trn_fused_bwd.cu; gather_gemm.cu takes the split for its wgmma
// products): float32 products on the tensor cores at float32 accuracy,
// and a ring of shared-memory stages filled by cp.async.
//
// 3xTF32 ("fast f32").  TF32 keeps 10 explicit mantissa bits, about three
// decimal digits, so one TF32 product per pair would miss the port's f32
// tolerances.  Each f32 operand a is split as a_hi = tf32(a) and
// a_lo = tf32(a - a_hi), both rounded to nearest with ties away from zero
// (the rounding of cvt.rna.tf32.f32), and each product accumulates
//     a_lo*b_hi + a_hi*b_lo + a_hi*b_hi
// in f32 through mma.sync m16n8k8.  What it drops (a_lo*b_lo and the part
// of a below a_lo) is about 2^-22 of |a*b|: f32-level error, at three
// tensor-core products per pair.  An operand with at most 11 significant
// bits has a_lo = 0 and is multiplied exactly.
//
// Fragments of mma.sync.m16n8k8.row.col.f32.tf32.tf32.f32 (PTX ISA), with
// lane = 4*g + t (g = lane / 4, t = lane % 4):
//     A [16 x 8]: a0 (g, t), a1 (g+8, t), a2 (g, t+4), a3 (g+8, t+4)
//     B [8 x 8]:  b0 (k=t, n=g), b1 (k=t+4, n=g)
//     C [16 x 8]: c0 (g, 2t), c1 (g, 2t+1), c2 (g+8, 2t), c3 (g+8, 2t+1)

#pragma once

#include <cuda_runtime.h>

namespace ta3n {

// x rounded to TF32 as cvt.rna.tf32.f32 rounds it, bit for bit, by two
// integer operations: on the H100 a 3xTF32 step (24 mma.sync over 16
// fresh values) runs at about 210 TFLOP/s of TF32 products so, and at
// about 170 with the conversion (scripts/torch_port_tensor_core_probe.py)
__device__ __forceinline__ unsigned to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & ~0x1fffu;
}

// a = hi + lo + (about 2^-22 |a|), hi and lo TF32 values
__device__ __forceinline__ void split_tf32(float a, unsigned& hi,
                                           unsigned& lo) {
  hi = to_tf32(a);
  lo = to_tf32(a - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// A warp's [16*MT x 8*NT] tile over one k step of 8, from f32 fragments in
// the layouts above: acc[mt][nt] += a[mt] (x) b[nt] in 3xTF32, each value
// split where it is used, the small products first.  Each pass runs over
// all MT*NT tiles before the next, so that MT*NT independent mma.sync are
// in flight, not one chain of three.
template <int MT, int NT>
__device__ __forceinline__ void mma_3xtf32(float (&acc)[MT][NT][4],
                                           const float (&a)[MT][4],
                                           const float (&b)[NT][2]) {
  unsigned a_hi[MT][4], a_lo[MT][4], b_hi[NT][2], b_lo[NT][2];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int r = 0; r < 4; ++r) split_tf32(a[i][r], a_hi[i][r], a_lo[i][r]);
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r) split_tf32(b[j][r], b_hi[j][r], b_lo[j][r]);
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j) mma_tf32(acc[i][j], a_lo[i], b_hi[j]);
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j) mma_tf32(acc[i][j], a_hi[i], b_lo[j]);
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j) mma_tf32(acc[i][j], a_hi[i], b_hi[j]);
}

// acc += part, rounded to nearest on the CUDA cores.  The tensor cores
// truncate when they add to an accumulator, and in 3xTF32 they add three
// times a k step: summed into one accumulator over a long K, those
// truncations, all toward zero of a growing sum, cost up to 40x the error
// of an f32 FMA loop (measured on the H100 at the TRN backward's shapes).
// So each 32-deep K chunk is summed into a fresh `part`, whose
// truncations are relative to that chunk's own, smaller sum, and added
// here.
template <int MT, int NT>
__device__ __forceinline__ void add_to(float (&acc)[MT][NT][4],
                                       const float (&part)[MT][NT][4]) {
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] += part[i][j][r];
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

// 4 bytes global -> shared, asynchronously; src_bytes 0 zero-fills
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
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

// A run of 16 floats from src into shared dst, of which the first `valid`
// exist (none when valid <= 0; then src is not read and may be any
// readable address): cp.async of four 16-byte pieces (kVec4: 16-byte
// aligned src and dst, valid a multiple of 4 or >= 16) or of 16 floats;
// the rest is zero-filled.
template <bool kVec4>
__device__ __forceinline__ void copy_run16(float* dst, const float* src,
                                           const float* fallback, int valid) {
  if constexpr (kVec4) {
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const bool in = 4 * v < valid;
      cp_async16(dst + 4 * v, in ? src + 4 * v : fallback, in ? 16 : 0);
    }
  } else {
#pragma unroll
    for (int e = 0; e < 16; ++e) {
      const bool in = e < valid;
      cp_async4(dst + e, in ? src + e : fallback, in ? 4 : 0);
    }
  }
}

// The same for a run of 16 bytes: one 16-byte cp.async (kVec4: aligned,
// valid 0 or >= 16), else plain loads and shared stores, which the ring's
// barrier publishes like the asynchronous copies.
template <bool kVec4>
__device__ __forceinline__ void copy_run16(unsigned char* dst,
                                           const unsigned char* src,
                                           const unsigned char* fallback,
                                           int valid) {
  if constexpr (kVec4) {
    cp_async16(dst, valid > 0 ? src : fallback, valid > 0 ? 16 : 0);
  } else {
#pragma unroll
    for (int e = 0; e < 16; ++e) dst[e] = e < valid ? src[e] : 0;
  }
}

// A ring of kStages shared-memory stages over n chunks: issue(c, s) starts
// the copies of chunk c into stage s; compute(c, s) runs once chunk c has
// landed and every thread can see it.  kStages - 1 chunks are in flight
// while one is multiplied; one barrier a chunk.  Ends with no copy in
// flight and the stages free.
template <int kStages, class Issue, class Compute>
__device__ __forceinline__ void pipeline(int n, Issue&& issue,
                                         Compute&& compute) {
  static_assert(kStages >= 2, "a ring of at least two stages");
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n) issue(s, s);
    cp_async_commit();
  }
  for (int c = 0; c < n; ++c) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    const int next = c + kStages - 1;
    if (next < n) issue(next, next % kStages);
    cp_async_commit();
    compute(c, c % kStages);
  }
  cp_async_wait<0>();
  __syncthreads();
}

}  // namespace ta3n
