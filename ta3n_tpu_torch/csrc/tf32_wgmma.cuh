// Float32 products at float32 accuracy on Hopper's warpgroup matrix
// multiply (3xTF32 on wgmma), the building blocks of the float32 kernels:
// K3's GEMM (gather_gemm.cu), K1's GEMM (trn_fused_fwd.cu) and K2's dx
// and dW GEMMs (trn_fused_bwd.cu).
//
// The shape they share.  A block computes a 128 x 128 float32 tile D =
// A B over K in 32-deep chunks (one 128-byte row of float32), with two
// consumer warpgroups (64 rows of A each) and a producer warpgroup whose
// first thread keeps a ring of TMA boxes in flight and gives its
// registers to the consumers (setmaxnreg).  TF32 wgmma takes its
// shared-memory operand only K-major, so:
//  * B is the shared operand, always K-major, in two 128-row boxes a
//    chunk: its TF32 hi and lo planes, split once a call by a kernel
//    before the GEMM (each kernel's stage A).
//  * A is the register operand (this thread's values of the m16n8k8 A
//    fragment, warp w of the warpgroup on rows 16w..16w+15), loaded from
//    swizzled boxes in either order: K-major (a 128-row box, a row per
//    A row: frag_kmajor) or MN-major (four 32-row boxes, a row per K
//    index, boxes 32 A rows apart: frag_mnmajor).  A value that changes
//    every call (a weight) is split in registers as it is loaded; one that
//    a stage A split already comes as hi and lo boxes.
// Each chunk's twelve products (a_lo b_hi, a_hi b_lo, a_hi b_hi over four
// k steps) go into fresh registers, then are added to the float32 sum on
// the CUDA cores: the tensor cores truncate as they accumulate, and over
// one accumulator a long K erred 42 times as much as the plain version
// (the mma.sync design's measurement).  The product loop holds no branch
// on the thread: ptxas serializes wgmma in a divergent path (C7520).
//
// K slices.  Where one member's tiles leave SMs without a block, a tile's
// K is split over a thread block cluster of up to 16 blocks (a grid's
// z), each slice's partial tile staged in its block's shared memory over
// the ring, and summed in slice order through distributed shared memory:
// no atomics and no float32 partials in device memory, so a second call
// gives the same bits.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <mutex>

#include "tf32x3.cuh"
#include "trn_plan.cuh"
#include "wgmma_bf16.cuh"

namespace ta3n {
namespace tf32 {

constexpr int kTile = 128;   // output tile: A rows x B rows
constexpr int kTileK = 32;   // a chunk: one 128-byte row of float32
constexpr int kBoxBytes = kTile * 128;  // a 128-row box of a chunk
constexpr int kQuarterBytes = 32 * 128;  // a 32-row box of a chunk
constexpr int kMaxSplits = 16;  // a cluster past 8 opts in
// two consumer warpgroups and a producer warpgroup (a whole one, so that
// the block's registers are those of 384 threads and setmaxnreg can move
// the producer's to the consumers)
constexpr int kThreads = kConsumers + 128;
constexpr int kProducerRegs = 40, kConsumerRegs = 232;
static_assert(2 * 128 * kConsumerRegs + 128 * kProducerRegs <= 65536,
              "the register file");
// the float32 partial tile of a K slice in shared memory, rows padded so
// that a warp's stores fall in distinct banks
constexpr int kRedPitch = kTile + 4;
constexpr int kRedBytes = kTile * kRedPitch * 4;

// D[64 x N] (+)= A[64 x 8] B[8 x N] in TF32 with float32 accumulation, N
// = 2R = 8, 16, 32, 64 or 128 (an N-row B for narrow batches): A from
// registers (this thread's four TF32 values of the m16n8k8 A fragment), B
// K-major from the descriptor b; scale_d 0 ignores D's old values.
template <int R>
__device__ __forceinline__ void wgmma_tf32(float (&d)[R],
                                           const unsigned (&a)[4], uint64_t b,
                                           int scale_d);
template <>
__device__ __forceinline__ void wgmma_tf32<4>(float (&d)[4],
                                              const unsigned (&a)[4],
                                              uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3"
      "}, {%4, %5, %6, %7}, %8, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}
template <>
__device__ __forceinline__ void wgmma_tf32<8>(float (&d)[8],
                                              const unsigned (&a)[4],
                                              uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}
template <>
__device__ __forceinline__ void wgmma_tf32<16>(float (&d)[16],
                                              const unsigned (&a)[4],
                                              uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}
template <>
__device__ __forceinline__ void wgmma_tf32<32>(float (&d)[32],
                                              const unsigned (&a)[4],
                                              uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}
template <>
__device__ __forceinline__ void wgmma_tf32<64>(float (&d)[64],
                                              const unsigned (&a)[4],
                                              uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

// An arrival on the mbarrier `bar` by the threads for which `arrive`
// holds, as a predicated instruction rather than a branch (which would
// serialize the products around it).
__device__ __forceinline__ void arrive_if(uint64_t* bar, bool arrive) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %1, 0;\n"
      "@p mbarrier.arrive.shared::cta.b64 _, [%0];\n}\n" ::"r"(
          smem_addr(bar)),
      "r"(static_cast<int>(arrive))
      : "memory");
}

// The A row and K index of this thread's fragment value at k step kk,
// register r: row 64wg + 16w + l/4 + 8(r % 2), K 8kk + l%4 + 4(r / 2)
// (wg its warpgroup, w its warp there, l its lane).
__device__ __forceinline__ int frag_row(int r) {
  const int tid = threadIdx.x;
  return 64 * (tid / 128) + 16 * (tid % 128 / 32) + tid % 32 / 4 +
         8 * (r % 2);
}
__device__ __forceinline__ int frag_k(int kk, int r) {
  return 8 * kk + threadIdx.x % 4 + 4 * (r / 2);
}

// Its byte offset in a K-major box of 128 A rows of 128 bytes, in the
// 128-byte swizzle (a row's 16-byte pieces XOR its row % 8).
__device__ __forceinline__ unsigned frag_kmajor(int kk, int r) {
  return swizzle128(static_cast<unsigned>(frag_row(r) * 128 +
                                          frag_k(kk, r) * 4));
}

// Its byte offset in four MN-major boxes of 32 K rows of 32 A values (box
// q holding A rows 32q..32q + 31), each 128-byte swizzled.
__device__ __forceinline__ unsigned frag_mnmajor(int kk, int r) {
  const int m = frag_row(r);
  return static_cast<unsigned>(m / 32) * kQuarterBytes +
         swizzle128(static_cast<unsigned>(frag_k(kk, r) * 128 +
                                          (m % 32) * 4));
}

// The producer thread's ring over n chunks: chunk i into stage
// i % kStages once the consumers released it.  early(i, s, bar) arms the
// stage's full barrier with all of its bytes and issues the boxes that do
// not come from the stage A before the GEMM (a weight), late(i, s, bar)
// the others; the first kStages chunks' early boxes are issued before
// the wait for stage A (the GEMM is its programmatic dependent).
template <int kStages, class Early, class Late>
__device__ __forceinline__ void produce(int n, uint64_t* full,
                                        uint64_t* empty, Early&& early,
                                        Late&& late) {
  for (int i = 0; i < n; ++i) {
    const int s = i % kStages;
    if (i == 0) {
      for (int f = 0; f < kStages && f < n; ++f) early(f, f, &full[f]);
      asm volatile("griddepcontrol.wait;\n" ::: "memory");
    } else if (i >= kStages) {
      mbar_wait(&empty[s], (i / kStages - 1) & 1);
      early(i, s, &full[s]);
    }
    late(i, s, &full[s]);
  }
}

// The consumers' products over n chunks of the ring into acc, R = N / 2
// values a thread for B tiles of N rows (zero when n is 0): load(stage,
// a_hi, a_lo) reads this thread's A fragments of a chunk (splitting them
// where they come unsplit); B's hi and lo boxes lie b_off and b_off +
// b_bytes into the stage.  Each warpgroup releases a stage once its
// products of it are done.
template <int kStages, int R, class Load>
__device__ __forceinline__ void consume(int n, const unsigned char* smem,
                                        int stage_bytes, int b_off,
                                        int b_bytes, uint64_t* full,
                                        uint64_t* empty, float (&acc)[R],
                                        Load&& load) {
  float part[R];
#pragma unroll
  for (int e = 0; e < R; ++e) acc[e] = 0.f;
  for (int i = 0; i < n; ++i) {
    const int s = i % kStages;
    mbar_wait(&full[s], (i / kStages) & 1);
    const unsigned char* st = smem + s * stage_bytes;
    unsigned a_hi[kTileK / 8][4], a_lo[kTileK / 8][4];
    load(st, a_hi, a_lo);
    const uint64_t b_hi = kmajor_desc(st + b_off);
    const uint64_t b_lo = kmajor_desc(st + b_off + b_bytes);
    fence_operands(part);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kTileK / 8; ++kk) {
      const uint64_t step = kk * kKMajorStep;
      wgmma_tf32(part, a_lo[kk], b_hi + step, kk > 0);
      wgmma_tf32(part, a_hi[kk], b_lo + step, 1);
      wgmma_tf32(part, a_hi[kk], b_hi + step, 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(part);
    arrive_if(&empty[s], threadIdx.x % 128 == 0);
#pragma unroll
    for (int e = 0; e < R; ++e) acc[e] += part[e];
  }
}

// This block's partial tile into red (over the ring: call it once every
// consumer's products are done, so every box has landed), rows of
// kRedPitch.  kBRows: the output's rows are B's (the tile read as D^T,
// red[B row][A row]); else A's (red[A row][B row]).  Accumulator value
// acc[4j + 2i + e] is D[16w + l/4 + 8i][8j + 2(l%4) + e] of the
// warpgroup's 64 rows, j < R / 4 (N / 8).
template <bool kBRows, int R>
__device__ __forceinline__ void stage_partial(float* red,
                                              const float (&acc)[R]) {
  named_sync(kConsumers);
  const int tid = threadIdx.x, lane = tid % 32;
  const int a_row = 64 * (tid / 128) + 16 * (tid % 128 / 32) + lane / 4;
#pragma unroll
  for (int j = 0; j < R / 4; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int a = a_row + 8 * i, b = 8 * j + 2 * (lane % 4) + e;
        red[kBRows ? b * kRedPitch + a : a * kRedPitch + b] =
            acc[4 * j + 2 * i + e];
      }
}

// One float32 value at shared address `addr` of this block, read in the
// block of rank `rank` of the cluster (as ld_cluster4).
__device__ __forceinline__ float ld_cluster1(unsigned addr, unsigned rank) {
  unsigned remote;
  asm("mapa.shared::cluster.u32 %0, %1, %2;\n"
      : "=r"(remote)
      : "r"(addr), "r"(rank));
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n" : "=f"(v) : "r"(remote));
  return v;
}

// After a cluster_sync that published every slice's red (kRows rows of
// 128 values): this block's share of the rows, [kRows split / splits,
// kRows (split + 1) / splits), summed over the cluster's slices in slice
// order, four values at a time: store(row, col, sum) for col a multiple
// of 4.  The consumer threads take part.
template <int kRows = kTile, class Store>
__device__ __forceinline__ void cluster_sum(const float* red, int split,
                                            int splits, Store&& store) {
  const int r0 = kRows * split / splits;
  const int r1 = kRows * (split + 1) / splits;
  const unsigned base = smem_addr(red);
  constexpr int kQuads = kTile / 4;
  for (int e = threadIdx.x; e < (r1 - r0) * kQuads; e += kConsumers) {
    const int row = r0 + e / kQuads, col = e % kQuads * 4;
    const unsigned addr = base + (row * kRedPitch + col) * 4;
    // every slice's four values first (the remote loads in flight
    // together), then their sum in slice order
    float4 v[kMaxSplits];
#pragma unroll
    for (int s = 0; s < kMaxSplits; ++s)
      if (s < splits) v[s] = ld_cluster4(addr, s);
    float4 sum = v[0];
#pragma unroll
    for (int s = 1; s < kMaxSplits; ++s) {
      if (s >= splits) break;
      sum.x += v[s].x;
      sum.y += v[s].y;
      sum.z += v[s].z;
      sum.w += v[s].w;
    }
    store(row, col, sum);
  }
}

// Four values of an output row at dst, of which those before `valid`
// exist: one 16-byte store where `quads` (dst 16-byte aligned, valid >=
// 4), else one at a time.
__device__ __forceinline__ void store4(float* dst, float4 v, int valid,
                                       bool quads) {
  if (quads) {
    *reinterpret_cast<float4*>(dst) = v;
    return;
  }
  const float o[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int u = 0; u < 4; ++u)
    if (u < valid) dst[u] = o[u];
}

// A scratch part's size rounded up to 256 bytes of float32 values, so
// that the next part starts 16-byte aligned for TMA (the wrappers size
// scratch alike).
inline long long scratch_floats(long long n) { return (n + 63) / 64 * 64; }

// The tensor map of a float32 operand [layers, rows, cols] whose rows lie
// `pitch` values apart (a multiple of 4), in boxes of 32 columns x
// box_rows rows of one layer, 128-byte swizzled; zeros out of range.
inline int operand_map(const void* base, long long cols, long long rows,
                       long long layers, long long pitch, int box_rows,
                       CUtensorMap* map) {
  const cuuint64_t row = static_cast<cuuint64_t>(pitch) * 4;
  return encode_map(
      map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, base,
      {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows),
       static_cast<cuuint64_t>(layers)},
      {row, row * static_cast<cuuint64_t>(rows)},
      {kTileK, static_cast<cuuint32_t>(box_rows), 1},
      CU_TENSOR_MAP_SWIZZLE_128B);
}

// The rank-4 tensor map (d, k, h, members) of `members` stacked weights
// [members, h, k*d] at w (a position's D columns its own dimension, so a
// box never runs into the next position's), rows `pitch` values of each
// position apart (d for a weight as it is), boxes of 32 x 1 x box_rows x
// 1; zeros out of range.  A weight as it is (pitch 0: d, k positions a
// row) is cached by pointer, shape, member count and box.  Returns a
// cudaError_t.
inline int position_map(const void* w, int d, int k, int h, int members,
                        int box_rows, CUtensorMap* out, int pitch = 0) {
  struct Entry {
    const void* w;
    int d, k, h, members, box_rows;
    CUtensorMap map;
  };
  constexpr int kCache = 64;
  static std::mutex mu;
  static Entry cache[kCache];
  static int cached = 0, next = 0;
  const std::lock_guard<std::mutex> lock(mu);
  if (pitch == 0) {
    for (int i = 0; i < cached; ++i) {
      const Entry& e = cache[i];
      if (e.w == w && e.d == d && e.k == k && e.h == h &&
          e.members == members && e.box_rows == box_rows) {
        *out = e.map;
        return 0;
      }
    }
  }
  const cuuint64_t pos = static_cast<cuuint64_t>(pitch == 0 ? d : pitch) * 4;
  const cuuint64_t row = pos * static_cast<cuuint64_t>(k);
  const int err = encode_map(
      out, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, w,
      {static_cast<cuuint64_t>(d), static_cast<cuuint64_t>(k),
       static_cast<cuuint64_t>(h), static_cast<cuuint64_t>(members)},
      {pos, row, row * static_cast<cuuint64_t>(h)},
      {kTileK, 1, static_cast<cuuint32_t>(box_rows), 1},
      CU_TENSOR_MAP_SWIZZLE_128B);
  if (err != 0 || pitch != 0) return err;
  cache[next] = {w, d, k, h, members, box_rows, *out};
  next = (next + 1) % kCache;
  if (cached < kCache) ++cached;
  return 0;
}

// The TRN weights' maps of a float32 kernel.  As they are (by_unit 0:
// D a multiple of 4, every weight 16-byte aligned, at most
// kMaxWeightMaps scales), one map a scale, a box at (column, position
// p, row, member) of map i; else every unit's slice copied by
// launch_trn_repitch into rows [members, h, n_units, pitch] of scratch
// at `rows`, one map, a box at (column, unit z, row, member) of map 0.
struct TrnWeights {
  int by_unit;  // 0: map of scale i, position p; 1: map 0, unit z
  int pitch;    // the copied rows' pitch (D up to 4s)
};

inline TrnWeights trn_weights(const int* plan_table,
                              const void* const* host_ptrs, int d) {
  const int n_units = plan_table[1];
  bool direct = d % 4 == 0 && plan_table[0] <= kMaxWeightMaps;
  for (int z = 0; z < n_units; ++z)
    direct = direct &&
             reinterpret_cast<unsigned long long>(host_ptrs[z]) % 16 == 0;
  return {direct ? 0 : 1, (d + 3) / 4 * 4};
}

inline int trn_weight_maps(const int* plan_table, const void* const* host_ptrs,
                           TrnWeights how, const float* rows, int d, int h,
                           int members, int box_rows, WeightMaps* maps) {
  if (how.by_unit)
    return position_map(rows, d, plan_table[1], h, members, box_rows,
                        &maps->w[0], how.pitch);
  const int* scales = plan_table + kPlanHeader;
  for (int i = 0, z = 0; i < plan_table[0];
       z += scales[kScaleInts * i], ++i) {
    const int err = position_map(host_ptrs[z], d, scales[kScaleInts * i], h,
                                 members, box_rows, &maps->w[i]);
    if (err != 0) return err;
  }
  return 0;
}

// trn_fused_fwd.cu: every unit's weight slice of every member into rows
// [members, h, n_units, pitch] at out, on `stream`.
void launch_trn_repitch(const Plan& plan, const long long* ptrs, float* out,
                        int d, int h, int pitch, int members,
                        cudaStream_t stream);

}  // namespace tf32
}  // namespace ta3n
