// Fused row gather + first-FC GEMM at bfloat16 compute, for Hopper
// (sm_90a), from a float32, bfloat16 or int8 store: the gathered rows
// converted once, then one GEMM on wgmma fed by TMA boxes.
//
// Replaces ta3n_tpu/ops/gather_gemm.py::_kernel (launched through
// gathered_gemm) under the JAX model's bfloat16 compute: the function of
// gather_gemm.cu (see its head), with W bfloat16 [H, k*D], each gathered
// value scaled and rounded to bfloat16 as
//     float32 store  v * row_scale
//     bfloat16 store __fmul_rn(float(v), row_scale)
//     int8 store     __fmul_rn(__fmul_rn(float(q), qscale[row]), row_scale)
// then __float2bfloat16_rn: the value the product and x_res see, bit for
// bit the plain version's.  z = rows @ W^T with float32 accumulation,
// rounded to bfloat16 once (after the split-K sum); x_res holds the
// bfloat16 rows.  gather_gemm.cu's C entry ta3n_gather_gemm_members
// launches these kernels for compute kind 1.
//
// What bounds it on the card.  At the flagship train shape (M = 640 rows,
// D = 2048, H = 512) one member's work is 1.34 GFLOP, 1.4 us at the dense
// bfloat16 rate of 989 TFLOP/s, against 2.0 MB of W, 2.6 MB of x_res, 0.7
// MB of z and the rows (1.3 MB from an int8 store, 5.2 MB from a float32
// one): 2.0-4.5 us at 3.35 TB/s.  So one member is bound by bytes; N
// members sharing one index set add N - 1 weights and outputs (2.7 MB
// each) and 1.34 GFLOP each, so at N = 8 the operations bound it (10.7
// GFLOP, 10.9 us).  The earlier design (one kernel, a 64 x 128 tile a
// block) staged, scaled and rounded the same gathered rows in every block
// that read them, 4 N times a value at H = 512, and ran each 64-deep
// chunk's copy, conversion, barrier and products in turn: half of a
// chunk's cycles converted, and latency, not the tensor cores, set the
// pace (PERF.md, section 6).
//
// What the design does about that: two stages, so the GEMM's loop does
// nothing but wait for boxes and multiply.
//  * Stage A, gather_gemm_bf16_rows: each gathered value is read once in
//    its store type and converted once a call (per index set: once for
//    every member when they share one), a 16-byte piece of 8 values a
//    thread, into the bfloat16 operand A [sets, M, P] (P = k*D rounded up
//    to 8 values, so TMA can take its rows): x_res itself when the caller
//    asks for it and its rows are 16-byte aligned, else a scratch of the
//    call (x_res then written as well, as it is).  Bound by bytes.
//  * Stage B, gather_gemm_bf16_kernel, launched as a programmatic
//    dependent of stage A (it sets up while A runs; its producer waits for
//    A's rows before the first box): a 128 x 128 output tile of one member
//    a block, two consumer warpgroups on 64 rows each, wgmma.mma_async
//    m64n128k16 bf16 from 128-byte swizzled tiles with float32
//    accumulators in registers, so each W box serves 128 rows; both
//    operands K-major, each 64-deep chunk one TMA box of A (rank 3, the
//    index set outermost) and one of W (the rank-3 map of wgmma_bf16.cuh,
//    the member outermost, so a column tile never runs into the next
//    member's rows), zero-filled past M, H and k*D; a producer warp keeps a
//    ring of 3 stages in flight (4 in the folded blocks below;
//    wgmma_pipeline_ws, no conversion), its first W boxes issued before
//    it waits for A.  2 blocks an SM, or one where the grid fits the SMs
//    so: the launch then asks for more than half an SM's shared memory,
//    since a cluster's blocks packed two to an SM left SMs idle (a quarter
//    slower at one member, PERF.md).
//  * Members: N members' columns are N grid rows (blockIdx.y) of one
//    launch, over one A when they share an index set, so the gather and
//    conversion are not repeated per member.
//  * Split K only where one member's tiles leave SMs without a block.
//    Where the slices' blocks fit the SMs one each, gridDim.z blocks share
//    a tile over slices of the chunks, as one thread block cluster; each
//    leaves its float32 partial tile in its shared memory and each sums
//    its share of the tile's rows over the cluster's partials
//    (distributed shared memory) in slice order, then rounds once.  Where
//    they do not (more members), one block a tile runs the slices in turn
//    (kFold: the ring once a slice, a 4-stage ring, one block an SM) and
//    adds each slice's sum to a running float32 sum in shared memory in
//    the same order: the same bits, without a cluster's wave of short
//    blocks and its exchange.  No atomics and no float32 partials in
//    device memory: a second call gives the same bits.  The slices come
//    from one member's shape (ops/gather_gemm.py::bf16_plan), never from
//    N, so member k's z is bitwise its solo launch's; a solo launch is
//    N = 1.
//  * Widths whose rows TMA cannot take (k*D not a multiple of 8, a weight
//    not 16-byte aligned): stage A pads A's rows to P, and
//    gather_gemm_bf16_repitch copies W into a scratch of P-value rows
//    first.
// Indices are not checked here: the Python wrapper only launches with
// indices it checked on the host (0 <= idx < R).

#include <cuda.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "bf16.cuh"
#include "smem_optin.cuh"
#include "tf32x3.cuh"
#include "wgmma_bf16.cuh"

namespace {

using ta3n::bf16;

// stage A: one 16-byte piece (8 values) of a gathered row a thread
constexpr int kRowsThreads = 256;

// stage B
constexpr int kTileM = 128;  // output rows, 64 a consumer warpgroup
constexpr int kTileN = 128;  // output columns of one member
constexpr int kTileK = 64;   // one 128-byte row of bfloat16
constexpr int kMaxSplits = 8;
constexpr int kThreads = ta3n::kConsumers + 32;  // and a producer warp
// a stage: the A box (128 rows of 128 bytes), then the W box (as many);
// after the stages each one's full and empty mbarriers
constexpr int kBoxBytes = kTileM * 128;
constexpr int kStageBytes = 2 * kBoxBytes;
// The ring's shared memory, from a 1024-byte aligned base: kStages stages
// (3, two blocks an SM; 4 in the folded blocks, one an SM), their
// mbarriers at kBars, and the folded blocks' running sum of their slices
// at kDone (64 float32 a consumer thread).  kSmem is asked for with 1024
// bytes to align the base; kSmemSpread instead where the grid fits the
// SMs one block each: more than half an SM's 228 KB, so that the blocks
// (and the clusters) spread over the SMs and none shares one.
template <bool kFold>
struct Ring {
  static constexpr int kStages = kFold ? 4 : 3;
  static constexpr int kBars = kStages * kStageBytes;
  static constexpr int kDone = kBars + 2 * kStages * 8;
  static constexpr int kSmem =
      kDone + (kFold ? ta3n::kConsumers * 64 * 4 : 0) + 1024;
  static_assert(kDone % 16 == 0 && kSmem <= 232448, "the 227 KB opt-in");
};
constexpr int kSmemSpread = 120 * 1024;
// the float32 partial tile of a K slice, over the ring once the products
// are done; rows padded so that a warp's stores fall in distinct banks
constexpr int kRedPitch = kTileN + 8;
static_assert(kTileM == 2 * 64 && kTileN == kTileM, "two m64n128 halves");
static_assert(kTileM * kRedPitch * 4 <= Ring<false>::kBars,
              "the partial tile fits");
static_assert(Ring<false>::kSmem <= kSmemSpread &&
                  2 * (kSmemSpread + 1024) > 228 * 1024,
              "one block an SM");

// The value as the product and x_res see it, rounded to bfloat16: a
// bfloat16 value at row scale 1 is its own rounding and keeps its bits.
template <class S>
__device__ __forceinline__ bf16 convert(S v, float rs, float qs) {
  if constexpr (std::is_same_v<S, float>) {
    return __float2bfloat16_rn(v * rs);
  } else if constexpr (std::is_same_v<S, bf16>) {
    return rs == 1.f ? v : __float2bfloat16_rn(__fmul_rn(__bfloat162float(v),
                                                         rs));
  } else {
    return __float2bfloat16_rn(
        __fmul_rn(__fmul_rn(static_cast<float>(v), qs), rs));
  }
}

// Eight values of a store row: one 16-byte load of bfloat16, two of
// float32, one 8-byte load of int8.
__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
  v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
}
__device__ __forceinline__ void load8(const bf16* p, bf16 (&v)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __ushort_as_bfloat16(static_cast<unsigned short>(w[i]));
    v[2 * i + 1] =
        __ushort_as_bfloat16(static_cast<unsigned short>(w[i] >> 16));
  }
}
__device__ __forceinline__ void load8(const int8_t* p, int8_t (&v)[8]) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
#pragma unroll
  for (int e = 0; e < 8; ++e)
    v[e] = static_cast<int8_t>((e < 4 ? u.x : u.y) >> (8 * (e % 4)));
}

// Stage A: thread p of index set blockIdx.y converts piece p % ceil(D/8)
// (values 8*(p % pieces) ..) of gathered row q = p / pieces into x_res
// (unless null) [sets, M*k, D] and a (unless null) [sets, M, pitch], at
// a's row q / k, columns (q % k) * D ...  Gathered row q is store row
// idx[q / streams] * streams + q % streams, scaled by scale[q / streams]
// (1 where scale is null); set s reads idx and scale at s * idx_stride.
// kVec: D % 8 == 0 and 16-byte aligned store and x_res, so a piece is
// one load and one store.
template <class S, bool kVec>
__global__ void __launch_bounds__(kRowsThreads)
    gather_gemm_bf16_rows(const S* __restrict__ store,
                          const float* __restrict__ qscale,
                          const int* __restrict__ idx,
                          const float* __restrict__ scale,
                          bf16* __restrict__ x_res, bf16* __restrict__ a,
                          long long q_rows, int streams, int d, int k_rows,
                          int pitch, long long idx_stride) {
  // stage B may be launched now: it waits for this grid's stores
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const int pieces = (d + 7) / 8;
  const long long p =
      static_cast<long long>(blockIdx.x) * kRowsThreads + threadIdx.x;
  if (p >= q_rows * pieces) return;
  const long long set = blockIdx.y;
  const long long q = p / pieces;
  const int col = static_cast<int>(p % pieces) * 8;
  const long long n = q / streams;
  const long long r = idx[set * idx_stride + n];
  const S* src = store + (r * streams + q % streams) * d + col;
  const float rs = scale != nullptr ? scale[set * idx_stride + n] : 1.f;
  float qs = 1.f;
  if constexpr (std::is_same_v<S, int8_t>) qs = qscale[r];
  bf16 out[8];
  if constexpr (kVec) {
    S in[8];
    load8(src, in);
#pragma unroll
    for (int e = 0; e < 8; ++e) out[e] = convert<S>(in[e], rs, qs);
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e)
      out[e] = col + e < d ? convert<S>(src[e], rs, qs)
                           : __ushort_as_bfloat16(0);
  }
  const long long m_rows = q_rows / k_rows;
  bf16* dsts[2] = {
      x_res != nullptr ? x_res + (set * q_rows + q) * d + col : nullptr,
      a != nullptr ? a + (set * m_rows + q / k_rows) * pitch +
                         (q % k_rows) * d + col
                   : nullptr};
#pragma unroll
  for (bf16* dst : dsts) {
    if (dst == nullptr) continue;
    if constexpr (kVec) {
      *reinterpret_cast<uint4*>(dst) =
          make_uint4(ta3n::pack2(out[0], out[1]), ta3n::pack2(out[2], out[3]),
                     ta3n::pack2(out[4], out[5]), ta3n::pack2(out[6], out[7]));
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        if (col + e < d) dst[e] = out[e];
    }
  }
}

// The rows [rows, cols] of w into out, `pitch` values apart: a weight
// whose rows TMA cannot take, for stage B.
__global__ void gather_gemm_bf16_repitch(const bf16* __restrict__ w,
                                         bf16* __restrict__ out,
                                         long long rows, int cols,
                                         int pitch) {
  for (long long e = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       e < rows * cols; e += static_cast<long long>(gridDim.x) * blockDim.x)
    out[e / cols * pitch + e % cols] = w[e];
}

// The tensor maps of stage B: A [sets, M, k*D] and W [members, H, k*D],
// boxes of 64 x 128 x 1, 128-byte swizzle.
struct Maps {
  CUtensorMap a, w;
};

// Stage B.  Block (blockIdx.x = row tile * col_tiles + column tile,
// member blockIdx.y, K slice blockIdx.z of gridDim.z = slices, a cluster
// along z): z[member, 128 rows, 128 columns] of z [members, M, H] from
// A's index set (0 when shared, else the member) and the member's W.
// kFold (gridDim.z 1, one block an SM by its shared memory): the block
// runs all `slices` K slices in turn, each into fresh accumulators, and
// keeps their float32 sum in slice order, as the cluster's sum adds them
// (the same bits).  pairs / quads: z rows may be written 2 / 4 values at a
// time (H even / a multiple of 4, z aligned to match).
template <bool kFold>
__global__ void __launch_bounds__(kThreads, kFold ? 1 : 2)
    gather_gemm_bf16_kernel(const __grid_constant__ Maps maps,
                            bf16* __restrict__ z, long long m_rows, int h,
                            int kd, int col_tiles, int shared_rows,
                            int slices, int pairs, int quads) {
  constexpr int kStages = Ring<kFold>::kStages;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (ta3n::smem_addr(smem_raw) & 1023)) & 1023);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + Ring<kFold>::kBars);
  const int tid = threadIdx.x;
  const int member = blockIdx.y;
  const long long m0 =
      static_cast<long long>(blockIdx.x / col_tiles) * kTileM;
  const int h0 = static_cast<int>(blockIdx.x % col_tiles) * kTileN;
  const int split = blockIdx.z, splits = gridDim.z;  // kFold: 0 of 1
  const int set = shared_rows ? 0 : member;
  // this block's K slice, in 64-deep chunks
  const int chunks = (kd + kTileK - 1) / kTileK;
  const int c_begin = chunks * split / splits;
  const int n = chunks * (split + 1) / splits - c_begin;
  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      ta3n::mbar_init(&bars[s], 1);            // full: the producer
      ta3n::mbar_init(&bars[kStages + s], 2);  // empty: the consumers
    }
    ta3n::mbar_fence_init();
  }
  __syncthreads();

  // chunk c's W box into stage s, counting both boxes on its barrier
  auto produce_w = [&](int c, int s) {
    ta3n::mbar_arrive_expect_tx(&bars[s], kStageBytes);
    ta3n::tma_load_3d(smem + s * kStageBytes + kBoxBytes, &maps.w,
                      (c_begin + c) * kTileK, h0, member, &bars[s]);
  };
  auto produce = [&](int c, int s, uint64_t* full) {
    if (tid != ta3n::kConsumers) return;  // one thread issues the boxes
    if (c == 0) {
      // W is ready before stage A ends (a repitched W was written by a
      // kernel that ended before A began): the ring's first W boxes, then
      // wait for A's rows
      for (int f = 0; f < kStages && f < n; ++f) produce_w(f, f);
      asm volatile("griddepcontrol.wait;\n" ::: "memory");
    } else if (c >= kStages) {
      produce_w(c, s);
    }
    ta3n::tma_load_3d(smem + s * kStageBytes, &maps.a,
                      (c_begin + c) * kTileK, static_cast<int>(m0), set,
                      full);
  };
  // each warpgroup's half: rows 64wg.. of the A box, all 128 W rows
  const int wg = tid / 128;
  float acc[kTileN / 2] = {};
  auto mma = [&](int, int s) {
    unsigned char* st = smem + s * kStageBytes;
    const uint64_t a = ta3n::kmajor_desc(st + wg * (kBoxBytes / 2));
    const uint64_t b = ta3n::kmajor_desc(st + kBoxBytes);
#pragma unroll
    for (int k = 0; k < kTileK / 16; ++k)
      ta3n::wgmma<0, 0>(acc, a + k * ta3n::kKMajorStep,
                        b + k * ta3n::kKMajorStep);
  };
  if constexpr (kFold) {
    // the ring run over one slice at a time, each into fresh accumulators,
    // and the slices' sums added in order between the runs (outside the
    // ring's loop, where reading the accumulators would hold back every
    // batch of products), the running sum in shared memory (in registers
    // beside the accumulators it spilled), each thread's own values
    float* done = reinterpret_cast<float*>(smem + Ring<kFold>::kDone) + tid;
    for (int g = 0; g < slices; ++g) {
      const int first = chunks * g / slices;
      if (g > 0) {
#pragma unroll
        for (int i = 0; i < kTileN / 2; ++i) acc[i] = 0.f;
      }
      ta3n::wgmma_pipeline_ws<kStages, false>(
          chunks * (g + 1) / slices - first, acc, bars, bars + kStages, tid,
          produce, [](int, int) {}, mma, first);
      if (tid >= ta3n::kConsumers) continue;
      if (g + 1 < slices) {
#pragma unroll
        for (int i = 0; i < kTileN / 2; ++i)
          done[ta3n::kConsumers * i] =
              g == 0 ? acc[i] : done[ta3n::kConsumers * i] + acc[i];
        if (tid % 128 == 0)
          ta3n::release_stage<kStages>(bars + kStages,
                                       chunks * (g + 1) / slices - 1);
      } else if (g > 0) {
#pragma unroll
        for (int i = 0; i < kTileN / 2; ++i)
          acc[i] = done[ta3n::kConsumers * i] + acc[i];
      }
    }
  } else {
    ta3n::wgmma_pipeline_ws<kStages, false>(n, acc, bars, bars + kStages,
                                            tid, produce, [](int, int) {},
                                            mma);
  }

  z += static_cast<long long>(member) * m_rows * h;
  const int lane = tid % 32, warp = tid % 128 / 32;
  if (splits == 1) {
    if (tid >= ta3n::kConsumers) return;
#pragma unroll
    for (int jn = 0; jn < kTileN / 8; ++jn)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const long long om = m0 + 64 * wg + 16 * warp + lane / 4 + 8 * i;
        const int oh = h0 + 8 * jn + 2 * (lane % 4);
        if (om >= m_rows || oh >= h) continue;
        const float v0 = acc[4 * jn + 2 * i], v1 = acc[4 * jn + 2 * i + 1];
        bf16* dst = z + om * h + oh;
        if (pairs) {
          *reinterpret_cast<unsigned*>(dst) = ta3n::pack2f(v0, v1);
        } else {
          dst[0] = __float2bfloat16_rn(v0);
          if (oh + 1 < h) dst[1] = __float2bfloat16_rn(v1);
        }
      }
    return;
  }

  // the cluster's split-K sum: every slice's partial tile in its block's
  // shared memory, then each block sums rows [r0, r1) of the tile over the
  // slices in order and rounds once
  float* red = reinterpret_cast<float*>(smem);
  if (tid < ta3n::kConsumers) {
#pragma unroll
    for (int jn = 0; jn < kTileN / 8; ++jn)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = 64 * wg + 16 * warp + lane / 4 + 8 * i;
        const int col = 8 * jn + 2 * (lane % 4);
        *reinterpret_cast<float2*>(red + row * kRedPitch + col) =
            make_float2(acc[4 * jn + 2 * i], acc[4 * jn + 2 * i + 1]);
      }
  }
  ta3n::cluster_sync();
  const int r0 = kTileM * split / splits;
  const int r1 = kTileM * (split + 1) / splits;
  const unsigned base = ta3n::smem_addr(red);
  constexpr int kQuads = kTileN / 4;
  for (int e = tid; e < (r1 - r0) * kQuads; e += kThreads) {
    const int row = r0 + e / kQuads, col = e % kQuads * 4;
    const unsigned at = base + (row * kRedPitch + col) * 4;
    // every slice's four values first (the remote loads in flight
    // together), then their sum in slice order
    float4 v[kMaxSplits];
#pragma unroll
    for (int s = 0; s < kMaxSplits; ++s)
      if (s < splits) v[s] = ta3n::ld_cluster4(at, s);
    float4 sum = v[0];
#pragma unroll
    for (int s = 1; s < kMaxSplits; ++s) {
      if (s >= splits) break;
      sum.x += v[s].x;
      sum.y += v[s].y;
      sum.z += v[s].z;
      sum.w += v[s].w;
    }
    const long long om = m0 + row;
    const int oh = h0 + col;
    if (om >= m_rows || oh >= h) continue;
    bf16* dst = z + om * h + oh;
    if (quads) {
      *reinterpret_cast<uint2*>(dst) =
          make_uint2(ta3n::pack2f(sum.x, sum.y), ta3n::pack2f(sum.z, sum.w));
    } else {
      const float v[4] = {sum.x, sum.y, sum.z, sum.w};
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (oh + u < h) dst[u] = __float2bfloat16_rn(v[u]);
    }
  }
  // no block leaves while the others read its shared memory
  ta3n::cluster_sync();
}

// Above 48 KB of dynamic shared memory a kernel must opt in, once on each
// device (smem_optin.cuh).
template <bool kFold>
cudaError_t allow_smem() {
  static std::atomic<int> granted[ta3n::kMaxDevices];
  return ta3n::allow_smem_on_device(gather_gemm_bf16_kernel<kFold>, granted,
                                    kFold ? Ring<true>::kSmem : kSmemSpread);
}

bool aligned(const void* p, unsigned bytes) {
  return reinterpret_cast<unsigned long long>(p) % bytes == 0;
}

// The tensor map of a bfloat16 operand [layers, rows, cols] whose rows lie
// `pitch` values apart (a multiple of 8), in boxes of 64 columns x 128
// rows of one layer; zeros out of range.
int operand_map(const void* base, long long cols, long long rows,
                int layers, long long pitch, CUtensorMap* map) {
  const cuuint64_t row = static_cast<cuuint64_t>(pitch) * 2;
  return ta3n::encode_map(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, base,
      {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows),
       static_cast<cuuint64_t>(layers)},
      {row, row * static_cast<cuuint64_t>(rows)}, {kTileK, kTileM, 1},
      CU_TENSOR_MAP_SWIZZLE_128B);
}

template <class S>
int launch(const void* store, const void* qscale, const void* idx,
           const void* scale, const void* w, void* z, void* x_res,
           void* scratch, long long m_rows, int streams, int d, int k_rows,
           int h, int splits, int members, long long idx_stride,
           cudaStream_t stream) {
  const long long kd = static_cast<long long>(k_rows) * d;
  const long long pitch = (kd + 7) / 8 * 8;
  const long long chunks = (kd + kTileK - 1) / kTileK;
  const long long tiles = (m_rows + kTileM - 1) / kTileM *
                          ((h + kTileN - 1) / kTileN);
  const int sets = idx_stride != 0 ? members : 1;
  const long long q_rows = m_rows * k_rows;
  const long long rows_blocks =
      (q_rows * ((d + 7) / 8) + kRowsThreads - 1) / kRowsThreads;
  if (members > 65535 || tiles > 0x7fffffffLL || rows_blocks > 0x7fffffffLL ||
      splits < 1 || splits > kMaxSplits || (splits & (splits - 1)) != 0 ||
      splits > chunks)
    return static_cast<int>(cudaErrorInvalidValue);
  // the operands of stage B: x_res itself, and the weight, where TMA can
  // take their rows; else scratch (ops/gather_gemm.py::bf16_plan sizes it
  // alike): A's rows of `pitch` values, then W's
  const bool a_direct = x_res != nullptr && kd % 8 == 0 && aligned(x_res, 16);
  const bool w_direct = kd % 8 == 0 && aligned(w, 16);
  bf16* a = a_direct ? static_cast<bf16*>(x_res) : static_cast<bf16*>(scratch);
  bf16* w_rows = w_direct ? nullptr
                          : static_cast<bf16*>(scratch) +
                                (a_direct ? 0 : sets * m_rows * pitch);
  if ((!a_direct || !w_direct) &&
      (scratch == nullptr || !aligned(scratch, 16)))
    return static_cast<int>(cudaErrorInvalidValue);
  Maps maps{};
  int err = operand_map(a, kd, m_rows, sets, pitch, &maps.a);
  if (err == 0)
    err = w_direct ? ta3n::weight_map(w, kd, h, members, kTileK, kTileN,
                                      &maps.w)
                   : operand_map(w_rows, kd, h, members, pitch, &maps.w);
  if (err != 0) return err;
  cudaError_t attr = allow_smem<false>();
  if (attr == cudaSuccess) attr = allow_smem<true>();
  if (attr != cudaSuccess) return static_cast<int>(attr);

  if (!w_direct) {
    const long long count = static_cast<long long>(members) * h * kd;
    const long long blocks = (count + 255) / 256;
    gather_gemm_bf16_repitch<<<static_cast<unsigned>(
                                   blocks < 4096 ? blocks : 4096),
                               256, 0, stream>>>(
        static_cast<const bf16*>(w), w_rows,
        static_cast<long long>(members) * h, static_cast<int>(kd),
        static_cast<int>(pitch));
  }
  // stage A: x_res (unless null), and A's scratch unless x_res is A
  const bool vec = d % 8 == 0 && aligned(store, 16) &&
                   (x_res == nullptr || aligned(x_res, 16));
  (vec ? gather_gemm_bf16_rows<S, true> : gather_gemm_bf16_rows<S, false>)
      <<<dim3(static_cast<unsigned>(rows_blocks), sets), kRowsThreads, 0,
         stream>>>(static_cast<const S*>(store),
                   static_cast<const float*>(qscale),
                   static_cast<const int*>(idx),
                   static_cast<const float*>(scale),
                   static_cast<bf16*>(x_res), a_direct ? nullptr : a, q_rows,
                   streams, d, k_rows, static_cast<int>(pitch), idx_stride);
  const cudaError_t rows_err = cudaGetLastError();
  if (rows_err != cudaSuccess) return static_cast<int>(rows_err);

  // stage B, launched while stage A runs (programmatic dependent launch):
  // a tile's K slices one cluster where the clusters fit the SMs one block
  // each (and then asking for the shared memory that keeps them so), else
  // folded into one block a tile
  int device = 0, sms = 0;
  cudaError_t err_sm = cudaGetDevice(&device);
  if (err_sm == cudaSuccess)
    err_sm = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    device);
  if (err_sm != cudaSuccess) return static_cast<int>(err_sm);
  const long long blocks = tiles * members * splits;
  const bool spread = blocks <= sms;
  const bool fold = splits > 1 && !spread;
  const int cluster = fold ? 1 : splits;
  const int col_tiles = (h + kTileN - 1) / kTileN;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(static_cast<unsigned>(tiles), members, cluster);
  config.blockDim = dim3(kThreads);
  config.dynamicSmemBytes = fold     ? Ring<true>::kSmem
                            : spread ? kSmemSpread
                                     : Ring<false>::kSmem;
  config.stream = stream;
  cudaLaunchAttribute attrs[2];
  attrs[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attrs[0].val.programmaticStreamSerializationAllowed = 1;
  attrs[1].id = cudaLaunchAttributeClusterDimension;
  attrs[1].val.clusterDim.x = 1;
  attrs[1].val.clusterDim.y = 1;
  attrs[1].val.clusterDim.z = static_cast<unsigned>(cluster);
  config.attrs = attrs;
  config.numAttrs = 2;
  const cudaError_t gemm = cudaLaunchKernelEx(
      &config,
      fold ? gather_gemm_bf16_kernel<true> : gather_gemm_bf16_kernel<false>,
      maps, static_cast<bf16*>(z), m_rows, h, static_cast<int>(kd),
      col_tiles, idx_stride == 0 ? 1 : 0, splits,
      h % 2 == 0 && aligned(z, 4) ? 1 : 0,
      h % 4 == 0 && aligned(z, 8) ? 1 : 0);
  if (gemm != cudaSuccess) return static_cast<int>(gemm);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

namespace ta3n {

// The kernels' launches for store_kind 0 (float32), 1 (bfloat16) or 2
// (int8), on arguments that ta3n_gather_gemm_members (gather_gemm.cu)
// checked, of `members` members (idx and scale idx_stride apart: 0 when
// shared), in `splits` K slices (1, 2, 4 or 8, at most one a 64-deep
// chunk of k*D); scratch: bfloat16 of bf16_plan's size
// (ops/gather_gemm.py), A's rows where x_res is null or not 16-byte
// aligned, then W's where W is not.  Returns the first error.
int launch_gather_gemm_bf16(const void* store, const void* qscale,
                            const void* idx, const void* scale,
                            const void* w, void* z, void* x_res,
                            void* scratch, long long m_rows, int streams,
                            int d, int k_rows, int h, int splits,
                            int store_kind, int members,
                            long long idx_stride, cudaStream_t stream) {
  if (store_kind == 0)
    return launch<float>(store, qscale, idx, scale, w, z, x_res, scratch,
                         m_rows, streams, d, k_rows, h, splits, members,
                         idx_stride, stream);
  if (store_kind == 1)
    return launch<bf16>(store, qscale, idx, scale, w, z, x_res, scratch,
                        m_rows, streams, d, k_rows, h, splits, members,
                        idx_stride, stream);
  if (store_kind == 2)
    return launch<int8_t>(store, qscale, idx, scale, w, z, x_res, scratch,
                          m_rows, streams, d, k_rows, h, splits, members,
                          idx_stride, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace ta3n
