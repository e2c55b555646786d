// Fused row gather + first-FC GEMM, for Hopper (sm_90a): float32 at f32
// accuracy on the tensor cores (3xTF32 on wgmma), from a float32, bfloat16
// or int8 store; and the C entry of every variant (bfloat16 compute:
// gather_gemm_bf16.cu).
//
// Replaces ta3n_tpu/ops/gather_gemm.py::_kernel (launched through
// gathered_gemm): the device-store steps gather the B*T frame rows of a
// batch from the store that lives on the card and feed them to the shared
// frame-level FC.  With g the gathered rows, each scaled as it is loaded,
//     g[q]   = store[idx[q / S] * S + q % S] * row_scale[q / S]
//              (S = streams: a Flow store's x/y rows interleave per frame)
//     z[m]   = concat(g[m*k], ..., g[m*k + k - 1]) @ W^T      [M, H]
//     x_res  = g viewed as [M, k*D]                (optional, for dW)
// with k = in_features / D gathered rows per FC input row (1 for RGB at
// new_length 1, as x.reshape(B*S, -1) groups them in the model), W in torch
// nn.Linear layout [H, k*D] read as it is, and no bias (the autograd
// wrapper adds it).  The TPU kernel needed a [R, D/128, 128] store so that
// one row was one DMA; here the store is the plain [R*S, D] array.
//
// Store variants.  The store stays in its dtype in device memory (an int8
// row a quarter, a bfloat16 row half the float32 bytes).  An int8 store's
// row q comes with its float32 scale (one per store row, for all its
// streams); the value the product and x_res see is
//     __fmul_rn(__fmul_rn(float(q), scale[row]), row_scale)
// two rounded multiplies in that order and no FMA: the JAX step's
// device_gather (q.astype(f32) * scale) followed by x * mask, bit for bit.
// A bfloat16 store's value is float(v) * row_scale, a float32 one's
// v * row_scale.  Masked rows have scale 0, so they are exactly 0 as in
// JAX's x * mask.
//
// 3xTF32.  TF32 keeps 10 explicit mantissa bits, so each f32 operand a is
// split as a_hi = tf32(a), a_lo = tf32(a - a_hi) (tf32x3.cuh's split_tf32,
// rounding as cvt.rna) and each product accumulates
//     a_lo*b_hi + a_hi*b_lo + a_hi*b_hi
// on the tensor cores: f32-level error at three TF32 products a pair.
//
// What bounds it on the card.  At the flagship train step (M = 640 rows,
// D = 2048, H = 512) the work is 2*M*D*H = 1.34 GFLOP, 4.0 in 3xTF32: 8.1
// us at the dense TF32 rate of 495 TFLOP/s, against 16 MB moved (the rows,
// x_res, W and z), 4.8 us at 3.35 TB/s: bound by operations, on wgmma
// (mma.sync peaks near 70 TFLOP/s of f32 products here, PERF.md).
//
// What the design does about that: two stages, on the pattern of the
// bfloat16 kernels (gather_gemm_bf16.cu), so that the GEMM's loop waits
// for boxes and multiplies.
//  * Stage A, gather_gemm_rows: each gathered value is read once in its
//    store type, scaled once and split once a call (per index set: once
//    for every member when they share one), a 16-byte piece of 4 values a
//    thread: written to x_res as it is when the caller asks for it, and
//    its TF32 hi and lo parts to two planes [sets, M, P] of scratch (P =
//    k*D rounded up to 4 values, so TMA can take the rows).  Bound by
//    bytes.
//  * Stage B, gather_gemm_kernel, launched as a programmatic dependent of
//    stage A (it sets up while A runs; its producer waits for A's planes
//    before the first box): a block computes z[128 rows, 128 columns] of
//    one member as z^T = W A^T, so that W, which changes every step and is
//    split every call, is the register operand of wgmma: each of the two
//    consumer warpgroups loads its 64 W rows of a 32-deep chunk from the
//    chunk's swizzled box into the m16n8k8 fragment layout, splits them in
//    registers (no shared-memory stores, no barrier between the
//    warpgroups), and runs wgmma.mma_async m64n128k8 tf32 with the rows'
//    hi and lo planes as the shared-memory operand (both K-major, 128-byte
//    swizzled, one TMA box each a chunk).  A producer thread keeps a ring
//    of 4 stages (W box, hi box, lo box: 48 KB) in flight, its first W
//    boxes issued before it waits for A; its warpgroup gives its
//    registers to the consumers (setmaxnreg: 232 a consumer thread, which
//    hold a chunk's fresh sum, the running sum and the W fragments
//    without spilling).  One block an SM.
//  * The tensor cores truncate as they accumulate, so each chunk's twelve
//    products go into fresh registers and are then added to the f32 sum
//    on the CUDA cores (with one accumulator over K, K2's mma.sync design
//    erred 42 times as much as the plain version).  The loop holds no
//    branch on the thread: ptxas serializes wgmma in a divergent path
//    (C7520).
//  * Members: N members' columns are N grid rows (blockIdx.y) of one
//    launch, over one pair of planes when they share an index set.
//  * Split K only where one member's tiles leave SMs without a block: the
//    K slices of a tile (ops/gather_gemm.py::f32_plan, from one member's
//    shape, never from N, so member k's z is bitwise its solo launch's)
//    are one thread block cluster of up to 16 blocks, as many as keep
//    one member's clusters resident at once (5 at the flagship: 100
//    blocks), summed through distributed shared memory in slice order,
//    at any N (one block a tile running its slices in turn, as the
//    bfloat16 kernel does with members, was slower here at 4 and 8
//    members, PERF.md).  No atomics and no float32 partials in
//    device memory: a second call gives the same bits.
//  * Widths whose rows TMA cannot take (k*D not a multiple of 4, a weight
//    not 16-byte aligned): the planes are padded to P, and
//    gather_gemm_repitch copies W into rows of P values first.
// Indices are not checked here: the Python wrapper only launches with
// indices it checked on the host (0 <= idx < R).

#include <cuda.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "bf16.cuh"
#include "smem_optin.cuh"
#include "tf32_wgmma.cuh"
#include "tf32x3.cuh"
#include "wgmma_bf16.cuh"

namespace {

using ta3n::bf16;

// stage A: one 16-byte piece (4 float32 values) of a gathered row a thread
constexpr int kRowsThreads = 256;

// stage B
constexpr int kTileH = 128;  // output columns (W rows), 64 a warpgroup
constexpr int kTileM = 128;  // output rows (gathered rows)
constexpr int kTileK = 32;   // one 128-byte row of float32
constexpr int kMaxSplits = 16;  // a cluster past 8 opts in
// two consumer warpgroups and a producer warpgroup, whose first thread
// issues the boxes: a whole warpgroup, so that the block's registers are
// those of 384 threads and setmaxnreg can move the producer's to the
// consumers (a block of 288 threads is allocated as 384 too)
constexpr int kThreads = ta3n::kConsumers + 128;
constexpr int kProducerRegs = 40, kConsumerRegs = 232;
static_assert(2 * 128 * kConsumerRegs + 128 * kProducerRegs <= 65536,
              "the register file");
// a stage: the W box (128 rows of 128 bytes), then the hi and the lo box
// of the rows (as many); the ring's kStages stages from a 1024-byte
// aligned base, then each stage's full and empty mbarriers (kSmem asks
// for 1024 bytes more, to align the base)
constexpr int kBoxBytes = 128 * 128;
constexpr int kStageBytes = 3 * kBoxBytes;
constexpr int kStages = 4;
constexpr int kBars = kStages * kStageBytes;
constexpr int kSmem = kBars + 2 * kStages * 8 + 1024;
static_assert(kSmem <= 232448, "the 227 KB opt-in");
static_assert(2 * kSmem > 228 * 1024, "one block an SM");
// the float32 partial tile of a K slice, z's rows by z's columns, over the
// ring once the products are done; rows padded so that a warp's stores
// fall in distinct banks
constexpr int kRedPitch = kTileH + 4;
static_assert(kTileM * kRedPitch * 4 <= kBars, "the partial tile fits");

// The value as the product and x_res see it.
template <class S>
__device__ __forceinline__ float value(S v, float rs, float qs) {
  if constexpr (std::is_same_v<S, float>)
    return v * rs;
  else if constexpr (std::is_same_v<S, bf16>)
    return __fmul_rn(__bfloat162float(v), rs);
  else
    return __fmul_rn(__fmul_rn(static_cast<float>(v), qs), rs);
}

// Four values of a store row: one 16-byte load of float32, an 8-byte load
// of bfloat16, a 4-byte load of int8.
__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
}
__device__ __forceinline__ void load4(const bf16* p, bf16 (&v)[4]) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  v[0] = __ushort_as_bfloat16(static_cast<unsigned short>(u.x));
  v[1] = __ushort_as_bfloat16(static_cast<unsigned short>(u.x >> 16));
  v[2] = __ushort_as_bfloat16(static_cast<unsigned short>(u.y));
  v[3] = __ushort_as_bfloat16(static_cast<unsigned short>(u.y >> 16));
}
__device__ __forceinline__ void load4(const int8_t* p, int8_t (&v)[4]) {
  const unsigned u = *reinterpret_cast<const unsigned*>(p);
#pragma unroll
  for (int e = 0; e < 4; ++e) v[e] = static_cast<int8_t>(u >> (8 * e));
}

// Stage A: thread p of index set blockIdx.y takes piece p % ceil(D/4)
// (values 4*(p % pieces) ..) of gathered row q = p / pieces, into x_res
// (unless null) [sets, M*k, D] and the hi and lo planes a and a + plane
// [sets, M, pitch], at row q / k, columns (q % k) * D ...  Gathered row q
// is store row idx[q / streams] * streams + q % streams, scaled by
// scale[q / streams] (1 where scale is null); set s reads idx and scale
// at s * idx_stride.  kVec: D % 4 == 0 and 16-byte aligned store and
// x_res, so a piece is one load and three stores.
template <class S, bool kVec>
__global__ void __launch_bounds__(kRowsThreads)
    gather_gemm_rows(const S* __restrict__ store,
                     const float* __restrict__ qscale,
                     const int* __restrict__ idx,
                     const float* __restrict__ scale,
                     float* __restrict__ x_res, float* __restrict__ a,
                     long long q_rows, int streams, int d, int k_rows,
                     int pitch, long long plane, long long idx_stride) {
  // stage B may be launched now: it waits for this grid's stores
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const int pieces = (d + 3) / 4;
  const long long p =
      static_cast<long long>(blockIdx.x) * kRowsThreads + threadIdx.x;
  if (p >= q_rows * pieces) return;
  const long long set = blockIdx.y;
  const long long q = p / pieces;
  const int col = static_cast<int>(p % pieces) * 4;
  const long long n = q / streams;
  const long long r = idx[set * idx_stride + n];
  const S* src = store + (r * streams + q % streams) * d + col;
  const float rs = scale != nullptr ? scale[set * idx_stride + n] : 1.f;
  float qs = 1.f;
  if constexpr (std::is_same_v<S, int8_t>) qs = qscale[r];
  float v[4];
  unsigned hi[4], lo[4];
  if constexpr (kVec) {
    S in[4];
    load4(src, in);
#pragma unroll
    for (int e = 0; e < 4; ++e) v[e] = value<S>(in[e], rs, qs);
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      v[e] = col + e < d ? value<S>(src[e], rs, qs) : 0.f;
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) ta3n::split_tf32(v[e], hi[e], lo[e]);
  const long long m_rows = q_rows / k_rows;
  float* row = a + (set * m_rows + q / k_rows) * pitch + (q % k_rows) * d +
               col;
  float* xr = x_res != nullptr ? x_res + (set * q_rows + q) * d + col
                               : nullptr;
  if constexpr (kVec) {
    *reinterpret_cast<uint4*>(row) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
    *reinterpret_cast<uint4*>(row + plane) =
        make_uint4(lo[0], lo[1], lo[2], lo[3]);
    if (xr != nullptr)
      *reinterpret_cast<float4*>(xr) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (col + e >= d) break;
      row[e] = __uint_as_float(hi[e]);
      row[plane + e] = __uint_as_float(lo[e]);
      if (xr != nullptr) xr[e] = v[e];
    }
  }
}

// The rows [rows, cols] of w into out, `pitch` values apart: a weight
// whose rows TMA cannot take, for stage B.
__global__ void gather_gemm_repitch(const float* __restrict__ w,
                                    float* __restrict__ out, long long rows,
                                    int cols, int pitch) {
  for (long long e = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       e < rows * cols; e += static_cast<long long>(gridDim.x) * blockDim.x)
    out[e / cols * pitch + e % cols] = w[e];
}

// The tensor maps of stage B: the planes [2 * sets, M, k*D] (hi planes,
// then lo) and W [members, H, k*D], boxes of 32 x 128 x 1, 128-byte
// swizzle.
struct Maps {
  CUtensorMap a, w;
};

// Stage B.  Block (blockIdx.x = row tile * col_tiles + column tile,
// member blockIdx.y, K slice blockIdx.z of gridDim.z slices, a cluster
// along z): z[member, 128 rows, 128 columns] of z [members, M, H] from
// the planes of index set `set` (0 when shared, else the member; its lo
// plane is layer sets + set) and the member's W.  quads: z rows may be
// written 4 values at a time (H a multiple of 4, z 16-byte aligned).
__global__ void __launch_bounds__(kThreads, 1)
    gather_gemm_kernel(const __grid_constant__ Maps maps,
                       float* __restrict__ z, long long m_rows, int h,
                       int kd, int col_tiles, int sets, int shared_rows,
                       int quads) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (ta3n::smem_addr(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kBars);
  uint64_t* empty = full + kStages;
  const int tid = threadIdx.x;
  const int member = blockIdx.y;
  const long long m0 =
      static_cast<long long>(blockIdx.x / col_tiles) * kTileM;
  const int h0 = static_cast<int>(blockIdx.x % col_tiles) * kTileH;
  const int split = blockIdx.z, splits = gridDim.z;
  const int set = shared_rows ? 0 : member;
  // this block's K slice, in 32-deep chunks
  const int chunks = (kd + kTileK - 1) / kTileK;
  const int c_begin = chunks * split / splits;
  const int n = chunks * (split + 1) / splits - c_begin;
  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      ta3n::mbar_init(&full[s], 1);   // the producer
      ta3n::mbar_init(&empty[s], 2);  // the consumer warpgroups
    }
    ta3n::mbar_fence_init();
  }
  __syncthreads();

  // one branch a role, never rejoined, so that setmaxnreg holds
  if (tid >= ta3n::kConsumers) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
        kProducerRegs));
    if (tid == ta3n::kConsumers) {
      // the producer: chunk c_begin + i into stage i % kStages, W's box
      // first, then the rows' hi and lo boxes, all on the stage's full
      // barrier.  W is ready before stage A ends (a repitched W was
      // written by a kernel that ended before A began): the ring's first
      // W boxes, then wait for A's planes
      auto produce_w = [&](int i) {
        const int s = i % kStages;
        ta3n::mbar_arrive_expect_tx(&full[s], kStageBytes);
        ta3n::tma_load_3d(smem + s * kStageBytes, &maps.w,
                          (c_begin + i) * kTileK, h0, member, &full[s]);
      };
      for (int i = 0; i < n; ++i) {
        const int s = i % kStages;
        if (i == 0) {
          for (int f = 0; f < kStages && f < n; ++f) produce_w(f);
          asm volatile("griddepcontrol.wait;\n" ::: "memory");
        } else if (i >= kStages) {
          ta3n::mbar_wait(&empty[s], (i / kStages - 1) & 1);
          produce_w(i);
        }
        unsigned char* st = smem + s * kStageBytes;
        const int k0 = (c_begin + i) * kTileK;
        ta3n::tma_load_3d(st + kBoxBytes, &maps.a, k0, static_cast<int>(m0),
                          set, &full[s]);
        ta3n::tma_load_3d(st + 2 * kBoxBytes, &maps.a, k0,
                          static_cast<int>(m0), sets + set, &full[s]);
      }
    }
    // the consumers' two cluster barriers below
    ta3n::cluster_sync();
    ta3n::cluster_sync();
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
      kConsumerRegs));

  // the consumers: warpgroup wg on W rows 64wg.. of the tile, so this
  // thread's accumulators are z^T[64wg + 16w + l/4 + 8i][8j + 2(l%4) + e]
  // at acc[4j + 2i + e] (w its warp, l its lane)
  const int wg = tid / 128, warp = tid % 128 / 32, lane = tid % 32;
  // the byte offset in a W box of the fragment value (k step kk, register
  // r): row 64wg + 16w + l/4 + 8(r % 2), column 8kk + l%4 + 4(r / 2), in
  // the 128-byte swizzle (the row's 16-byte pieces XOR its row % 8, which
  // is l/4)
  const unsigned row0 = (64 * wg + 16 * warp + lane / 4) * 128;
  const unsigned key = (lane / 4) << 4;
  auto at = [&](int kk, int r) {
    return row0 + 8 * 128 * (r % 2) +
           ((32 * kk + 4 * (lane % 4) + 16 * (r / 2)) ^ key);
  };
  float acc[64], part[64];
  for (int i = 0; i < n; ++i) {
    const int s = i % kStages;
    ta3n::mbar_wait(&full[s], (i / kStages) & 1);
    const unsigned char* st = smem + s * kStageBytes;
    unsigned w_hi[kTileK / 8][4], w_lo[kTileK / 8][4];
#pragma unroll
    for (int kk = 0; kk < kTileK / 8; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        ta3n::split_tf32(*reinterpret_cast<const float*>(st + at(kk, r)),
                         w_hi[kk][r], w_lo[kk][r]);
    const uint64_t b_hi = ta3n::kmajor_desc(st + kBoxBytes);
    const uint64_t b_lo = ta3n::kmajor_desc(st + 2 * kBoxBytes);
    ta3n::fence_operands(part);
    ta3n::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kTileK / 8; ++kk) {
      const uint64_t step = kk * ta3n::kKMajorStep;
      ta3n::tf32::wgmma_tf32(part, w_lo[kk], b_hi + step, kk > 0);
      ta3n::tf32::wgmma_tf32(part, w_hi[kk], b_lo + step, 1);
      ta3n::tf32::wgmma_tf32(part, w_hi[kk], b_hi + step, 1);
    }
    ta3n::wgmma_commit();
    ta3n::wgmma_wait<0>();
    ta3n::fence_operands(part);
    ta3n::tf32::arrive_if(&empty[s], tid % 128 == 0);
#pragma unroll
    for (int e = 0; e < 64; ++e)
      acc[e] = i == 0 ? part[e] : acc[e] + part[e];
  }

  // every slice's partial tile in its block's shared memory (over the
  // ring, once every product of the block is done: every box has landed),
  // as z's rows; then each block sums rows [r0, r1) of the tile over the
  // cluster's slices in order (one slice where the block is its own
  // cluster)
  ta3n::named_sync(ta3n::kConsumers);
  float* red = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int j = 0; j < kTileM / 8; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        red[(8 * j + 2 * (lane % 4) + e) * kRedPitch + 64 * wg + 16 * warp +
            lane / 4 + 8 * i] = acc[4 * j + 2 * i + e];
  ta3n::cluster_sync();
  z += static_cast<long long>(member) * m_rows * h;
  const int r0 = kTileM * split / splits;
  const int r1 = kTileM * (split + 1) / splits;
  const unsigned base = ta3n::smem_addr(red);
  constexpr int kQuads = kTileH / 4;
  for (int e = tid; e < (r1 - r0) * kQuads; e += ta3n::kConsumers) {
    const int row = r0 + e / kQuads, col = e % kQuads * 4;
    const unsigned addr = base + (row * kRedPitch + col) * 4;
    // every slice's four values first (the remote loads in flight
    // together), then their sum in slice order
    float4 v[kMaxSplits];
#pragma unroll
    for (int s = 0; s < kMaxSplits; ++s)
      if (s < splits) v[s] = ta3n::ld_cluster4(addr, s);
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
    float* dst = z + om * h + oh;
    if (quads) {
      *reinterpret_cast<float4*>(dst) = sum;
    } else {
      const float o[4] = {sum.x, sum.y, sum.z, sum.w};
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (oh + u < h) dst[u] = o[u];
    }
  }
  // no block leaves while the others read its shared memory
  ta3n::cluster_sync();
}

// Above 48 KB of dynamic shared memory a kernel must opt in, once on each
// device, and past 8 blocks a cluster (smem_optin.cuh).
cudaError_t allow_smem() {
  static std::atomic<int> granted[ta3n::kMaxDevices];
  return ta3n::allow_smem_on_device(gather_gemm_kernel, granted, kSmem,
                                    true);
}

bool aligned(const void* p, unsigned bytes) {
  return reinterpret_cast<unsigned long long>(p) % bytes == 0;
}

template <class S>
int launch(const void* store, const void* qscale, const void* idx,
           const void* scale, const void* w, void* z, void* x_res,
           void* scratch, long long m_rows, int streams, int d, int k_rows,
           int h, int splits, int members, long long idx_stride,
           cudaStream_t stream) {
  const long long kd = static_cast<long long>(k_rows) * d;
  const long long pitch = (kd + 3) / 4 * 4;
  const long long chunks = (kd + kTileK - 1) / kTileK;
  const long long tiles = (m_rows + kTileM - 1) / kTileM *
                          ((h + kTileH - 1) / kTileH);
  const int sets = idx_stride != 0 ? members : 1;
  const long long q_rows = m_rows * k_rows;
  const long long rows_blocks =
      (q_rows * ((d + 3) / 4) + kRowsThreads - 1) / kRowsThreads;
  if (members > 65535 || tiles > 0x7fffffffLL || rows_blocks > 0x7fffffffLL ||
      m_rows > 0x7fffffffLL || splits < 1 || splits > kMaxSplits ||
      splits > chunks || scratch == nullptr || !aligned(scratch, 16))
    return static_cast<int>(cudaErrorInvalidValue);
  // the operands of stage B: the planes in scratch (ops/gather_gemm.py::
  // f32_plan sizes it alike), then W's rows where TMA cannot take the
  // weight's
  float* planes = static_cast<float*>(scratch);
  const long long plane = sets * m_rows * pitch;
  const bool w_direct = kd % 4 == 0 && aligned(w, 16);
  float* w_rows = w_direct ? nullptr : planes + 2 * plane;
  Maps maps{};
  int err = ta3n::tf32::operand_map(planes, kd, m_rows, 2 * sets, pitch,
                                     kTileM, &maps.a);
  if (err == 0)
    err = w_direct ? ta3n::weight_map(w, kd, h, members, kTileK, kTileH,
                                      &maps.w,
                                      CU_TENSOR_MAP_DATA_TYPE_FLOAT32)
                   : ta3n::tf32::operand_map(w_rows, kd, h, members, pitch,
                                              kTileH, &maps.w);
  if (err != 0) return err;
  const cudaError_t attr = allow_smem();
  if (attr != cudaSuccess) return static_cast<int>(attr);

  if (!w_direct) {
    const long long count = static_cast<long long>(members) * h * kd;
    const long long blocks = (count + 255) / 256;
    gather_gemm_repitch<<<static_cast<unsigned>(
                              blocks < 4096 ? blocks : 4096),
                          256, 0, stream>>>(
        static_cast<const float*>(w), w_rows,
        static_cast<long long>(members) * h, static_cast<int>(kd),
        static_cast<int>(pitch));
  }
  // stage A: x_res (unless null) and the planes
  const bool vec = d % 4 == 0 && aligned(store, 16) &&
                   (x_res == nullptr || aligned(x_res, 16));
  (vec ? gather_gemm_rows<S, true> : gather_gemm_rows<S, false>)
      <<<dim3(static_cast<unsigned>(rows_blocks), sets), kRowsThreads, 0,
         stream>>>(static_cast<const S*>(store),
                   static_cast<const float*>(qscale),
                   static_cast<const int*>(idx),
                   static_cast<const float*>(scale),
                   static_cast<float*>(x_res), planes, q_rows, streams, d,
                   k_rows, static_cast<int>(pitch), plane, idx_stride);
  const cudaError_t rows_err = cudaGetLastError();
  if (rows_err != cudaSuccess) return static_cast<int>(rows_err);

  // stage B, launched while stage A runs (programmatic dependent launch),
  // a tile's K slices one cluster
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(static_cast<unsigned>(tiles), members, splits);
  config.blockDim = dim3(kThreads);
  config.dynamicSmemBytes = kSmem;
  config.stream = stream;
  cudaLaunchAttribute attrs[2];
  attrs[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attrs[0].val.programmaticStreamSerializationAllowed = 1;
  attrs[1].id = cudaLaunchAttributeClusterDimension;
  attrs[1].val.clusterDim.x = 1;
  attrs[1].val.clusterDim.y = 1;
  attrs[1].val.clusterDim.z = static_cast<unsigned>(splits);
  config.attrs = attrs;
  config.numAttrs = 2;
  const cudaError_t gemm = cudaLaunchKernelEx(
      &config, gather_gemm_kernel, maps, static_cast<float*>(z), m_rows, h,
      static_cast<int>(kd), static_cast<int>((h + kTileH - 1) / kTileH),
      sets, idx_stride == 0 ? 1 : 0, h % 4 == 0 && aligned(z, 16) ? 1 : 0);
  if (gemm != cudaSuccess) return static_cast<int>(gemm);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

namespace ta3n {
// gather_gemm_bf16.cu: the bfloat16-compute kernels
int launch_gather_gemm_bf16(const void* store, const void* qscale,
                            const void* idx, const void* scale,
                            const void* w, void* z, void* x_res,
                            void* scratch, long long m_rows, int streams,
                            int d, int k_rows, int h, int splits,
                            int store_kind, int members,
                            long long idx_stride, cudaStream_t stream);
}  // namespace ta3n

// store [rows*streams, d] of the element type store_kind (0 float32, 1
// bfloat16, 2 int8, whose qscale [rows] f32 holds each store row's scale;
// null for the others), w [h, k_rows*d], z [m, h] and (unless null) x_res
// [m, k_rows*d] of the compute type compute_kind (0 float32, 1 bfloat16):
// contiguous on the current device, where m = n_idx*streams/k_rows.  idx
// [n_idx] int32 and scale [n_idx] f32 (null: every scale 1) on the same
// device.  Every idx must lie in [0, rows): the caller checks.  splits K
// slices, summed within a thread block cluster: 1..16 at compute kind 0
// (at most one a 32-deep chunk of k*D), 1, 2, 4 or 8 at 1 (at most one a
// 64-deep chunk; in turn in one block where the clusters would not fit
// the SMs); part is scratch of ops/gather_gemm.py's plan: f32_plan's
// float32 values at compute kind 0 (the rows' TF32 planes, then W's rows
// where W's are not 16-byte aligned), bf16_plan's bfloat16 values at 1
// (null when it
// is 0).  An unknown kind is refused.  members (1 for a solo call)
// stacked members, one after another in w [members, h, k_rows*d] and z
// [members, m, h]; with per_member_idx 0 they share idx and scale, and
// x_res [m, k_rows*d] is written once; with 1, idx and scale are [members,
// n_idx] and x_res [members, m, k_rows*d].  Each member's blocks do the
// work of a one-member launch on its inputs.  Launches on `stream` and
// returns the first error.
extern "C" int ta3n_gather_gemm_members(
    const void* store, const void* qscale, const void* idx, const void* scale,
    const void* w, void* z, void* x_res, void* part, int n_idx, int streams,
    int d, int k_rows, int h, int splits, int store_kind, int compute_kind,
    int members, int per_member_idx, void* stream) {
  if (n_idx < 1 || streams < 1 || d < 1 || k_rows < 1 || h < 1 ||
      splits < 1 || splits > kMaxSplits || store_kind < 0 ||
      store_kind > 2 || compute_kind < 0 || compute_kind > 1 ||
      ((store_kind == 2) != (qscale != nullptr)) || members < 1 ||
      per_member_idx < 0 || per_member_idx > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long gathered = static_cast<long long>(n_idx) * streams;
  if (gathered % k_rows != 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long m_rows = gathered / k_rows;
  if (static_cast<long long>(k_rows) * d > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long stride = per_member_idx ? n_idx : 0;
  if (compute_kind == 1)
    return ta3n::launch_gather_gemm_bf16(store, qscale, idx, scale, w, z,
                                         x_res, part, m_rows, streams, d,
                                         k_rows, h, splits, store_kind,
                                         members, stride, s);
  if (store_kind == 0)
    return launch<float>(store, qscale, idx, scale, w, z, x_res, part,
                         m_rows, streams, d, k_rows, h, splits, members,
                         stride, s);
  if (store_kind == 1)
    return launch<bf16>(store, qscale, idx, scale, w, z, x_res, part, m_rows,
                        streams, d, k_rows, h, splits, members, stride, s);
  return launch<int8_t>(store, qscale, idx, scale, w, z, x_res, part,
                        m_rows, streams, d, k_rows, h, splits, members,
                        stride, s);
}
