// Fused row gather + first-FC GEMM, for Hopper (sm_90a): float32 at f32
// accuracy on the tensor cores (3xTF32), from a float32, bfloat16 or int8
// store; and the C entry of every variant (bfloat16 compute:
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
// What bounds it on the card.  At the flagship train step (N = 640 source
// rows, D = 2048, H = 512) the work is 2*N*D*H = 1.34 GFLOP against 16 MB
// moved (the rows, x_res, W and z), 4.8 us at 3.35 TB/s.  In 3xTF32 the
// tensor cores do three products per pair, 4.0 GFLOP, 8.1 us at the dense
// TF32 rate of 495 TFLOP/s: bound by operations.  On the H100 mma.sync
// reaches about 260 TFLOP/s of TF32, and the split of each operand costs
// about as many instructions as the products (PERF.md).
//
// What the design does about that.
//  * mma.sync m16n8k8 TF32 with the 3xTF32 split (tf32x3.cuh): each row
//    value is scaled by its row_scale in f32 first (the value x_res and
//    the plain version hold), then split.  Rows [M, K] and W [H, K] are
//    both K-major, so the fragments are 32-bit loads from staged rows
//    padded to 36 floats: conflict-free (bank 4g + t).
//  * A 64 x 64 tile per block of 4 warps, each warp 32 x 32 (2 x 4 m16n8
//    tiles, eight independent mma.sync a pass); three blocks fit on an SM.
//    Each 32-deep K chunk is summed into fresh registers and then added to
//    the f32 sum (add_to), against the tensor core's truncating
//    accumulation.
//  * A ring of 4 stages of 32-deep K chunks in dynamic shared memory,
//    filled by cp.async (16-byte copies where D % 4 == 0 and the pointers
//    are 16-byte aligned, else 4-byte copies: D = 37 or 22).  Out-of-range
//    rows and columns are zero-filled by the copy.  A chunk never crosses
//    a gathered row, so it has one row address and one scale per row.
//  * Each thread stages half a row of the row tile (16 floats a chunk) and
//    holds its 64-bit address (an idx*D offset passes 2^31 at about 1M
//    rows of 2048) and scale, recomputed only when the chunk passes to the
//    next gathered row; and half a W row.
//  * Split K: gridDim.z blocks share an output tile, each over a slice of
//    the K chunks, into a scratch [splits, M, H]; a second kernel sums the
//    slices in a fixed order.  No atomics: a second run gives the same
//    bits.  With one split the kernel writes z directly.
//  * Masked rows have scale 0, so they are exactly 0 as in JAX's x * mask;
//    the blocks of column tile 0 (blockIdx.y == 0) write the scaled rows of
//    their K slice to x_res from shared memory, so no row is written
//    twice; without x_res (eval, inference) that write is skipped.
// Indices are not checked here: the Python wrapper only launches with
// indices it checked on the host (0 <= idx < R).
//
// Members (ensembles): N weights [N, H, K] over one store in one launch,
// the member folded into blockIdx.y beside the H tiles; with one index set
// for every member the rows are gathered N times (from L2 after the
// first) and x_res is written once, by member 0's blocks.  The K slices
// are chosen from one member's tiles, so each member's z is bitwise its
// solo launch's.
//
// Store variants (three kernels of one template: store float32, bfloat16
// or int8, W float32).  The store stays in its dtype in device memory and
// is staged so (an int8 row of 32 values is 32 bytes, a bfloat16 one 64),
// a quarter or half the float32 bytes.  An int8 store's row q comes with
// its float32 scale (one per store row, for all its streams); the value
// staged into the product and x_res is
//     __fmul_rn(__fmul_rn(float(q), scale[row]), row_scale)
// two rounded multiplies in that order and no FMA: the JAX step's
// device_gather (q.astype(f32) * scale) followed by x * mask, bit for bit.
// A bfloat16 store's value is float(v) * row_scale.  Every value is split
// for 3xTF32 (a bfloat16 row times a 0/1 mask is exact in TF32 and its
// small term is then 0, but the kernel does not assume the mask).
// bfloat16 compute (W bfloat16) is gather_gemm_bf16.cu's rows kernel and
// wgmma GEMM, which the C entry below launches for compute kind 1.

#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "bf16.cuh"
#include "smem_optin.cuh"
#include "tf32x3.cuh"

namespace {

using ta3n::bf16;

constexpr int kTileM = 64;
constexpr int kTileH = 64;
constexpr int kTileK = 32;
constexpr int kThreads = 128;  // 4 warps: 2 along M x 2 along H
constexpr int kStages = 4;
constexpr int kRun = 16;             // values staged per thread and row
constexpr int kMaxSplits = 8;

static_assert(kTileK == 2 * kRun && 2 * kTileM == kThreads &&
                  2 * kTileH == kThreads,
              "two threads per staged row of each tile");
static_assert(kTileM == 2 * 32 && kTileH == 2 * 32, "4 warps of 32 x 32");

// padded staged rows, 16-byte aligned: float32 36 values (bank 4g + t),
// bfloat16 40 (bank 20g + t), int8 48 bytes
template <class T>
constexpr int kStride = std::is_same_v<T, float>  ? kTileK + 4
                        : std::is_same_v<T, bf16> ? kTileK + 8
                                                  : kTileK + 16;

// S: the store's element type (float, bf16, int8_t)
template <class S>
struct Stage {
  S x[kTileM][kStride<S>];  // scaled on use, not here
  float w[kTileH][kStride<float>];
  float scale[kTileM];      // row_scale of each staged row
  // an int8 store's scale of each staged row (4 unused floats otherwise)
  float qscale[std::is_same_v<S, int8_t> ? kTileM : 4];
};
template <class S>
constexpr int kSmem = kStages * static_cast<int>(sizeof(Stage<S>));

// A run of 16 int8 values: the byte copy of tf32x3.cuh.
template <bool kVec>
__device__ __forceinline__ void copy_run16(int8_t* dst, const int8_t* src,
                                           const int8_t* fallback,
                                           int valid) {
  ta3n::copy_run16<kVec>(reinterpret_cast<unsigned char*>(dst),
                         reinterpret_cast<const unsigned char*>(src),
                         reinterpret_cast<const unsigned char*>(fallback),
                         valid);
}
template <bool kVec, class T>
__device__ __forceinline__ void copy_run16(T* dst, const T* src,
                                           const T* fallback, int valid) {
  ta3n::copy_run16<kVec>(dst, src, fallback, valid);
}

// The staged value x[r][k] as the product and x_res see it (see the head
// of the file): float32 rows times row_scale; bfloat16 and int8 rows with
// rounded multiplies only.
template <class S>
__device__ __forceinline__ float value(const Stage<S>& st, int r, int k,
                                       float rs) {
  if constexpr (std::is_same_v<S, float>)
    return st.x[r][k] * rs;
  else if constexpr (std::is_same_v<S, bf16>)
    return __fmul_rn(__bfloat162float(st.x[r][k]), rs);
  else
    return __fmul_rn(__fmul_rn(static_cast<float>(st.x[r][k]), st.qscale[r]),
                     rs);
}

// grid (ceil(M/kTileM), members * ceil(H/kTileH), splits): one block per
// output tile, member and K slice; blockIdx.y = member * H tiles + H tile.
// Member m reads W and writes z and part at m times one member's size, and
// reads idx and scale at m * idx_stride (0: one index set for all, whose
// x_res member 0 writes; n_idx: its own, and its own x_res).  kVec: 16-byte copies and x_res stores (D a multiple of a
// 16-byte run of the store's type and of float32, 16-byte aligned store, W
// and x_res).  With splits > 1 the block writes float32 partials into
// part, else z.
template <class S, bool kVec>
__global__ void __launch_bounds__(kThreads, 3)
    gather_gemm_kernel(const S* __restrict__ store,
                       const float* __restrict__ qscale,
                       const int* __restrict__ idx,
                       const float* __restrict__ scale,
                       const float* __restrict__ w, float* __restrict__ z,
                       float* __restrict__ part, float* __restrict__ x_res,
                       long long m_rows, int streams, int d, int k_rows,
                       int h, long long idx_stride) {
  constexpr bool kInt8 = std::is_same_v<S, int8_t>;
  extern __shared__ __align__(128) unsigned char smem[];
  Stage<S>* stage = reinterpret_cast<Stage<S>*>(smem);

  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t = lane % 4;
  const int wm = 32 * (warp % 2), wn = 32 * (warp / 2);
  const long long m0 = static_cast<long long>(blockIdx.x) * kTileM;
  const int h_tiles = (h + kTileH - 1) / kTileH;
  const long long member = blockIdx.y / h_tiles;
  const int h0 = blockIdx.y % h_tiles * kTileH;
  const long long kdim = static_cast<long long>(k_rows) * d;  // W row
  w += member * h * kdim;
  z += member * m_rows * h;
  idx += member * idx_stride;
  if (scale != nullptr) scale += member * idx_stride;
  const bool write_rows = x_res != nullptr && h0 == 0 &&
                          (idx_stride != 0 || member == 0);
  if (write_rows) x_res += member * m_rows * kdim;
  if (gridDim.z > 1)
    part += (member * gridDim.z + blockIdx.z) * m_rows * h;

  // this block's K slice, in chunks of kTileK within one gathered row
  const int per_row = (d + kTileK - 1) / kTileK;
  const long long chunks = static_cast<long long>(k_rows) * per_row;
  const int c_begin = static_cast<int>(chunks * blockIdx.z / gridDim.z);
  const int c_end = static_cast<int>(chunks * (blockIdx.z + 1) / gridDim.z);

  // what this thread stages: values [col, col + kRun) of a chunk, of row
  // m0 + srow and of W row h0 + srow
  const int srow = tid / 2, col = kRun * (tid % 2);
  const long long m = m0 + srow;
  const int gh = h0 + srow;
  int row_j = -1;
  const S* row = nullptr;
  float row_scale = 0.f, row_q = 1.f;

  auto issue = [&](int c, int s) {
    c += c_begin;
    const int j = c / per_row;
    const int c0 = (c % per_row) * kTileK + col;
    Stage<S>& st = stage[s];
    if (j != row_j) {
      row_j = j;
      row = nullptr;
      if (m < m_rows) {
        const long long q = m * k_rows + j;
        const long long n = q / streams;
        const long long r = idx[n];
        row = store + (r * streams + q % streams) * d;
        row_scale = scale != nullptr ? scale[n] : 1.f;
        if constexpr (kInt8) row_q = qscale[r];
      }
    }
    if (tid % 2 == 0) {
      st.scale[srow] = row != nullptr ? row_scale : 0.f;
      if constexpr (kInt8) st.qscale[srow] = row_q;
    }
    copy_run16<kVec>(&st.x[srow][col], row != nullptr ? row + c0 : store,
                     store, row != nullptr ? d - c0 : 0);
    const bool w_in = gh < h;
    copy_run16<kVec>(
        &st.w[srow][col],
        w_in ? w + gh * kdim + static_cast<long long>(j) * d + c0 : w, w,
        w_in ? d - c0 : 0);
  };

  float acc[2][4][4] = {};
  auto compute = [&](int c, int s) {
    const Stage<S>& st = stage[s];
    float sc[2][2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      sc[i][0] = st.scale[wm + 16 * i + g];
      sc[i][1] = st.scale[wm + 16 * i + g + 8];
    }
    float part_acc[2][4][4] = {};
#pragma unroll
    for (int kk = 0; kk < kTileK; kk += 8) {
      float a[2][4], b[4][2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = wm + 16 * i + g;
        a[i][0] = value(st, r, kk + t, sc[i][0]);
        a[i][1] = value(st, r + 8, kk + t, sc[i][1]);
        a[i][2] = value(st, r, kk + t + 4, sc[i][0]);
        a[i][3] = value(st, r + 8, kk + t + 4, sc[i][1]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = wn + 8 * j + g;
        b[j][0] = st.w[n][kk + t];
        b[j][1] = st.w[n][kk + t + 4];
      }
      ta3n::mma_3xtf32(part_acc, a, b);
    }
    ta3n::add_to(acc, part_acc);
    if (write_rows && m < m_rows) {
      c += c_begin;
      const int j = c / per_row;
      const int c0 = (c % per_row) * kTileK + col;
      float* dst = x_res + (m * k_rows + j) * d + c0;
      const float rs = st.scale[srow];
      if constexpr (kVec && std::is_same_v<S, float>) {
        const float* src = &st.x[srow][col];
#pragma unroll
        for (int v = 0; v < kRun / 4; ++v) {
          if (4 * v >= d - c0) break;
          const float4 x4 = *reinterpret_cast<const float4*>(src + 4 * v);
          *reinterpret_cast<float4*>(dst + 4 * v) =
              make_float4(x4.x * rs, x4.y * rs, x4.z * rs, x4.w * rs);
        }
      } else if constexpr (kVec) {
        // 16-byte stores of the values as the product saw them: a run
        // holds whole 16-byte pieces
        constexpr int kPer = 4;
#pragma unroll
        for (int v = 0; v < kRun / kPer; ++v) {
          if (kPer * v >= d - c0) break;
          alignas(16) float vals[kPer];
#pragma unroll
          for (int e = 0; e < kPer; ++e)
            vals[e] = value(st, srow, col + kPer * v + e, rs);
          *reinterpret_cast<uint4*>(dst + kPer * v) =
              *reinterpret_cast<const uint4*>(vals);
        }
      } else {
#pragma unroll
        for (int e = 0; e < kRun; ++e)
          if (e < d - c0)
            dst[e] = value(st, srow, col + e, rs);
      }
    }
  };
  ta3n::pipeline<kStages>(c_end - c_begin, issue, compute);

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const long long om = m0 + wm + 16 * i + g + 8 * half;
        const int oh = h0 + wn + 8 * j + 2 * t;
        if (om >= m_rows) continue;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          if (oh + e >= h) continue;
          const float v = acc[i][j][2 * half + e];
          if (gridDim.z > 1)
            part[om * h + oh + e] = v;
          else
            z[om * h + oh + e] = v;
        }
      }
}

// z[i] = sum over s of part[s][i], s in order: the split-K reduction,
// of each member (member-major, `count` elements each).
__global__ void gather_gemm_reduce(const float* __restrict__ part,
                                   float* __restrict__ z, long long count,
                                   int splits, int members) {
  for (long long e = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       e < count * members;
       e += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long m = e / count, i = e % count;
    const float* p = part + m * splits * count + i;
    float sum = p[0];
    for (int s = 1; s < splits; ++s) sum += p[s * count];
    z[e] = sum;
  }
}

// Above 48 KB of dynamic shared memory a kernel must opt in, once on each
// device (smem_optin.cuh).
template <class S, bool kVec>
cudaError_t allow_smem() {
  static std::atomic<int> granted[ta3n::kMaxDevices];
  return ta3n::allow_smem_on_device(gather_gemm_kernel<S, kVec>, granted,
                                    kSmem<S>);
}

template <class S>
int launch(const void* store, const void* qscale, const void* idx,
           const void* scale, const void* w, void* z, void* x_res,
           void* part, long long m_rows, int streams, int d, int k_rows,
           int h, int splits, int members, long long idx_stride,
           cudaStream_t stream) {
  const long long tiles = (m_rows + kTileM - 1) / kTileM;
  if (tiles > 0x7fffffffLL ||
      static_cast<long long>((h + kTileH - 1) / kTileH) * members > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto aligned = [](const void* p) {
    return reinterpret_cast<unsigned long long>(p) % 16 == 0;
  };
  const bool vec = d % (16 / static_cast<int>(sizeof(S))) == 0 &&
                   d % 4 == 0 && aligned(store) && aligned(w) &&
                   (x_res == nullptr || aligned(x_res));
  const cudaError_t attr =
      vec ? allow_smem<S, true>() : allow_smem<S, false>();
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid(static_cast<unsigned>(tiles),
                  (h + kTileH - 1) / kTileH * members, splits);
  (vec ? gather_gemm_kernel<S, true> : gather_gemm_kernel<S, false>)
      <<<grid, kThreads, kSmem<S>, stream>>>(
          static_cast<const S*>(store), static_cast<const float*>(qscale),
          static_cast<const int*>(idx), static_cast<const float*>(scale),
          static_cast<const float*>(w), static_cast<float*>(z),
          static_cast<float*>(part), static_cast<float*>(x_res), m_rows,
          streams, d, k_rows, h, idx_stride);
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
// device.  Every idx must lie in [0, rows): the caller checks.  splits
// (1..8) K slices; at compute kind 0 with more than one, part is scratch
// of [members, splits, m, h] f32, summed into z by a second kernel in a
// fixed order.  Compute kind 1 launches gather_gemm_bf16.cu's kernels:
// splits 1, 2, 4 or 8, summed within a cluster, and part bfloat16 scratch
// of ops/gather_gemm.py::bf16_plan's size (null when it is 0).  An
// unknown kind is refused.  members (1 for a solo call) stacked members,
// at either compute kind, one after another in w [members, h, k_rows*d]
// and z [members, m, h]; with per_member_idx 0 they share idx and scale,
// and x_res [m, k_rows*d] is written once; with 1, idx and scale are
// [members, n_idx] and x_res [members, m, k_rows*d].  Each member's
// blocks do the work of a one-member launch on its inputs.  Launches on
// `stream` and returns the first error.
extern "C" int ta3n_gather_gemm_members(
    const void* store, const void* qscale, const void* idx, const void* scale,
    const void* w, void* z, void* x_res, void* part, int n_idx, int streams,
    int d, int k_rows, int h, int splits, int store_kind, int compute_kind,
    int members, int per_member_idx, void* stream) {
  if (n_idx < 1 || streams < 1 || d < 1 || k_rows < 1 || h < 1 ||
      splits < 1 || splits > kMaxSplits ||
      (compute_kind == 0 && splits > 1 && part == nullptr) ||
      store_kind < 0 || store_kind > 2 || compute_kind < 0 ||
      compute_kind > 1 || ((store_kind == 2) != (qscale != nullptr)) ||
      members < 1 || per_member_idx < 0 || per_member_idx > 1)
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
  int err;
  if (store_kind == 0)
    err = launch<float>(store, qscale, idx, scale, w, z, x_res, part, m_rows,
                        streams, d, k_rows, h, splits, members, stride, s);
  else if (store_kind == 1)
    err = launch<bf16>(store, qscale, idx, scale, w, z, x_res, part, m_rows,
                       streams, d, k_rows, h, splits, members, stride, s);
  else
    err = launch<int8_t>(store, qscale, idx, scale, w, z, x_res, part,
                         m_rows, streams, d, k_rows, h, splits, members,
                         stride, s);
  if (err != 0 || splits == 1) return err;
  const long long count = m_rows * h;
  const long long blocks = (count * members + 255) / 256;
  gather_gemm_reduce<<<static_cast<unsigned>(blocks < 4096 ? blocks : 4096),
                       256, 0, s>>>(static_cast<const float*>(part),
                                    static_cast<float*>(z), count, splits,
                                    members);
  return static_cast<int>(cudaGetLastError());
}
