// Fused row gather + first-FC GEMM, float32, for Hopper (sm_90a).
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
// rows, D = 2048, H = 512) the work is 2*N*D*H = 1.34 GFLOP, 20 us at the
// 67 TFLOP/s f32 CUDA-core peak, against 16 MB moved (the rows, x_res, W
// and z), 4.8 us at 3.35 TB/s: bound by f32 FMA issue.  Two things stand
// in the way of that peak: the output is small (640 x 512), so output
// tiles alone do not fill 132 SMs, and a thread that stages fewer than
// 8x8 outputs' worth of operands per k step is bound by shared memory
// bandwidth, not by FMA (the first version of this kernel, 2x4 outputs
// per thread, ran at a third of the FMA rate that way).
//
// What the design does about that.
//  * 8x8 outputs per thread from two float4 of rows and two float4 of W
//    per k (4 shared loads for 64 FMA), a [64, 64] tile per block of 64
//    threads.
//  * Split K: gridDim.z blocks share an output tile, each over a slice of
//    the K chunks, into a scratch [splits, M, H]; a second kernel sums the
//    slices in a fixed order.  No atomics: a second run gives the same
//    bits.  With one split the kernel writes z directly.
//  * Each thread stages one row of the row tile and one row of the W tile
//    per chunk (16 consecutive floats of each), so it holds one row
//    address (64-bit: an idx*D offset passes 2^31 at about 1M rows of
//    2048) and one scale, recomputed only when the chunk passes to the
//    next gathered row; its shared-memory stores are conflict-free.
//  * Register prefetch and two shared buffers: the next chunk's loads are
//    in flight while the current one is multiplied; one barrier a chunk.
//  * Each row is scaled by its row_scale as it is loaded, so masked rows
//    are exactly 0 as in JAX's x * mask; exactly one column tile
//    (blockIdx.y == 0) writes the staged rows to x_res, and without x_res
//    (eval, inference) that write is skipped.
//  * f32 FMA on the CUDA cores: no tensor cores, no TF32.
// Ragged M, H and D edges are masked in the loads and the stores.  Indices
// are not checked here: the Python wrapper only launches with indices it
// checked on the host (0 <= idx < R).

#include <cuda_runtime.h>

namespace {

constexpr int kTileM = 64;
constexpr int kTileH = 64;
constexpr int kTileK = 16;
constexpr int kThreads = 64;
constexpr int kPad = 4;  // shared rows stay 16-byte aligned for float4
constexpr int kMaxSplits = 8;

static_assert(kTileM == kThreads && kTileH == kThreads,
              "one row of each tile per thread");
static_assert(kTileM * kTileH == kThreads * 64, "8x8 outputs per thread");

struct Stage {
  float x[kTileK][kTileM + kPad];
  float w[kTileK][kTileH + kPad];
};

// grid (ceil(M/kTileM), ceil(H/kTileH), splits): one block per output tile
// and K slice.  kVec4: rows are loaded as float4 (D % 4 == 0, 16-byte
// aligned store, W and x_res).
template <bool kVec4>
__global__ void __launch_bounds__(kThreads)
    gather_gemm_kernel(const float* __restrict__ store,
                       const int* __restrict__ idx,
                       const float* __restrict__ scale,
                       const float* __restrict__ w, float* __restrict__ out,
                       float* __restrict__ x_res, long long m_rows,
                       int streams, int d, int k_rows, int h) {
  __shared__ __align__(16) Stage stage[2];

  const int tid = threadIdx.x;
  const int tx = tid % 8;  // output columns 4*tx + {0..3}, 32 + 4*tx + ...
  const int ty = tid / 8;  // output rows 4*ty + {0..3}, 32 + 4*ty + ...
  const long long m0 = static_cast<long long>(blockIdx.x) * kTileM;
  const int h0 = blockIdx.y * kTileH;
  const long long kdim = static_cast<long long>(k_rows) * d;  // W row
  const bool write_rows = x_res != nullptr && blockIdx.y == 0;
  if (gridDim.z > 1)
    out += static_cast<long long>(blockIdx.z) * m_rows * h;

  // this block's K slice, in chunks of kTileK within one gathered row
  const int per_row = (d + kTileK - 1) / kTileK;
  const long long chunks = static_cast<long long>(k_rows) * per_row;
  const int c_begin = static_cast<int>(chunks * blockIdx.z / gridDim.z);
  const int c_end = static_cast<int>(chunks * (blockIdx.z + 1) / gridDim.z);

  // the row this thread stages: output row m0 + tid, and W row h0 + tid
  const long long m = m0 + tid;
  const int gh = h0 + tid;
  int row_j = -1;
  const float* row = nullptr;
  float row_scale = 0.f;

  float xr[kTileK], wr[kTileK];
  auto load = [&](int c) {
    const int j = c / per_row;
    const int c0 = (c % per_row) * kTileK;
    if (j != row_j) {
      row_j = j;
      row = nullptr;
      if (m < m_rows) {
        const long long q = m * k_rows + j;
        const long long n = q / streams;
        row = store + (static_cast<long long>(idx[n]) * streams +
                       q % streams) * d;
        row_scale = scale != nullptr ? scale[n] : 1.f;
      }
    }
    const float* wrow =
        gh < h ? w + gh * kdim + static_cast<long long>(j) * d : nullptr;
    float* dst = write_rows && row != nullptr
                     ? x_res + (m * k_rows + j) * d + c0
                     : nullptr;
    if constexpr (kVec4) {
      // D % 4 == 0 and 16-byte aligned rows: 4 float4 per row, each
      // wholly inside or outside the row
#pragma unroll
      for (int v = 0; v < kTileK / 4; ++v) {
        const bool in = c0 + 4 * v < d;
        float4 xv = make_float4(0.f, 0.f, 0.f, 0.f), wv = xv;
        if (row != nullptr && in) {
          xv = *reinterpret_cast<const float4*>(row + c0 + 4 * v);
          xv.x *= row_scale;
          xv.y *= row_scale;
          xv.z *= row_scale;
          xv.w *= row_scale;
          if (dst != nullptr) *reinterpret_cast<float4*>(dst + 4 * v) = xv;
        }
        if (wrow != nullptr && in)
          wv = *reinterpret_cast<const float4*>(wrow + c0 + 4 * v);
        xr[4 * v] = xv.x;
        xr[4 * v + 1] = xv.y;
        xr[4 * v + 2] = xv.z;
        xr[4 * v + 3] = xv.w;
        wr[4 * v] = wv.x;
        wr[4 * v + 1] = wv.y;
        wr[4 * v + 2] = wv.z;
        wr[4 * v + 3] = wv.w;
      }
    } else {
#pragma unroll
      for (int kk = 0; kk < kTileK; ++kk) {
        const bool in = c0 + kk < d;
        xr[kk] = (row != nullptr && in) ? row[c0 + kk] * row_scale : 0.f;
        wr[kk] = (wrow != nullptr && in) ? wrow[c0 + kk] : 0.f;
        if (dst != nullptr && in) dst[kk] = xr[kk];
      }
    }
  };
  auto store_stage = [&](Stage& s) {
#pragma unroll
    for (int kk = 0; kk < kTileK; ++kk) {
      s.x[kk][tid] = xr[kk];
      s.w[kk][tid] = wr[kk];
    }
  };

  float acc[8][8];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[r][c] = 0.f;

  if (c_begin < c_end) {
    load(c_begin);
    store_stage(stage[0]);
  }
  __syncthreads();
  for (int c = c_begin; c < c_end; ++c) {
    const int buf = (c - c_begin) & 1;
    if (c + 1 < c_end) load(c + 1);  // in flight while this chunk runs
    const Stage& s = stage[buf];
#pragma unroll
    for (int kk = 0; kk < kTileK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&s.x[kk][4 * ty]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&s.x[kk][32 + 4 * ty]);
      const float4 b0 = *reinterpret_cast<const float4*>(&s.w[kk][4 * tx]);
      const float4 b1 =
          *reinterpret_cast<const float4*>(&s.w[kk][32 + 4 * tx]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int q = 0; q < 8; ++q) acc[r][q] = fmaf(a[r], b[q], acc[r][q]);
    }
    if (c + 1 < c_end) store_stage(stage[buf ^ 1]);
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const long long om = m0 + (r < 4 ? 4 * ty + r : 32 + 4 * ty + r - 4);
    if (om >= m_rows) continue;
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int oh = h0 + (q < 4 ? 4 * tx + q : 32 + 4 * tx + q - 4);
      if (oh < h) out[om * h + oh] = acc[r][q];
    }
  }
}

// z[i] = sum over s of part[s][i], s in order: the split-K reduction.
__global__ void gather_gemm_reduce(const float* __restrict__ part,
                                   float* __restrict__ z, long long count,
                                   int splits) {
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < count; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    float sum = part[i];
    for (int s = 1; s < splits; ++s) sum += part[s * count + i];
    z[i] = sum;
  }
}

}  // namespace

// store [rows*streams, d], w [h, k_rows*d], z [m, h] and (unless null)
// x_res [m, k_rows*d]: contiguous f32 on the current device, where
// m = n_idx*streams/k_rows.  idx [n_idx] int32 and scale [n_idx] f32 (null:
// every scale 1) on the same device.  Every idx must lie in [0, rows): the
// caller checks.  splits (1..8) K slices; with more than one, part is
// scratch of [splits, m, h] f32.  Launches on `stream` and returns
// cudaGetLastError().
extern "C" int ta3n_gather_gemm_f32(const void* store, const void* idx,
                                    const void* scale, const void* w,
                                    void* z, void* x_res, void* part,
                                    int n_idx, int streams, int d,
                                    int k_rows, int h, int splits,
                                    void* stream) {
  if (n_idx < 1 || streams < 1 || d < 1 || k_rows < 1 || h < 1 ||
      splits < 1 || splits > kMaxSplits || (splits > 1 && part == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long gathered = static_cast<long long>(n_idx) * streams;
  if (gathered % k_rows != 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long m_rows = gathered / k_rows;
  const long long tiles = (m_rows + kTileM - 1) / kTileM;
  const long long chunks =
      static_cast<long long>(k_rows) * ((d + kTileK - 1) / kTileK);
  if (tiles > 0x7fffffffLL || (h + kTileH - 1) / kTileH > 65535 ||
      chunks > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>(tiles), (h + kTileH - 1) / kTileH,
                  splits);
  const auto aligned = [](const void* p) {
    return reinterpret_cast<unsigned long long>(p) % 16 == 0;
  };
  const bool vec4 = d % 4 == 0 && aligned(store) && aligned(w) &&
                    (x_res == nullptr || aligned(x_res));
  (vec4 ? gather_gemm_kernel<true> : gather_gemm_kernel<false>)
      <<<grid, kThreads, 0, s>>>(
          static_cast<const float*>(store), static_cast<const int*>(idx),
          static_cast<const float*>(scale), static_cast<const float*>(w),
          static_cast<float*>(splits > 1 ? part : z),
          static_cast<float*>(x_res), m_rows, streams, d, k_rows, h);
  if (splits > 1) {
    const long long count = m_rows * h;
    const long long blocks = (count + 255) / 256;
    gather_gemm_reduce<<<static_cast<unsigned>(blocks < 4096 ? blocks : 4096),
                         256, 0, s>>>(static_cast<const float*>(part),
                                      static_cast<float*>(z), count, splits);
  }
  return static_cast<int>(cudaGetLastError());
}
