// Fused multi-scale TRN backward, float32 at f32 accuracy on the tensor
// cores (3xTF32), for Hopper (sm_90a).
//
// Replaces ta3n_tpu/ops/trn_fused.py::_bwd_kernel (launched by
// _fused_backward_pallas, the backward of trn_multiscale_fused's custom
// VJP).  From the forward's input x [B, S, D], the upstream gradient
// g [B, S-1, H] and the relu masks [B, n_sub*H] that the training forward
// (csrc/trn_fused_fwd.cu) saved, for every scale i and selected subset j
// (global subset index s) with m = masks[:, s*H:(s+1)*H] * g[:, i, :]:
//     db_i                   += sum_rows m
//     dW_i[:, p*D:(p+1)*D]   += m^T @ relu(x[:, f_jp, :])
//     dx[:, f_jp, :]         += m @ W_i[:, p*D:(p+1)*D]
// and finally dx *= (x > 0).  Weights and their gradients are in torch
// nn.Linear layout [H, k_i*D].  No z is recomputed: the masks carry it.
//
// Two families of GEMMs over the plan, in one launch:
//  * dx: for each frame f one GEMM, M = B, N = D, K = H * (triples of f):
//    A is the (scale, subset, position) triples' m side by side, B the
//    W_i[:, p*D ...] slices.  (x > 0) in the epilogue.  2*B*H*D*32 FLOP:
//    1.69 GFLOP at B=202, H=256, D=512 (32 triples over 5 frames).
//  * dW: for each (scale, position) one GEMM, M = H, N = D,
//    K = B * n_sub_i: A = m^T over the scale's subsets, B = relu(x) of the
//    subset's frame at that position.  The blocks at p = 0 and the first D
//    tile also sum m's columns into db_i.  The same 1.69 GFLOP.
// Blocks run concurrently on Hopper, so the TPU kernel's carry of dW and
// db across a sequential batch-tile grid (trn_fused.py:232-242) does not
// translate: every output element is written by exactly one block, which
// reduces in a fixed order, with no atomics, so runs are bitwise
// reproducible.  B = 0 launches no dx block; the dW blocks then write
// zeros.
//
// What bounds it on the card.  At B=202 (128 source + 74 target videos)
// and the flagship widths the two families do 3.39 GFLOP and must move
// about 20 MB (x, g, masks and 7.3 MB of weights in; dx, and 7.3 MB of dW
// out), 6 us at 3.35 TB/s.  In 3xTF32 that is 10.2 GFLOP of tensor-core
// products, 20.5 us at the dense TF32 rate of 495 TFLOP/s: bound by
// operations.  On the H100 mma.sync reaches about 260 TFLOP/s of TF32,
// and the split of each operand costs about as many instructions as the
// products (PERF.md).
//
// What the design does about that.
//  * mma.sync m16n8k8 TF32 with the 3xTF32 split (tf32x3.cuh).  m is built
//    when a fragment is loaded, from the staged g and uint8 mask tiles
//    (mask ? g : 0), and relu(x) likewise, so both are staged by plain
//    asynchronous copies.  Each 32-deep K chunk is summed into fresh
//    registers and then added to the f32 sum (add_to), against the tensor
//    core's truncating accumulation.
//  * Fragments loaded by hand from shared tiles, since W, x and (for dW)
//    m^T are MN-major in memory and tf32 wgmma takes only K-major shared
//    operands: K-major rows padded to 36 floats (bank 4g + t), MN-major
//    rows to 72 floats (bank 8t + g), mask rows to 48 (dx) and 80 (dW)
//    bytes; every fragment load is conflict-free.
//  * 64 x 64 output tiles per block of 4 warps, each warp 32 x 32.  With a
//    ring of 3 stages of 32-deep K chunks (21 KB each, filled by cp.async,
//    16-byte copies where D % 4 == 0, H % 16 == 0 and the pointers are
//    16-byte aligned; else 4-byte copies, and plain loads for the masks),
//    three blocks fit on an SM.
//  * One grid: its first blocks are the dx tiles (the longer K), the rest
//    the dW tiles, so the two families overlap on the SMs: 160 + 448
//    blocks at the train batch.
// Ragged B, H and D edges are zero-filled by the copies and masked in the
// stores.

#include <cuda_runtime.h>

#include "tf32x3.cuh"

namespace {

constexpr int kMaxFrames = 16;
constexpr int kMaxScales = kMaxFrames - 1;
constexpr int kMaxSubsets = 3;
// a frame is in a subset at most once: at most one triple per subset
constexpr int kMaxTriples = 1 + (kMaxScales - 1) * kMaxSubsets;
// (scale, position) pairs: sum of k = S..2
constexpr int kMaxPositions = kMaxFrames * (kMaxFrames + 1) / 2 - 1;

constexpr int kThreads = 128;  // 4 warps: 2 x 2, each 32 x 32 outputs
constexpr int kTile = 64;      // output tile, both families
constexpr int kTileK = 32;     // K chunk: H (dx) or batch rows (dW)
constexpr int kStages = 3;
constexpr int kRun = 16;       // elements staged per thread and row
// shared rows: K-major (dx's g), MN-major (W, x, dW's g), and the masks
constexpr int kKStride = kTileK + 4;
constexpr int kNStride = kTile + 8;
constexpr int kDxMaskStride = 48, kDwMaskStride = 80;
// a stage: g, masks, then W (dx) or x (dW)
constexpr int kGBytes = kTile * kKStride * 4;
constexpr int kMaskBytes = kTile * kDxMaskStride;
constexpr int kBBytes = kTileK * kNStride * 4;
constexpr int kStageBytes = kGBytes + kMaskBytes + kBBytes;
constexpr int kSmem = kStages * kStageBytes;
static_assert(kTileK * kNStride * 4 <= kGBytes &&
                  kTileK * kDwMaskStride <= kMaskBytes,
              "dW's tiles fit dx's");
static_assert(kGBytes % 16 == 0 && kMaskBytes % 16 == 0 &&
                  kStageBytes % 16 == 0,
              "16-byte aligned tiles");
static_assert(kTile * kTileK == kThreads * kRun &&
                  kTile * kTileK / kThreads == kRun,
              "one run of 16 per thread and tile");

struct Plan {
  const float* w[kMaxScales];  // [H, k*D], row-major
  float* dw[kMaxScales];       // [H, k*D]
  float* db[kMaxScales];       // [H]
  int k[kMaxScales];
  int n_sub[kMaxScales];
  int sub0[kMaxScales];  // index of the scale's first subset, all scales
  int n_sub_total;
  unsigned char frames[kMaxScales][kMaxSubsets][kMaxFrames];
  // per frame: its (scale | subset << 4 | position << 10) triples
  int n_trip[kMaxFrames];
  unsigned short trip[kMaxFrames][kMaxTriples];
  // per dW GEMM: its scale and frame position
  int n_pos;
  unsigned char pos_scale[kMaxPositions];
  unsigned char pos_p[kMaxPositions];
};

struct Stage {
  float* g;
  unsigned char* mask;
  float* b;  // W (dx) or x (dW)
};

__device__ __forceinline__ Stage stage_at(unsigned char* smem, int s) {
  unsigned char* base = smem + s * kStageBytes;
  return {reinterpret_cast<float*>(base), base + kGBytes,
          reinterpret_cast<float*>(base + kGBytes + kMaskBytes)};
}

// m = mask ? g : 0 from a staged tile
__device__ __forceinline__ float masked(const Stage& st, int g_at,
                                        int mask_at) {
  return st.mask[mask_at] ? st.g[g_at] : 0.f;
}

// The dx tile `blk`: frame f, batch rows b0.., D columns d0...
template <bool kVec4>
__device__ __forceinline__ void dx_tile(
    const Plan& plan, const float* __restrict__ x,
    const float* __restrict__ g, const unsigned char* __restrict__ masks,
    float* __restrict__ dx, int batch, int num_frames, int d, int h, int blk,
    unsigned char* smem) {
  const int tiles_b = (batch + kTile - 1) / kTile;
  const int tiles_d = (d + kTile - 1) / kTile;
  const int f = blk / (tiles_b * tiles_d);
  const int rem = blk % (tiles_b * tiles_d);
  const int b0 = rem / tiles_d * kTile, d0 = rem % tiles_d * kTile;
  const int n_scales = num_frames - 1;
  const int h_chunks = (h + kTileK - 1) / kTileK;

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int gq = lane / 4, t = lane % 4;
  const int wm = 32 * (warp % 2), wn = 32 * (warp / 2);
  // staged by this thread: g and mask of batch row b0 + ar, H columns
  // [ac, ac + kRun) of the chunk; W row br of the chunk, D columns
  // d0 + bc + [0, kRun)
  const int ar = tid / 2, ac = kRun * (tid % 2);
  const int br = tid / 4, bc = kRun * (tid % 4);
  const int gb = b0 + ar;
  const bool row_in = gb < batch;

  auto issue = [&](int c, int s) {
    const int trip = plan.trip[f][c / h_chunks];
    const int i = trip & 15, sub = (trip >> 4) & 63, p = trip >> 10;
    const int hk = c % h_chunks * kTileK;
    const Stage st = stage_at(smem, s);
    const int hh = hk + ac;
    ta3n::copy_run16<kVec4>(
        st.g + ar * kKStride + ac,
        row_in ? g + (static_cast<long long>(gb) * n_scales + i) * h + hh : g,
        g, row_in ? h - hh : 0);
    ta3n::copy_run16<kVec4>(
        st.mask + ar * kDxMaskStride + ac,
        row_in ? masks + (static_cast<long long>(gb) * plan.n_sub_total +
                          sub) * h + hh
               : masks,
        masks, row_in ? h - hh : 0);
    const int wh = hk + br;
    const float* w = plan.w[i];
    ta3n::copy_run16<kVec4>(
        st.b + br * kNStride + bc,
        wh < h ? w + static_cast<long long>(wh) * plan.k[i] * d +
                     static_cast<long long>(p) * d + d0 + bc
               : w,
        w, wh < h ? d - d0 - bc : 0);
  };

  float acc[2][4][4] = {};
  auto compute = [&](int, int s) {
    const Stage st = stage_at(smem, s);
    float part[2][4][4] = {};
#pragma unroll
    for (int kk = 0; kk < kTileK; kk += 8) {
      float a[2][4], b[4][2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = wm + 16 * i + gq;
        const int k0 = kk + t;
        a[i][0] = masked(st, r * kKStride + k0, r * kDxMaskStride + k0);
        a[i][1] = masked(st, (r + 8) * kKStride + k0,
                         (r + 8) * kDxMaskStride + k0);
        a[i][2] = masked(st, r * kKStride + k0 + 4,
                         r * kDxMaskStride + k0 + 4);
        a[i][3] = masked(st, (r + 8) * kKStride + k0 + 4,
                         (r + 8) * kDxMaskStride + k0 + 4);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = wn + 8 * j + gq;
        b[j][0] = st.b[(kk + t) * kNStride + n];
        b[j][1] = st.b[(kk + t + 4) * kNStride + n];
      }
      ta3n::mma_3xtf32(part, a, b);
    }
    ta3n::add_to(acc, part);
  };
  ta3n::pipeline<kStages>(plan.n_trip[f] * h_chunks, issue, compute);

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int b = b0 + wm + 16 * i + gq + 8 * half;
        if (b >= batch) continue;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = d0 + wn + 8 * j + 2 * t + e;
          if (col >= d) continue;
          const long long at =
              (static_cast<long long>(b) * num_frames + f) * d + col;
          dx[at] = x[at] > 0.f ? acc[i][j][2 * half + e] : 0.f;
        }
      }
}

// The dW tile `blk`: (scale, position) pair z, H rows h0.., D columns
// d0...
template <bool kVec4>
__device__ __forceinline__ void dw_tile(
    const Plan& plan, const float* __restrict__ x,
    const float* __restrict__ g, const unsigned char* __restrict__ masks,
    int batch, int num_frames, int d, int h, int blk, unsigned char* smem) {
  const int tiles_d = (d + kTile - 1) / kTile;
  const int tiles_h = (h + kTile - 1) / kTile;
  const int z = blk / (tiles_h * tiles_d);
  const int rem = blk % (tiles_h * tiles_d);
  const int h0 = rem / tiles_d * kTile, d0 = rem % tiles_d * kTile;
  const int scale = plan.pos_scale[z], p = plan.pos_p[z];
  const int n_scales = num_frames - 1;
  const int b_chunks = (batch + kTileK - 1) / kTileK;
  // one block per H tile of each scale also reduces db
  const bool db_block = p == 0 && d0 == 0;

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int gq = lane / 4, t = lane % 4;
  const int wm = 32 * (warp % 2), wn = 32 * (warp / 2);
  // staged by this thread: batch row sr of the chunk, H columns
  // h0 + sc + [0, kRun) of g and the mask, D columns d0 + sc + [0, kRun)
  // of x
  const int sr = tid / 4, sc = kRun * (tid % 4);

  auto issue = [&](int c, int s) {
    const int j = c / b_chunks;
    const int gb = c % b_chunks * kTileK + sr;
    const int f = plan.frames[scale][j][p];
    const int sub = plan.sub0[scale] + j;
    const bool in = gb < batch;
    const Stage st = stage_at(smem, s);
    const int hh = h0 + sc;
    ta3n::copy_run16<kVec4>(
        st.g + sr * kNStride + sc,
        in ? g + (static_cast<long long>(gb) * n_scales + scale) * h + hh : g,
        g, in ? h - hh : 0);
    ta3n::copy_run16<kVec4>(
        st.mask + sr * kDwMaskStride + sc,
        in ? masks + (static_cast<long long>(gb) * plan.n_sub_total + sub) *
                         h + hh
           : masks,
        masks, in ? h - hh : 0);
    ta3n::copy_run16<kVec4>(
        st.b + sr * kNStride + sc,
        in ? x + (static_cast<long long>(gb) * num_frames + f) * d + d0 + sc
           : x,
        x, in ? d - d0 - sc : 0);
  };

  float acc[2][4][4] = {};
  float db_acc = 0.f;
  auto compute = [&](int, int s) {
    const Stage st = stage_at(smem, s);
    float part[2][4][4] = {};
#pragma unroll
    for (int kk = 0; kk < kTileK; kk += 8) {
      float a[2][4], b[4][2];
      const int k0 = kk + t, k1 = kk + t + 4;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        // A = m^T: row r of A is column r of the staged m
        const int r = wm + 16 * i + gq;
        a[i][0] = masked(st, k0 * kNStride + r, k0 * kDwMaskStride + r);
        a[i][1] = masked(st, k0 * kNStride + r + 8,
                         k0 * kDwMaskStride + r + 8);
        a[i][2] = masked(st, k1 * kNStride + r, k1 * kDwMaskStride + r);
        a[i][3] = masked(st, k1 * kNStride + r + 8,
                         k1 * kDwMaskStride + r + 8);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = wn + 8 * j + gq;
        b[j][0] = fmaxf(st.b[k0 * kNStride + n], 0.f);
        b[j][1] = fmaxf(st.b[k1 * kNStride + n], 0.f);
      }
      ta3n::mma_3xtf32(part, a, b);
    }
    ta3n::add_to(acc, part);
    if (db_block && tid < kTile) {
#pragma unroll 8
      for (int k = 0; k < kTileK; ++k)
        db_acc += masked(st, k * kNStride + tid, k * kDwMaskStride + tid);
    }
  };
  ta3n::pipeline<kStages>(plan.n_sub[scale] * b_chunks, issue, compute);

  float* __restrict__ dw = plan.dw[scale];
  const long long row = static_cast<long long>(plan.k[scale]) * d;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int gh = h0 + wm + 16 * i + gq + 8 * half;
        if (gh >= h) continue;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = d0 + wn + 8 * j + 2 * t + e;
          if (col < d)
            dw[gh * row + static_cast<long long>(p) * d + col] =
                acc[i][j][2 * half + e];
        }
      }
  if (db_block && tid < kTile && h0 + tid < h)
    plan.db[scale][h0 + tid] = db_acc;
}

// grid (dx_blocks + dW blocks): the dx tiles first, then the dW tiles.
// kVec4: 16-byte copies (D % 4 == 0, H % 16 == 0, aligned pointers).
template <bool kVec4>
__global__ void __launch_bounds__(kThreads, 3)
    trn_fused_bwd_kernel(const __grid_constant__ Plan plan,
                         const float* __restrict__ x,
                         const float* __restrict__ g,
                         const unsigned char* __restrict__ masks,
                         float* __restrict__ dx, int batch, int num_frames,
                         int d, int h, int dx_blocks) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int blk = static_cast<int>(blockIdx.x);
  if (blk < dx_blocks)
    dx_tile<kVec4>(plan, x, g, masks, dx, batch, num_frames, d, h, blk,
                   smem);
  else
    dw_tile<kVec4>(plan, x, g, masks, batch, num_frames, d, h,
                   blk - dx_blocks, smem);
}

// Above 48 KB of dynamic shared memory a kernel must opt in, once.
template <bool kVec4>
cudaError_t allow_smem() {
  static const cudaError_t err = cudaFuncSetAttribute(
      trn_fused_bwd_kernel<kVec4>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  return err;
}

// Fill `plan` from the host plan table (for each scale: k, n_sub, then
// n_sub*k frame indices); false if the table is malformed.
bool read_plan(Plan& plan, const void* const* w, void* const* dw,
               void* const* db, const int* t, int num_frames) {
  int n_sub_total = 0, n_pos = 0;
  for (int i = 0; i < num_frames - 1; ++i) {
    const int k = *t++;
    const int n_sub = *t++;
    if (k < 1 || k > num_frames || n_sub < 1 || n_sub > kMaxSubsets)
      return false;
    plan.w[i] = static_cast<const float*>(w[i]);
    plan.dw[i] = static_cast<float*>(dw[i]);
    plan.db[i] = static_cast<float*>(db[i]);
    plan.k[i] = k;
    plan.n_sub[i] = n_sub;
    plan.sub0[i] = n_sub_total;
    for (int j = 0; j < n_sub; ++j) {
      for (int p = 0; p < k; ++p) {
        const int f = *t++;
        if (f < 0 || f >= num_frames || plan.n_trip[f] >= kMaxTriples)
          return false;
        plan.frames[i][j][p] = static_cast<unsigned char>(f);
        plan.trip[f][plan.n_trip[f]++] = static_cast<unsigned short>(
            i | (n_sub_total + j) << 4 | p << 10);
      }
    }
    n_sub_total += n_sub;
    if (n_pos + k > kMaxPositions) return false;
    for (int p = 0; p < k; ++p, ++n_pos) {
      plan.pos_scale[n_pos] = static_cast<unsigned char>(i);
      plan.pos_p[n_pos] = static_cast<unsigned char>(p);
    }
  }
  plan.n_sub_total = n_sub_total;
  plan.n_pos = n_pos;
  return true;
}

}  // namespace

// ta3n_trn_fused_bwd_f32 with a choice of tiles: parts & 1 the dx tiles,
// parts & 2 the dW/db tiles (3: both, the backward).  One family alone
// is for timing each one's share; it writes only its own outputs.
extern "C" int ta3n_trn_fused_bwd_parts_f32(
    const void* x, const void* const* w, const void* masks, const void* g,
    void* dx, void* const* dw, void* const* db, const int* plan_table,
    int batch, int num_frames, int d, int h, int parts, void* stream) {
  if (num_frames < 2 || num_frames > kMaxFrames || batch < 0 || d < 1 ||
      h < 1 || parts < 1 || parts > 3)
    return static_cast<int>(cudaErrorInvalidValue);
  Plan plan{};
  if (!read_plan(plan, w, dw, db, plan_table, num_frames))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long tiles_d = (d + kTile - 1) / kTile;
  const long long dx_blocks =
      parts & 1 ? static_cast<long long>((batch + kTile - 1) / kTile) *
                      tiles_d * num_frames
                : 0;
  const long long blocks =
      dx_blocks +
      (parts & 2 ? tiles_d * ((h + kTile - 1) / kTile) * plan.n_pos : 0);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  if (blocks == 0) return static_cast<int>(cudaSuccess);
  const auto aligned = [](const void* p) {
    return reinterpret_cast<unsigned long long>(p) % 16 == 0;
  };
  bool vec4 = d % 4 == 0 && h % 16 == 0 && aligned(x) && aligned(g) &&
              aligned(masks);
  for (int i = 0; i < num_frames - 1; ++i) vec4 = vec4 && aligned(w[i]);
  const cudaError_t attr = vec4 ? allow_smem<true>() : allow_smem<false>();
  if (attr != cudaSuccess) return static_cast<int>(attr);
  (vec4 ? trn_fused_bwd_kernel<true> : trn_fused_bwd_kernel<false>)
      <<<static_cast<unsigned>(blocks), kThreads, kSmem,
         static_cast<cudaStream_t>(stream)>>>(
          plan, static_cast<const float*>(x), static_cast<const float*>(g),
          static_cast<const unsigned char*>(masks), static_cast<float*>(dx),
          batch, num_frames, d, h, static_cast<int>(dx_blocks));
  return static_cast<int>(cudaGetLastError());
}

// x [batch, num_frames, d] f32, masks [batch, n_sub_total*h] uint8 (from
// ta3n_trn_fused_fwd_train_f32), g [batch, num_frames-1, h] f32 and
// dx [batch, num_frames, d] f32: contiguous on the current device.  w, dw
// and db are host arrays of num_frames-1 device pointers: the weights
// [h, k*d] and their gradients [h, k*d] and [h] (f32, contiguous, written
// whole).  plan_table as for ta3n_trn_fused_fwd_f32.  Launches one grid of
// dx and dW/db tiles on `stream`; returns cudaGetLastError().
extern "C" int ta3n_trn_fused_bwd_f32(const void* x, const void* const* w,
                                      const void* masks, const void* g,
                                      void* dx, void* const* dw,
                                      void* const* db, const int* plan_table,
                                      int batch, int num_frames, int d, int h,
                                      void* stream) {
  return ta3n_trn_fused_bwd_parts_f32(x, w, masks, g, dx, dw, db, plan_table,
                                      batch, num_frames, d, h, 3, stream);
}
