// Fused multi-scale TRN backward, float32 at f32 accuracy on the tensor
// cores (3xTF32), for Hopper (sm_90a).  The bfloat16 variant is the wgmma
// kernel of trn_fused_bwd_bf16.cu.
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
//  * The relation plan is a table in device memory (trn_plan.cuh), sized
//    by the call, so any S is taken.  A dx block stages its frame's
//    triples (W slice, scale and subset of each) into shared memory once,
//    after the ring; a dW block reads its unit's record once.  dW and db
//    are each one flat buffer (the scales' blocks side by side), so only
//    the weights come as an array of pointers.
// Ragged B, H and D edges are zero-filled by the copies and masked in the
// stores.
//
// Members (ensembles): blockIdx.y is the member, whose x, g, masks, dx, dW
// and db lie one member's size past the one before and whose weights are
// the pointers' + member * h*k_i*d; each member's blocks do a one-member
// launch's work, so its gradients are bitwise a solo launch's.

#include <cuda_runtime.h>

#include "smem_optin.cuh"
#include "tf32x3.cuh"
#include "trn_plan.cuh"

namespace {

using ta3n::Plan;

constexpr int kThreads = 128;  // 4 warps: 2 x 2, each 32 x 32 outputs
constexpr int kTile = 64;      // output tile, both families
constexpr int kTileK = 32;     // K chunk: H (dx) or batch rows (dW)
constexpr int kStages = 3;
constexpr int kRun = 16;       // elements staged per thread and row
// shared rows: K-major (dx's g, 36 floats), MN-major (W, x, dW's g), and
// the masks
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
                  kTileK * kDwMaskStride <= kMaskBytes &&
                  kGBytes % 16 == 0 && kMaskBytes % 16 == 0 &&
                  kStageBytes % 16 == 0,
              "dW's tiles fit dx's, 16-byte aligned tiles");
static_assert(kTile * kTileK == kThreads * kRun &&
                  kTile * kTileK / kThreads == kRun,
              "one run of 16 per thread and tile");

// A triple of a dx block's frame, staged after the ring: W_i at the
// triple's position, W_i's row length k_i*D, scale i and global subset.
struct Triple {
  const float* w;
  int row, scale, sub, pad;
};
static_assert(kStageBytes % alignof(Triple) == 0, "triples after the ring");

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

// The dx tile `blk`: frame f, batch rows b0.., D columns d0...; the
// weights of member `member` (the pointers' + member * h*k*d).
template <bool kVec>
__device__ __forceinline__ void dx_tile(
    const Plan& plan, const long long* __restrict__ ptrs, long long member,
    const float* __restrict__ x, const float* __restrict__ g,
    const unsigned char* __restrict__ masks, float* __restrict__ dx, int batch,
    int num_frames, int d, int h, int blk, unsigned char* smem) {
  constexpr int kKS = kKStride;
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

  // the frame's triples, decoded once into shared memory after the ring
  Triple* trips = reinterpret_cast<Triple*>(smem + kSmem);
  const int t_begin = __ldg(&plan.trip0[f]);
  const int n_trip = __ldg(&plan.trip0[f + 1]) - t_begin;
  for (int q = tid; q < n_trip; q += kThreads) {
    const int code = __ldg(&plan.trips[t_begin + q]);
    const int z = code >> 2;
    const int4 u0 = __ldg(&plan.units[3 * z]);      // i, p, n_sub, slot
    const int4 u1 = __ldg(&plan.units[3 * z + 1]);  // counts, sub0
    const int k = __ldg(&plan.units[3 * z + 2]).w;
    trips[q] = {ta3n::ptr_at<const float>(ptrs, z) + member * h * k * d +
                    static_cast<long long>(u0.y) * d,
                k * d, u0.x, u1.w + (code & 3), 0};
  }
  __syncthreads();

  auto issue = [&](int c, int s) {
    const Triple tr = trips[c / h_chunks];
    const int i = tr.scale, sub = tr.sub;
    const int hk = c % h_chunks * kTileK;
    const Stage st = stage_at(smem, s);
    const int hh = hk + ac;
    ta3n::copy_run16<kVec>(
        st.g + ar * kKS + ac,
        row_in ? g + (static_cast<long long>(gb) * n_scales + i) * h + hh : g,
        g, row_in ? h - hh : 0);
    ta3n::copy_run16<kVec>(
        st.mask + ar * kDxMaskStride + ac,
        row_in ? masks + (static_cast<long long>(gb) * plan.n_sub_total +
                          sub) * h + hh
               : masks,
        masks, row_in ? h - hh : 0);
    const int wh = hk + br;
    ta3n::copy_run16<kVec>(
        st.b + br * kNStride + bc,
        wh < h ? tr.w + static_cast<long long>(wh) * tr.row + d0 + bc : tr.w,
        tr.w, wh < h ? d - d0 - bc : 0);
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
        a[i][0] = masked(st, r * kKS + k0, r * kDxMaskStride + k0);
        a[i][1] = masked(st, (r + 8) * kKS + k0,
                         (r + 8) * kDxMaskStride + k0);
        a[i][2] = masked(st, r * kKS + k0 + 4, r * kDxMaskStride + k0 + 4);
        a[i][3] = masked(st, (r + 8) * kKS + k0 + 4,
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
  ta3n::pipeline<kStages>(n_trip * h_chunks, issue, compute);

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

// The dW tile `blk`: unit (scale, position) z, H rows h0.., D columns
// d0...  dw and db: the flat gradient buffers (dW_i at h*d*(its first
// unit), db_i at h*i).
template <bool kVec>
__device__ __forceinline__ void dw_tile(
    const Plan& plan, const float* __restrict__ x, const float* __restrict__ g,
    const unsigned char* __restrict__ masks, float* __restrict__ dw,
    float* __restrict__ db, int batch, int num_frames, int d, int h, int blk,
    unsigned char* smem) {
  const int tiles_d = (d + kTile - 1) / kTile;
  const int tiles_h = (h + kTile - 1) / kTile;
  const int z = blk / (tiles_h * tiles_d);
  const int rem = blk % (tiles_h * tiles_d);
  const int h0 = rem / tiles_d * kTile, d0 = rem % tiles_d * kTile;
  const int4 u0 = __ldg(&plan.units[3 * z]);      // i, p, n_sub, slot
  const int sub0 = __ldg(&plan.units[3 * z + 1]).w;
  const int4 u2 = __ldg(&plan.units[3 * z + 2]);  // frames, k
  const int scale = u0.x, p = u0.y;
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
    const int f = j == 0 ? u2.x : j == 1 ? u2.y : u2.z;
    const int sub = sub0 + j;
    const bool in = gb < batch;
    const Stage st = stage_at(smem, s);
    const int hh = h0 + sc;
    ta3n::copy_run16<kVec>(
        st.g + sr * kNStride + sc,
        in ? g + (static_cast<long long>(gb) * n_scales + scale) * h + hh : g,
        g, in ? h - hh : 0);
    ta3n::copy_run16<kVec>(
        st.mask + sr * kDwMaskStride + sc,
        in ? masks + (static_cast<long long>(gb) * plan.n_sub_total + sub) *
                         h + hh
           : masks,
        masks, in ? h - hh : 0);
    ta3n::copy_run16<kVec>(
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
  ta3n::pipeline<kStages>(u0.z * b_chunks, issue, compute);

  // dW_i [h, k*d] starts at the unit of its position 0, z - p
  dw += static_cast<long long>(h) * d * (z - p);
  const long long row = static_cast<long long>(u2.w) * d;
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
    db[static_cast<long long>(scale) * h + h0 + tid] =
        db_acc;
}

// grid (dx_blocks + dW blocks, members): the dx tiles first, then the dW
// tiles, of member blockIdx.y, whose x, g, masks, dx, dw and db follow
// the members before it (each of one member's size) and whose weights are
// the pointers' + member * h*k_i*d.
// kVec: 16-byte copies (D and H multiples of a 16-byte run, H % 16 == 0,
// aligned pointers).  ptrs: each unit's weight (its scale's).  Dynamic
// shared memory: the ring, then the triples of the frame with the most.
template <bool kVec>
__global__ void __launch_bounds__(kThreads, 3)
    trn_fused_bwd_kernel(const Plan plan, const long long* __restrict__ ptrs,
                         const float* __restrict__ x,
                         const float* __restrict__ g,
                         const unsigned char* __restrict__ masks,
                         float* __restrict__ dx, float* __restrict__ dw,
                         float* __restrict__ db, int batch, int num_frames,
                         int d, int h, int dx_blocks) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int blk = static_cast<int>(blockIdx.x);
  const long long member = blockIdx.y;
  const long long x_size = static_cast<long long>(batch) * num_frames * d;
  x += member * x_size;
  dx += member * x_size;
  g += member * batch * plan.n_scales * h;
  masks += member * batch * plan.n_sub_total * h;
  dw += member * h * d * plan.n_units;
  db += member * plan.n_scales * h;
  if (blk < dx_blocks)
    dx_tile<kVec>(plan, ptrs, member, x, g, masks, dx, batch, num_frames, d,
                  h, blk, smem);
  else
    dw_tile<kVec>(plan, x, g, masks, dw, db, batch, num_frames, d, h,
                     blk - dx_blocks, smem);
}

// Above 48 KB of dynamic shared memory a kernel must opt in: raised to
// `bytes` on the current device when a plan needs more than any before
// there (smem_optin.cuh).
template <bool kVec>
cudaError_t allow_smem(int bytes) {
  static std::atomic<int> granted[ta3n::kMaxDevices];
  return ta3n::allow_smem_on_device(trn_fused_bwd_kernel<kVec>, granted,
                                    bytes);
}

int launch_bwd(const void* x, const void* ptrs, const void* const* host_ptrs,
               const void* masks, const void* g, void* dx, void* dw, void* db,
               const int* plan_table, int plan_len, const int* plan_dev,
               int batch, int num_frames, int d, int h, int parts,
               int members, void* stream) {
  if (num_frames < 2 || batch < 0 || d < 1 || h < 1 || parts < 1 ||
      parts > 3 || members < 1 || members > 65535 || ptrs == nullptr ||
      host_ptrs == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const ta3n::PlanInfo info =
      ta3n::check_plan(plan_table, plan_len, plan_dev, num_frames);
  if (!info.ok || static_cast<long long>(info.max_k) * d > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long tiles_d = (d + kTile - 1) / kTile;
  const long long dx_blocks =
      parts & 1 ? static_cast<long long>((batch + kTile - 1) / kTile) *
                      tiles_d * num_frames
                : 0;
  const long long blocks =
      dx_blocks +
      (parts & 2 ? tiles_d * ((h + kTile - 1) / kTile) * info.plan.n_units
                 : 0);
  const long long smem =
      kSmem + static_cast<long long>(info.max_trip) * sizeof(Triple);
  if (blocks > 0x7fffffffLL || smem > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  if (blocks == 0) return static_cast<int>(cudaSuccess);
  const auto aligned = [](const void* p) {
    return reinterpret_cast<unsigned long long>(p) % 16 == 0;
  };
  bool vec = d % 4 == 0 && h % 16 == 0 &&
             aligned(x) && aligned(g) && aligned(masks);
  for (int z = 0; z < info.plan.n_units; ++z)
    vec = vec && aligned(host_ptrs[z]);
  const int bytes = static_cast<int>(smem);
  const cudaError_t attr =
      vec ? allow_smem<true>(bytes) : allow_smem<false>(bytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  (vec ? trn_fused_bwd_kernel<true> : trn_fused_bwd_kernel<false>)
      <<<dim3(static_cast<unsigned>(blocks), members), kThreads, bytes,
         static_cast<cudaStream_t>(stream)>>>(
          info.plan, static_cast<const long long*>(ptrs),
          static_cast<const float*>(x), static_cast<const float*>(g),
          static_cast<const unsigned char*>(masks), static_cast<float*>(dx),
          static_cast<float*>(dw), static_cast<float*>(db), batch, num_frames,
          d, h, static_cast<int>(dx_blocks));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// ta3n_trn_fused_bwd_f32 with a choice of tiles: parts & 1 the dx tiles,
// parts & 2 the dW/db tiles (3: both, the backward).  One family alone
// is for timing each one's share; it writes only its own outputs.
extern "C" int ta3n_trn_fused_bwd_parts_f32(
    const void* x, const void* ptrs, const void* const* host_ptrs,
    const void* masks, const void* g, void* dx, void* dw, void* db,
    const int* plan_table, int plan_len, const int* plan_dev, int batch,
    int num_frames, int d, int h, int parts, void* stream) {
  return launch_bwd(x, ptrs, host_ptrs, masks, g, dx, dw, db,
                           plan_table, plan_len, plan_dev, batch, num_frames,
                           d, h, parts, 1, stream);
}

// x [batch, num_frames, d] f32, masks [batch, n_sub_total*h] uint8 (from
// ta3n_trn_fused_fwd_train_f32), g [batch, num_frames-1, h] f32 and
// dx [batch, num_frames, d] f32: contiguous on the current device.  ptrs
// is a device array of device pointers, for each unit (scale, position)
// of the plan its scale's weight [h, k*d] (f32, row-major), and
// host_ptrs the same pointers on the host.  dw
// (h*d*n_units f32) receives every scale's dW_i [h, k_i*d] side by side,
// db (n_scales*h f32) every db_i; both written whole.  plan_table,
// plan_len and plan_dev as for ta3n_trn_fused_fwd_f32.  members
// (1..65535) stacked members, as for ta3n_trn_fused_fwd_f32: every tensor
// above holds them one after another, and member m's weight of scale i is
// the pointer's + m * h*k_i*d; each member's blocks do a one-member
// launch's work.  Launches one grid of dx and dW/db tiles on `stream`;
// returns cudaGetLastError().
extern "C" int ta3n_trn_fused_bwd_f32(const void* x, const void* ptrs,
                                      const void* const* host_ptrs,
                                      const void* masks, const void* g,
                                      void* dx, void* dw, void* db,
                                      const int* plan_table, int plan_len,
                                      const int* plan_dev, int batch,
                                      int num_frames, int d, int h,
                                      int members, void* stream) {
  return launch_bwd(x, ptrs, host_ptrs, masks, g, dx, dw, db,
                           plan_table, plan_len, plan_dev, batch, num_frames,
                           d, h, 3, members, stream);
}
