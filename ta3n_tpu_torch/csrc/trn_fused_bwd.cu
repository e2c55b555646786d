// Fused multi-scale TRN backward, float32 at f32 accuracy on the tensor
// cores (3xTF32 on wgmma), for Hopper (sm_90a).  The bfloat16 variant is
// trn_fused_bwd_bf16.cu.
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
// Blocks run concurrently on Hopper, so the TPU kernel's carry of dW and
// db across a sequential batch-tile grid (trn_fused.py:232-242) does not
// translate: every output element is written by exactly one block of a
// cluster, which reduces in a fixed order, with no atomics, so runs are
// bitwise reproducible.
//
// What bounds it on the card.  At B=202 (128 source + 74 target videos)
// and the flagship widths the two families do 3.39 GFLOP and must move
// about 20 MB (x, g, masks and 7.3 MB of weights in; dx, and 7.3 MB of dW
// out), 6 us at 3.35 TB/s.  In 3xTF32 that is 10.2 GFLOP of tensor-core
// products, 20.5 us at the dense TF32 rate of 495 TFLOP/s: bound by
// operations.
//
// What the design does about that: two kernels, the GEMMs on wgmma
// (tf32_wgmma.cuh, the design of K3's float32 GEMM in gather_gemm.cu).
//  * Stage A, trn_fused_bwd_rows, writes once a call what the families
//    read from shared memory: m = mask ? g : 0 for every (subset, video)
//    into TF32 hi and lo planes [members * n_sub, B, H'] (K-major along H,
//    as dx's B; 4.1 MB at the flagship), m^T unsplit [members * n_sub, H,
//    B'] (K-major along the videos, dW's A, split in registers; 2.1 MB),
//    and relu(x)^T into hi and lo planes [members * S, D, B'] (dW's B;
//    4.1 MB); H' and B' the widths up to 4s, the transposes through
//    shared memory.
//  * The GEMM, trn_fused_bwd_kernel, launched as a programmatic dependent
//    of stage A, one grid of two families of 128 x 128 tiles, the dx
//    tiles first (the longer K):
//      dx: for frame f, dx^T[128 D, 128 videos] = sum over the frame's
//      triples (scale, subset, position) of W_slice^T m^T, K = H a
//      triple.  W's slice [H, D] has D contiguous, which is MN-major for
//      this product, so W is the register operand, loaded from four
//      32 x 32 TMA boxes in the transposed order and split in registers;
//      m's planes are the shared operand.  (x > 0) in the epilogue.
//      dW: for unit (scale i, position p), dW[128 H, 128 D] = m^T
//      relu(x_f), K = the videos of every subset of the scale: m^T the
//      register operand (one 128-row box a chunk, split in registers),
//      relu(x)^T's planes the shared operand.  The blocks at p = 0 and
//      the first D tile also sum their A values (m itself) into db_i, in
//      a fixed order.
//    Each chunk brings 48 KB (A's 16, B's hi and lo 32): the GEMM's pace
//    is its feed from L2 (PERF.md).
//    A tile's K is split over a thread block cluster of `splits` blocks
//    (ops/trn_fused.py::f32_bwd_plan, from one member's shape: the dx
//    tiles' clusters held at once), summed in slice order through
//    distributed shared memory.
//  * The relation plan is a table in device memory (trn_plan.cuh), sized
//    by the call, so any S is taken.  A dx block stages its frame's
//    triples (map, position, subset) into shared memory once, after the
//    ring, for the producer; a dW block reads its unit's record once.
// Ragged B, H and D edges are zero-filled by TMA and masked in the
// stores; weights TMA cannot take as they are are copied into rows first
// (tf32_wgmma.cuh::TrnWeights).  B = 0: dW and db are zeros.
//
// Members (ensembles): blockIdx.y is the member, whose x, g, masks, dx, dW
// and db lie one member's size past the one before and whose weights are
// the pointers' + member * h*k_i*d; each member's blocks do a one-member
// launch's work, so its gradients are bitwise a solo launch's.

#include <cuda.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "smem_optin.cuh"
#include "tf32_wgmma.cuh"
#include "trn_plan.cuh"

namespace {

using ta3n::Plan;
namespace tf = ta3n::tf32;

// stage A: tiles of 32 x 32 through shared memory, 8 rows of threads
constexpr int kRowsThreads = 256;
constexpr int kT = 32;
// the GEMM: a stage is A's 16 KB (dx: W's four 32-row boxes; dW: m^T's
// 128-row box), then B's hi and lo boxes of 128 rows
constexpr int kABytes = 4 * tf::kQuarterBytes;
constexpr int kStageBytes = kABytes + 2 * tf::kBoxBytes;
constexpr int kStages = 4;
constexpr int kBars = kStages * kStageBytes;
// the ring, its barriers, then a dx block's triples; 1024 bytes to align
constexpr int kSmem = kBars + 2 * kStages * 8 + 1024;
static_assert(kSmem <= 232448, "the 227 KB opt-in");
static_assert(2 * kSmem > 228 * 1024, "one block an SM");
static_assert(tf::kRedBytes + tf::kTile * 4 <= kBars,
              "the partial tile and db's fit the ring");

// The scale of global subset s (the plan's scales in order).
__device__ __forceinline__ int scale_of(const Plan& plan, int s) {
  int i = 0;
  while (i + 1 < plan.n_scales && __ldg(&plan.scales[i + 1]).z <= s) ++i;
  return i;
}

// Stage A, 32 x 32 tiles through shared memory, of member blockIdx.y.
// Blocks [0, m_blocks): a tile (subset s, videos, H columns) of m = mask ?
// g : 0 into rows b of layer member * n_sub + s of the hi and lo m planes
// (m, m + m_plane) and into rows h of layer member * n_sub + s of m^T
// (mt).  The others: a tile (frame f, videos, D columns) of relu(x) into
// rows d of layer member * S + f of the hi and lo x planes (xt, xt +
// x_plane).  Thread (tx, ty) reads row b0 + ty + 8r at column c0 + tx and
// writes the transposed row c0 + ty + 8r at video b0 + tx.
__global__ void __launch_bounds__(kRowsThreads)
    trn_fused_bwd_rows(const Plan plan, const float* __restrict__ x,
                       const float* __restrict__ g,
                       const unsigned char* __restrict__ masks,
                       float* __restrict__ m, float* __restrict__ mt,
                       float* __restrict__ xt, int batch, int num_frames,
                       int d, int h, int h_pitch, int b_pitch,
                       long long m_plane, long long x_plane, int m_blocks) {
  // the GEMM may be launched now: it waits for this grid's stores
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const long long member = blockIdx.y;
  const int n_sub = plan.n_sub_total, n_scales = plan.n_scales;
  const int tid = threadIdx.x;
  __shared__ float tile[kT][kT + 1];
  const int tx = tid % kT, ty = tid / kT;
  const int tiles_b = (batch + kT - 1) / kT;
  if (static_cast<int>(blockIdx.x) < m_blocks) {
    const int tiles_h = (h + kT - 1) / kT;
    const int blk = blockIdx.x;
    const int h0 = blk % tiles_h * kT;
    const int b0 = blk / tiles_h % tiles_b * kT;
    const int s = blk / tiles_h / tiles_b;
    const int i = scale_of(plan, s);
    const long long layer = member * n_sub + s;
#pragma unroll
    for (int r = ty; r < kT; r += kRowsThreads / kT) {
      const long long b = b0 + r;
      const int hh = h0 + tx;
      const bool in = b < batch && hh < h;
      const float v =
          in && masks[((member * batch + b) * n_sub + s) * h + hh]
              ? g[((member * batch + b) * n_scales + i) * h + hh]
              : 0.f;
      tile[r][tx] = v;
      if (in) {
        unsigned hi, lo;
        ta3n::split_tf32(v, hi, lo);
        float* at = m + (layer * batch + b) * h_pitch + hh;
        at[0] = __uint_as_float(hi);
        at[m_plane] = __uint_as_float(lo);
      }
    }
    __syncthreads();
    float* dst = mt + layer * h * static_cast<long long>(b_pitch);
#pragma unroll
    for (int r = ty; r < kT; r += kRowsThreads / kT) {
      const int hh = h0 + r, b = b0 + tx;
      if (hh < h && b < batch)
        dst[static_cast<long long>(hh) * b_pitch + b] = tile[tx][r];
    }
    return;
  }
  const int tiles_d = (d + kT - 1) / kT;
  const int blk = static_cast<int>(blockIdx.x) - m_blocks;
  const int d0 = blk % tiles_d * kT;
  const int b0 = blk / tiles_d % tiles_b * kT;
  const int f = blk / tiles_d / tiles_b;
  const float* xs =
      x + member * batch * num_frames * static_cast<long long>(d);
#pragma unroll
  for (int r = ty; r < kT; r += kRowsThreads / kT) {
    const int b = b0 + r, dd = d0 + tx;
    tile[r][tx] = b < batch && dd < d
                      ? fmaxf(xs[(static_cast<long long>(b) * num_frames + f) *
                                     d + dd], 0.f)
                      : 0.f;
  }
  __syncthreads();
  float* dst = xt + (member * num_frames + f) * d * static_cast<long long>(
                                                       b_pitch);
#pragma unroll
  for (int r = ty; r < kT; r += kRowsThreads / kT) {
    const int dd = d0 + r, b = b0 + tx;
    if (dd >= d || b >= batch) continue;
    unsigned hi, lo;
    ta3n::split_tf32(tile[tx][r], hi, lo);
    float* at = dst + static_cast<long long>(dd) * b_pitch + b;
    at[0] = __uint_as_float(hi);
    at[x_plane] = __uint_as_float(lo);
  }
}

// The GEMM's tensor maps: the weights (tf32_wgmma.cuh::trn_weight_maps,
// boxes of 32 rows: dx's A), m's planes [2 * members * n_sub, B, H'] (dx's
// B), m^T [members * n_sub, H, B'] (dW's A) and relu(x)^T's planes [2 *
// members * S, D, B'] (dW's B), boxes of 32 x 128; hi layers, then lo.
struct Maps {
  ta3n::WeightMaps w;
  CUtensorMap m_b, mt_a, x_b;
};

// A dx block's triple: the weights' map, the position coordinate in it,
// the global subset.
struct Triple {
  int map, pos, sub, pad;
};

// The GEMM.  Block blockIdx.x (the dx tiles first: (frame * video tiles +
// video tile) * D tiles + D tile; then the dW tiles: (unit * H tiles + H
// tile) * D tiles + D tile), member blockIdx.y, K slice blockIdx.z of
// gridDim.z (a cluster along z).  by_unit: the weights' map is by unit;
// dx_quads, dw_quads: rows of dx (and x), dW may be written 4 values at a
// time.
__global__ void __launch_bounds__(tf::kThreads, 1)
    trn_fused_bwd_kernel(const __grid_constant__ Maps maps, const Plan plan,
                         const float* __restrict__ x, float* __restrict__ dx,
                         float* __restrict__ dw, float* __restrict__ db,
                         int batch, int num_frames, int d, int h,
                         int dx_tiles, int by_unit, int dx_quads,
                         int dw_quads) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (ta3n::smem_addr(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kBars);
  uint64_t* empty = full + kStages;
  Triple* trips = reinterpret_cast<Triple*>(empty + kStages);
  const int tid = threadIdx.x;
  const int member = blockIdx.y, members = gridDim.y;
  const int split = blockIdx.z, splits = gridDim.z;
  const int n_sub = plan.n_sub_total;
  const int tiles_d = (d + tf::kTile - 1) / tf::kTile;
  const int d0 = blockIdx.x % tiles_d * tf::kTile;
  const int h_chunks = (h + tf::kTileK - 1) / tf::kTileK;
  const int b_chunks = (batch + tf::kTileK - 1) / tf::kTileK;
  const bool is_dx = static_cast<int>(blockIdx.x) < dx_tiles;
  int f = 0, b0 = 0, z = 0, h0 = 0, total;
  int4 u0 = {}, u1 = {}, u2 = {};
  if (is_dx) {
    const int tiles_b = (batch + tf::kTile - 1) / tf::kTile;
    b0 = blockIdx.x / tiles_d % tiles_b * tf::kTile;
    f = blockIdx.x / tiles_d / tiles_b;
    const int t_begin = __ldg(&plan.trip0[f]);
    const int n_trip = __ldg(&plan.trip0[f + 1]) - t_begin;
    for (int q = tid; q < n_trip; q += tf::kThreads) {
      const int code = __ldg(&plan.trips[t_begin + q]);
      const int u = code >> 2;
      const int4 a = __ldg(&plan.units[3 * u]);  // i, p, n_sub, slot
      trips[q] = {by_unit ? 0 : a.x, by_unit ? u : a.y,
                  __ldg(&plan.units[3 * u + 1]).w + (code & 3), 0};
    }
    total = n_trip * h_chunks;
  } else {
    const int tiles_h = (h + tf::kTile - 1) / tf::kTile;
    const int blk = blockIdx.x - dx_tiles;
    h0 = blk / tiles_d % tiles_h * tf::kTile;
    z = blk / tiles_d / tiles_h;
    u0 = __ldg(&plan.units[3 * z]);      // i, p, n_sub, slot
    u1 = __ldg(&plan.units[3 * z + 1]);  // counts, sub0
    u2 = __ldg(&plan.units[3 * z + 2]);  // frames, k
    total = u0.z * b_chunks;
  }
  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      ta3n::mbar_init(&full[s], 1);   // the producer
      ta3n::mbar_init(&empty[s], 2);  // the consumer warpgroups
    }
    ta3n::mbar_fence_init();
  }
  __syncthreads();
  // this block's K slice, in 32-deep chunks
  const int c_begin = total * split / splits;
  const int n = total * (split + 1) / splits - c_begin;

  // one branch a role, never rejoined, so that setmaxnreg holds
  if (tid >= ta3n::kConsumers) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
        tf::kProducerRegs));
    if (tid == ta3n::kConsumers && is_dx) {
      // chunk c: triple c / h_chunks, H rows from c % h_chunks; W's boxes
      // before the wait for stage A, m's after
      tf::produce<kStages>(
          n, full, empty,
          [&](int i, int s, uint64_t* bar) {
            const int c = c_begin + i;
            const Triple t = trips[c / h_chunks];
            unsigned char* st = smem + s * kStageBytes;
            ta3n::mbar_arrive_expect_tx(bar, kStageBytes);
#pragma unroll
            for (int q = 0; q < 4; ++q)
              ta3n::tma_load_4d(st + q * tf::kQuarterBytes, &maps.w.w[t.map],
                                d0 + 32 * q, t.pos,
                                c % h_chunks * tf::kTileK, member, bar);
          },
          [&](int i, int s, uint64_t* bar) {
            const int c = c_begin + i;
            const int layer = member * n_sub + trips[c / h_chunks].sub;
            const int hk = c % h_chunks * tf::kTileK;
            unsigned char* st = smem + s * kStageBytes + kABytes;
            ta3n::tma_load_3d(st, &maps.m_b, hk, b0, layer, bar);
            ta3n::tma_load_3d(st + tf::kBoxBytes, &maps.m_b, hk, b0,
                              layer + members * n_sub, bar);
          });
    } else if (tid == ta3n::kConsumers) {
      // chunk c: subset c / b_chunks, videos from c % b_chunks; every box
      // after the wait
      tf::produce<kStages>(
          n, full, empty,
          [&](int, int, uint64_t* bar) {
            ta3n::mbar_arrive_expect_tx(bar, kStageBytes);
          },
          [&](int i, int s, uint64_t* bar) {
            const int c = c_begin + i;
            const int j = c / b_chunks, bk = c % b_chunks * tf::kTileK;
            const int layer = member * n_sub + u1.w + j;
            const int frame = j == 0 ? u2.x : j == 1 ? u2.y : u2.z;
            const int x_layer = member * num_frames + frame;
            unsigned char* st = smem + s * kStageBytes;
            ta3n::tma_load_3d(st, &maps.mt_a, bk, h0, layer, bar);
            ta3n::tma_load_3d(st + kABytes, &maps.x_b, bk, d0, x_layer, bar);
            ta3n::tma_load_3d(st + kABytes + tf::kBoxBytes, &maps.x_b, bk, d0,
                              x_layer + members * num_frames, bar);
          });
    }
    // the consumers' two cluster barriers below
    ta3n::cluster_sync();
    ta3n::cluster_sync();
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
      tf::kConsumerRegs));

  float acc[64];
  float db_acc[2] = {0.f, 0.f};  // this thread's two A rows (dW)
  float* red = reinterpret_cast<float*>(smem);
  if (is_dx) {
    tf::consume<kStages>(
        n, smem, kStageBytes, kABytes, tf::kBoxBytes, full, empty, acc,
        [&](const unsigned char* st, unsigned (&hi)[4][4],
            unsigned (&lo)[4][4]) {
#pragma unroll
          for (int kk = 0; kk < tf::kTileK / 8; ++kk)
#pragma unroll
            for (int r = 0; r < 4; ++r)
              ta3n::split_tf32(*reinterpret_cast<const float*>(
                                   st + tf::frag_mnmajor(kk, r)),
                               hi[kk][r], lo[kk][r]);
        });
    // dx^T's tile as dx's rows (videos)
    tf::stage_partial<true>(red, acc);
  } else {
    tf::consume<kStages>(
        n, smem, kStageBytes, kABytes, tf::kBoxBytes, full, empty, acc,
        [&](const unsigned char* st, unsigned (&hi)[4][4],
            unsigned (&lo)[4][4]) {
#pragma unroll
          for (int kk = 0; kk < tf::kTileK / 8; ++kk)
#pragma unroll
            for (int r = 0; r < 4; ++r) {
              const float v = *reinterpret_cast<const float*>(
                  st + tf::frag_kmajor(kk, r));
              db_acc[r % 2] += v;
              ta3n::split_tf32(v, hi[kk][r], lo[kk][r]);
            }
        });
    tf::stage_partial<false>(red, acc);
    // db's partial of each A row: the quad's four lanes in a fixed order
    float* red_db = red + tf::kTile * tf::kRedPitch;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float v = db_acc[i];
      v += __shfl_xor_sync(0xffffffffu, v, 1);
      v += __shfl_xor_sync(0xffffffffu, v, 2);
      if (tid % 4 == 0) red_db[tf::frag_row(i)] = v;
    }
  }
  ta3n::cluster_sync();
  if (is_dx) {
    const long long x_size = static_cast<long long>(batch) * num_frames * d;
    const float* xm = x + member * x_size;
    float* dxm = dx + member * x_size;
    tf::cluster_sum(red, split, splits, [&](int row, int col, float4 v) {
      const int b = b0 + row, dd = d0 + col;
      if (b >= batch || dd >= d) return;
      const long long at =
          (static_cast<long long>(b) * num_frames + f) * d + dd;
      float xv[4] = {0.f, 0.f, 0.f, 0.f};
      if (dx_quads) {
        const float4 q = *reinterpret_cast<const float4*>(xm + at);
        xv[0] = q.x, xv[1] = q.y, xv[2] = q.z, xv[3] = q.w;
      } else {
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (dd + u < d) xv[u] = xm[at + u];
      }
      v.x = xv[0] > 0.f ? v.x : 0.f;
      v.y = xv[1] > 0.f ? v.y : 0.f;
      v.z = xv[2] > 0.f ? v.z : 0.f;
      v.w = xv[3] > 0.f ? v.w : 0.f;
      tf::store4(dxm + at, v, d - dd, dx_quads != 0);
    });
  } else {
    // dW_i [h, k*d] starts at the unit of its position 0, z - p
    const int p = u0.y;
    const long long row_len = static_cast<long long>(u2.w) * d;
    float* dwm = dw + static_cast<long long>(member) * h * d * plan.n_units +
                 static_cast<long long>(h) * d * (z - p) +
                 static_cast<long long>(p) * d;
    tf::cluster_sum(red, split, splits, [&](int row, int col, float4 v) {
      const int hh = h0 + row, dd = d0 + col;
      if (hh < h && dd < d)
        tf::store4(dwm + hh * row_len + dd, v, d - dd, dw_quads != 0);
    });
    // db_i from the first D tile of position 0, its slices in order
    if (p == 0 && d0 == 0 && split == 0 && tid < tf::kTile &&
        h0 + tid < h) {
      const unsigned at =
          ta3n::smem_addr(red + tf::kTile * tf::kRedPitch + tid);
      float sum = tf::ld_cluster1(at, 0);
      for (int s = 1; s < splits; ++s) sum += tf::ld_cluster1(at, s);
      db[(static_cast<long long>(member) * plan.n_scales + u0.x) * h + h0 +
         tid] = sum;
    }
  }
  // no block leaves while the others read its shared memory
  ta3n::cluster_sync();
}

// Above 48 KB of dynamic shared memory a kernel must opt in, raised to
// `bytes` on the current device when a plan needs more than any before
// there, and past 8 blocks a cluster (smem_optin.cuh).
cudaError_t allow_smem(int bytes) {
  static std::atomic<int> granted[ta3n::kMaxDevices];
  return ta3n::allow_smem_on_device(trn_fused_bwd_kernel, granted, bytes,
                                    true);
}

bool aligned(const void* p, unsigned bytes) {
  return reinterpret_cast<unsigned long long>(p) % bytes == 0;
}

int launch_bwd(const void* x, const void* ptrs, const void* const* host_ptrs,
               const void* masks, const void* g, void* dx, void* dw, void* db,
               void* scratch, const int* plan_table, int plan_len,
               const int* plan_dev, int batch, int num_frames, int d, int h,
               int splits, int parts, int members, void* stream) {
  if (num_frames < 2 || batch < 0 || d < 1 || h < 1 || parts < 1 ||
      parts > 3 || splits < 1 || splits > tf::kMaxSplits || members < 1 ||
      members > 65535 || ptrs == nullptr || host_ptrs == nullptr ||
      (batch > 0 && (scratch == nullptr || !aligned(scratch, 16))))
    return static_cast<int>(cudaErrorInvalidValue);
  const ta3n::PlanInfo info =
      ta3n::check_plan(plan_table, plan_len, plan_dev, num_frames);
  if (!info.ok || static_cast<long long>(info.max_k) * d > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const Plan& plan = info.plan;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (batch == 0) {  // no rows: dW and db are zeros
    cudaError_t err = cudaSuccess;
    if (parts & 2) {
      err = cudaMemsetAsync(dw, 0,
                            sizeof(float) * members * static_cast<size_t>(h) *
                                d * plan.n_units,
                            s);
      if (err == cudaSuccess)
        err = cudaMemsetAsync(db, 0,
                              sizeof(float) * members *
                                  static_cast<size_t>(h) * plan.n_scales,
                              s);
    }
    return static_cast<int>(err);
  }
  const long long tiles_d = (d + tf::kTile - 1) / tf::kTile;
  const long long dx_tiles =
      parts & 1 ? (batch + tf::kTile - 1) / tf::kTile * tiles_d * num_frames
                : 0;
  const long long tiles =
      dx_tiles + (parts & 2 ? tiles_d * ((h + tf::kTile - 1) / tf::kTile) *
                                  plan.n_units
                            : 0);
  const int h_pitch = (h + 3) / 4 * 4, b_pitch = (batch + 3) / 4 * 4;
  const long long m_rows = static_cast<long long>(batch) * plan.n_sub_total;
  const long long m_blocks = static_cast<long long>(plan.n_sub_total) *
                             ((batch + kT - 1) / kT) * ((h + kT - 1) / kT);
  const long long t_blocks = static_cast<long long>(num_frames) *
                             ((batch + kT - 1) / kT) * ((d + kT - 1) / kT);
  const long long smem =
      kSmem + static_cast<long long>(info.max_trip) * sizeof(Triple);
  if (tiles > 0x7fffffffLL || m_blocks + t_blocks > 0x7fffffffLL ||
      smem > 232448)
    return static_cast<int>(cudaErrorInvalidValue);

  // scratch (ops/trn_fused.py::f32_bwd_plan sizes it alike): m's hi and lo
  // planes, m^T, relu(x)^T's planes, then the copied weights where TMA
  // cannot take them as they are
  const tf::TrnWeights how = tf::trn_weights(plan_table, host_ptrs, d);
  float* m_planes = static_cast<float*>(scratch);
  const long long m_plane = members * m_rows * h_pitch;
  float* mt_plane = m_planes + tf::scratch_floats(2 * m_plane);
  const long long mt_layers = static_cast<long long>(members) *
                              plan.n_sub_total;
  float* x_planes = mt_plane + tf::scratch_floats(mt_layers * h * b_pitch);
  const long long x_plane =
      static_cast<long long>(members) * num_frames * d * b_pitch;
  float* w_rows = x_planes + tf::scratch_floats(2 * x_plane);
  Maps maps{};
  int err = tf::trn_weight_maps(plan_table, host_ptrs, how, w_rows, d, h,
                                members, 32, &maps.w);
  const long long m_layers = 2LL * members * plan.n_sub_total;
  if (err == 0)
    err = tf::operand_map(m_planes, h, batch, m_layers, h_pitch, tf::kTile,
                          &maps.m_b);
  if (err == 0)
    err = tf::operand_map(mt_plane, batch, h, mt_layers, b_pitch, tf::kTile,
                          &maps.mt_a);
  if (err == 0)
    err = tf::operand_map(x_planes, batch, d, 2LL * members * num_frames,
                          b_pitch, tf::kTile, &maps.x_b);
  if (err != 0) return err;
  const cudaError_t attr = allow_smem(static_cast<int>(smem));
  if (attr != cudaSuccess) return static_cast<int>(attr);

  const auto* dev_ptrs = static_cast<const long long*>(ptrs);
  if (how.by_unit)
    tf::launch_trn_repitch(plan, dev_ptrs, w_rows, d, h, how.pitch, members,
                           s);
  trn_fused_bwd_rows<<<dim3(static_cast<unsigned>(m_blocks + t_blocks),
                            members),
                       kRowsThreads, 0, s>>>(
      plan, static_cast<const float*>(x), static_cast<const float*>(g),
      static_cast<const unsigned char*>(masks), m_planes, mt_plane, x_planes,
      batch, num_frames, d, h, h_pitch, b_pitch, m_plane, x_plane,
      static_cast<int>(m_blocks));
  const cudaError_t rows_err = cudaGetLastError();
  if (rows_err != cudaSuccess || tiles == 0)
    return static_cast<int>(rows_err);

  // the GEMM, launched while stage A runs, a tile's K slices one cluster
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(static_cast<unsigned>(tiles), members, splits);
  config.blockDim = dim3(tf::kThreads);
  config.dynamicSmemBytes = static_cast<size_t>(smem);
  config.stream = s;
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
      &config, trn_fused_bwd_kernel, maps, plan,
      static_cast<const float*>(x), static_cast<float*>(dx),
      static_cast<float*>(dw), static_cast<float*>(db), batch, num_frames, d,
      h, static_cast<int>(dx_tiles), how.by_unit,
      d % 4 == 0 && aligned(x, 16) && aligned(dx, 16) ? 1 : 0,
      d % 4 == 0 && aligned(dw, 16) ? 1 : 0);
  if (gemm != cudaSuccess) return static_cast<int>(gemm);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// ta3n_trn_fused_bwd_f32 with a choice of tiles: parts & 1 the dx tiles,
// parts & 2 the dW/db tiles (3: both, the backward).  One family alone
// is for timing each one's share; it writes only its own outputs (stage A
// runs whole either way).
extern "C" int ta3n_trn_fused_bwd_parts_f32(
    const void* x, const void* ptrs, const void* const* host_ptrs,
    const void* masks, const void* g, void* dx, void* dw, void* db,
    void* scratch, const int* plan_table, int plan_len, const int* plan_dev,
    int batch, int num_frames, int d, int h, int splits, int parts,
    void* stream) {
  return launch_bwd(x, ptrs, host_ptrs, masks, g, dx, dw, db, scratch,
                    plan_table, plan_len, plan_dev, batch, num_frames, d, h,
                    splits, parts, 1, stream);
}

// x [batch, num_frames, d] f32, masks [batch, n_sub_total*h] uint8 (from
// ta3n_trn_fused_fwd_train_f32), g [batch, num_frames-1, h] f32 and
// dx [batch, num_frames, d] f32: contiguous on the current device.  ptrs
// is a device array of device pointers, for each unit (scale, position)
// of the plan its scale's weight [h, k*d] (f32, row-major), and
// host_ptrs the same pointers on the host.  dw
// (h*d*n_units f32) receives every scale's dW_i [h, k_i*d] side by side,
// db (n_scales*h f32) every db_i; both written whole.  scratch: 16-byte
// aligned, of ops/trn_fused.py::f32_bwd_plan's float32 values (m's TF32
// planes, m^T, relu(x)^T's TF32 planes, the copied weights where TMA
// cannot read them as they are; unused at batch 0).  splits (1..16) K
// slices a tile, one thread block cluster.  plan_table, plan_len and
// plan_dev as for ta3n_trn_fused_fwd_f32.  members (1..65535) stacked
// members, as for ta3n_trn_fused_fwd_f32: every tensor above holds them
// one after another, and member m's weight of scale i is the pointer's +
// m * h*k_i*d; each member's blocks do a one-member launch's work.
// Launches stage A and one grid of dx and dW/db tiles on `stream`;
// returns the first error.
extern "C" int ta3n_trn_fused_bwd_f32(
    const void* x, const void* ptrs, const void* const* host_ptrs,
    const void* masks, const void* g, void* dx, void* dw, void* db,
    void* scratch, const int* plan_table, int plan_len, const int* plan_dev,
    int batch, int num_frames, int d, int h, int splits, int members,
    void* stream) {
  return launch_bwd(x, ptrs, host_ptrs, masks, g, dx, dw, db, scratch,
                    plan_table, plan_len, plan_dev, batch, num_frames, d, h,
                    splits, 3, members, stream);
}
