// Fused multi-scale TRN backward in bfloat16, for Hopper (sm_90a): wgmma
// from 128-byte swizzled shared tiles, float32 accumulation.
//
// Replaces ta3n_tpu/ops/trn_fused.py::_bwd_kernel (launched by
// _fused_backward_pallas, the backward of trn_multiscale_fused's custom
// VJP) under the JAX model's bfloat16 compute: the function of
// trn_fused_bwd.cu (see its head) with x, g and the weights bfloat16, and
// dx, dW and db rounded to bfloat16 once, as the JAX package rounds them
// (ta3n_tpu/ops/trn_fused.py:287, 310-312).  Every operand is exactly a
// bfloat16 value (relu(x), W, and m = mask ? g : 0, which is g or +0), so
// a wgmma sum with float32 accumulation is the Pallas kernel's
// float32-promoted dot up to the order of the sum.
//
// The contract of the float32 kernel holds: one grid, its first blocks
// the dx tiles (for each frame f, dx[:, f] = sum over the frame's
// (scale, subset, position) triples of m @ W_i slice, times (x > 0) in the
// epilogue), the rest the dW tiles (for each unit (scale i, position p),
// dW_i[:, p*D..] = sum over the scale's subsets of m^T @ relu(x rows));
// the relation plan from device memory (trn_plan.cuh), so any S is taken;
// every output element written by one block in a fixed order, no
// atomics, so a second run gives the same bits; db_i summed by the dW
// blocks at p = 0 and the first D tile.
//
// What bounds it on the card.  At B = 202, S = 5 and the flagship widths
// it does 3.39 GFLOP (3.4 us at the dense bfloat16 rate of 989 TFLOP/s)
// and must move about 10 MB (3.0 us at 3.35 TB/s).  W, x and m^T are
// MN-major in memory, and m = mask ? g : 0 and relu(x) are computed from
// what is staged: done per fragment (two 16-bit loads a register, the
// mask and relu by every warp that reads a value), that work outweighs
// the products.
//
// What the design does about that.
//  * A 64 x 128 output tile per block of two consumer warpgroups, each
//    running wgmma.mma_async m64n64k16 bf16 (wgmma_bf16.cuh) on one 64-
//    column panel.  dx: A = m, K-major ([B rows, H]), and B = the W_i
//    slice [H, D], MN-major (transpose bit).  dW: A = m^T, MN-major ([B
//    rows, H] read with the transpose bit), and B = relu(x) rows [B, D],
//    MN-major.  So every tile is staged as it lies in memory, rows of 64
//    bfloat16 values in the 128-byte swizzled layout.
//  * 64-deep K chunks (H for dx, batch rows for dW), four k16 products a
//    chunk, in a ring of 3 stages.  A producer warp beside the consumers
//    fills a stage with four TMA boxes, up to three chunks ahead, once both
//    warpgroups have released it (an empty mbarrier), completing on its
//    full mbarrier: the g rows (a 3-d map over [B, S-1, H]), the mask rows
//    (a 2-d map over [B, n_sub*H] uint8), and two 64-column panels of the
//    W_i slice (a 2-d map per scale, made once per weight and passed with
//    the others as a kernel parameter, wgmma_bf16.cuh's WeightMaps) or of
//    the x rows (a 3-d map over [B, S, D]).  Out of range the boxes are
//    zero-filled (ragged B, H and D; a mask or W box that runs into the
//    next subset or position meets zeros of g or of A), and the stores
//    are masked.  Where H % 16 or D % 8 is
//    not 0 or a pointer is not 16-byte aligned (H = 19, 33, D = 37) the
//    consumers stage the tiles by plain loads instead.
//  * Convert passes, once per staged element, in place: each thread turns
//    8 staged g values of a row into m = mask ? g : 0 from the uint8 mask
//    tile, and in the dW blocks 8 staged x values into relu(x); the db
//    blocks sum their m columns in the same pass, in registers, reduced
//    across threads in a fixed order at the end.
//  * 2 blocks an SM (85 KB of shared memory each).
// dx tiles take H / 64 chunks per triple of their frame (20-32 at S = 5:
// the frames with 8 triples are the kernel's longest blocks), the dW
// tiles B / 64 per subset of their scale (4-12).  The grid (dx blocks,
// dW/db blocks) is chosen by the wrapper (ops/trn_fused.py::
// bf16_bwd_grid) and checked here.
//
// Members (ensembles): blockIdx.y is the member.  x and dx are [N, B, S,
// D], g [N, B, S-1, H], the masks [N, B, n_sub*H] (maps of one more rank,
// the member outermost), the weights [N, H, k_i*D] (one rank-3 map a
// scale, wgmma_bf16.cuh), and dW and db one member's size apart.  Each
// member's blocks are a one-member launch's grid on its inputs, so its
// gradients are bitwise a solo launch's; a solo launch is N = 1.

#include <cuda.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "bf16.cuh"
#include "smem_optin.cuh"
#include "tf32x3.cuh"
#include "trn_plan.cuh"
#include "wgmma_bf16.cuh"

namespace {

using ta3n::bf16;
using ta3n::Plan;

// two consumer warpgroups, one per 64 D columns, and a producer warp
constexpr int kThreads = ta3n::kConsumers + 32;
constexpr int kTileM = 64;     // batch rows (dx) or H rows (dW)
constexpr int kTileN = 128;    // D columns, both families
constexpr int kTileK = 64;     // H (dx) or batch rows (dW)
constexpr int kStages = 3;
constexpr int kMaskPitch = 64;  // a staged mask row
// a stage: the g tile (m after the mask pass), the B tile (W slice or x,
// two panels), the mask tile
constexpr int kBOffset = ta3n::kPanelBytes;
constexpr int kMaskOffset = kBOffset + 2 * ta3n::kPanelBytes;
constexpr int kMaskBytes = kTileK * kMaskPitch;
constexpr int kStageBytes = kMaskOffset + kMaskBytes;
// rows of a 64-row tile per consumer thread, 8 threads (16-byte pieces) a
// row
constexpr int kRowsPer = kTileK * 8 / ta3n::kConsumers;
constexpr int kRowStep = ta3n::kConsumers / 8;
constexpr int kRing = kStages * kStageBytes;
// then each stage's full and empty mbarriers, then the triples
constexpr int kBars = kRing;
constexpr int kTrips = kBars + 2 * kStages * 8;
static_assert(kStageBytes % 1024 == 0, "1024-byte aligned stages");
static_assert(kTileN == 2 * 64 && kTileM == 64 && kTileK == 64,
              "an A panel, two B panels");
static_assert(kRowStep * kTileM * 4 <= kRing, "db's reduction fits the ring");

// The tensor maps: g [N, B, S-1, H] and x [N, B, S, D] (4-d, boxes of 64
// x 1 x 64 x 1, 128-byte swizzle), the masks [N, B, n_sub*H] (3-d, 64 x 64
// bytes x 1), and each scale's weights [N, H, k_i*D] (boxes of 64 x 64 x
// 1).
struct Maps {
  CUtensorMap g, mask, x;
  ta3n::WeightMaps w;
};
// and the kernel's other parameters, under 256 bytes
static_assert(sizeof(Maps) + 256 <= ta3n::kParamLimit,
              "the maps fit the kernel parameters");

// A triple of a dx block's frame, staged after the ring: W_i at the
// triple's position (its column p*D), W_i's row length k_i*D, scale i and
// global subset.
struct Triple {
  const bf16* w;
  int row, scale, sub, col0;
};
static_assert(kTrips % alignof(Triple) == 0, "triples after the bars");

// The plain staging of one chunk's tiles (widths the maps do not take):
// the g rows with their mask rows, and the 64 rows of the B tile.
// a_row(r) / m_row(r) / b_row(r): the global rows (nullptr past the
// edge); h_valid, d_valid: the valid H values from the chunk's first, and
// D values from the block's first.
template <class ARow, class MRow, class BRow>
__device__ __forceinline__ void stage_plain(unsigned char* st, int tid,
                                            ARow&& a_row, MRow&& m_row,
                                            BRow&& b_row, int h_valid,
                                            int d_valid) {
  const int piece = tid % 8, row0 = tid / 8;
#pragma unroll
  for (int i = 0; i < kRowsPer; ++i) {
    const int r = row0 + kRowStep * i;
    const bf16* src = a_row(r);
    ta3n::copy_bytes16(st + ta3n::swizzle128(r * 128 + piece * 16),
                       src != nullptr ? src + 8 * piece : src,
                       src != nullptr ? h_valid - 8 * piece : 0);
  }
  const int mpiece = tid % 4, mrow0 = tid / 4;
#pragma unroll
  for (int i = 0; i < kTileK * 4 / ta3n::kConsumers; ++i) {
    const int r = mrow0 + ta3n::kConsumers / 4 * i;
    const unsigned char* src = m_row(r);
    ta3n::copy_bytes16(st + kMaskOffset + r * kMaskPitch + 16 * mpiece,
                       src != nullptr ? src + 16 * mpiece : src,
                       src != nullptr ? h_valid - 16 * mpiece : 0);
  }
#pragma unroll
  for (int i = 0; i < kRowsPer; ++i) {
    const int r = row0 + kRowStep * i;
    const bf16* src = b_row(r);
#pragma unroll
    for (int pn = 0; pn < 2; ++pn) {
      const int col = 64 * pn + 8 * piece;
      ta3n::copy_bytes16(st + kBOffset + ta3n::tile_offset(r, col),
                         src != nullptr ? src + col : src,
                         src != nullptr ? d_valid - col : 0);
    }
  }
}

// The mask pass over a stage: g -> m = mask ? g : 0 in place, eight
// values (one 16-byte piece) of rows tid / 8 + 32p, handed to sum (db).
// All loads first, then the stores: the compiler cannot tell the shared
// addresses apart, and would otherwise wait out each load in turn.
template <class Sum>
__device__ __forceinline__ void mask_pass(unsigned char* st, int tid,
                                          Sum&& sum) {
  constexpr int kRows = kRowsPer;
  const int piece = tid % 8, row0 = tid / 8;
  unsigned char* at = st + ta3n::swizzle128(row0 * 128 + piece * 16);
  const unsigned char* mk_at = st + kMaskOffset + row0 * kMaskPitch +
                               8 * piece;
  uint4 v[kRows];
  uint2 mk[kRows];
#pragma unroll
  for (int p = 0; p < kRows; ++p) {  // rows 32 apart: pieces 4096 apart
    v[p] = *reinterpret_cast<const uint4*>(at + kRowStep * 128 * p);
    mk[p] = *reinterpret_cast<const uint2*>(mk_at +
                                            kRowStep * kMaskPitch * p);
  }
#pragma unroll
  for (int p = 0; p < kRows; ++p) {
    unsigned* words = reinterpret_cast<unsigned*>(&v[p]);
    const unsigned m[2] = {mk[p].x, mk[p].y};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const unsigned pair = m[e / 2] >> (16 * (e % 2));
      words[e] &= ((pair & 0xffu) ? 0x0000ffffu : 0u) |
                  ((pair & 0xff00u) ? 0xffff0000u : 0u);
    }
    *reinterpret_cast<uint4*>(at + kRowStep * 128 * p) = v[p];
    sum(v[p]);
  }
}

// The dx tile `blk`: frame f, batch rows b0.., D columns d0..., of
// member `member` (x, g, masks and dx already its own; its weights the
// pointers' + member * h*k*d).
template <bool kVec>
__device__ __forceinline__ void dx_tile(
    const Plan& plan, const Maps& maps, const long long* __restrict__ ptrs,
    int member, const bf16* __restrict__ x, const bf16* __restrict__ g,
    const unsigned char* __restrict__ masks,
    bf16* __restrict__ dx, int batch, int num_frames, int d, int h, int blk,
    unsigned char* smem) {
  const int tiles_b = (batch + kTileM - 1) / kTileM;
  const int tiles_d = (d + kTileN - 1) / kTileN;
  const int f = blk / (tiles_b * tiles_d);
  const int rem = blk % (tiles_b * tiles_d);
  const int b0 = rem / tiles_d * kTileM, d0 = rem % tiles_d * kTileN;
  const int n_scales = num_frames - 1;
  const int h_chunks = (h + kTileK - 1) / kTileK;
  const int tid = threadIdx.x;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + kBars);

  // the frame's triples, decoded once into shared memory after the ring
  Triple* trips = reinterpret_cast<Triple*>(smem + kTrips);
  const int t_begin = __ldg(&plan.trip0[f]);
  const int n_trip = __ldg(&plan.trip0[f + 1]) - t_begin;
  for (int q = tid; q < n_trip; q += kThreads) {
    const int code = __ldg(&plan.trips[t_begin + q]);
    const int z = code >> 2;
    const int4 u0 = __ldg(&plan.units[3 * z]);      // i, p, n_sub, slot
    const int4 u1 = __ldg(&plan.units[3 * z + 1]);  // counts, sub0
    const int k = __ldg(&plan.units[3 * z + 2]).w;
    trips[q] = {ta3n::ptr_at<const bf16>(ptrs, z) +
                    static_cast<long long>(member) * h * k * d +
                    static_cast<long long>(u0.y) * d,
                k * d, u0.x, u1.w + (code & 3), u0.y * d};
  }
  __syncthreads();

  auto produce = [&](int c, int s, uint64_t* full) {
    if (tid != ta3n::kConsumers) return;  // one thread issues the boxes
    const Triple tr = trips[c / h_chunks];
    const int hk = c % h_chunks * kTileK;
    unsigned char* st = smem + s * kStageBytes;
    ta3n::mbar_arrive_expect_tx(full, kStageBytes);
    ta3n::tma_load_4d(st, &maps.g, hk, tr.scale, b0, member, full);
    ta3n::tma_load_3d(st + kMaskOffset, &maps.mask, tr.sub * h + hk, b0,
                      member, full);
#pragma unroll
    for (int pn = 0; pn < 2; ++pn)
      ta3n::tma_load_3d(st + kBOffset + pn * ta3n::kPanelBytes,
                        &maps.w.w[tr.scale], tr.col0 + d0 + 64 * pn, hk,
                        member, full);
  };
  auto issue_plain = [&](int c, int s) {
    const Triple tr = trips[c / h_chunks];
    const int hk = c % h_chunks * kTileK;
    unsigned char* st = smem + s * kStageBytes;
    stage_plain(
          st, tid,
          [&](int r) -> const bf16* {
            const int b = b0 + r;
            return b < batch ? g + (static_cast<long long>(b) * n_scales +
                                    tr.scale) * h + hk
                             : nullptr;
          },
          [&](int r) -> const unsigned char* {
            const int b = b0 + r;
            return b < batch ? masks + (static_cast<long long>(b) *
                                            plan.n_sub_total + tr.sub) * h +
                                   hk
                             : nullptr;
          },
          [&](int r) -> const bf16* {
            const int wh = hk + r;
            return wh < h ? tr.w + static_cast<long long>(wh) * tr.row + d0
                          : nullptr;
          },
          h - hk, d - d0);
  };
  auto convert = [&](int, int s) {
    mask_pass(smem + s * kStageBytes, tid, [](const uint4&) {});
  };
  // each warpgroup's half of the tile: D columns d0 + 64wg.., panel wg
  const int wg = tid / 128;
  float acc[kTileN / 4] = {};
  auto mma = [&](int, int s) {
    unsigned char* st = smem + s * kStageBytes;
    const uint64_t a = ta3n::kmajor_desc(st);
    const uint64_t b =
        ta3n::mnmajor_desc(st + kBOffset + wg * ta3n::kPanelBytes);
#pragma unroll
    for (int k = 0; k < kTileK / 16; ++k)
      ta3n::wgmma<0, 1>(acc, a + k * ta3n::kKMajorStep,
                        b + k * ta3n::kMNMajorStep);
  };
  if constexpr (kVec)
    ta3n::wgmma_pipeline_ws<kStages>(n_trip * h_chunks, acc, bars,
                                     bars + kStages, tid, produce, convert,
                                     mma);
  else if (tid < ta3n::kConsumers)
    ta3n::wgmma_pipeline<kStages>(n_trip * h_chunks, acc, issue_plain,
                                  [](int, int) {}, convert, mma);
  if (tid >= ta3n::kConsumers) return;

  const int lane = tid % 32, warp = tid % 128 / 32;
#pragma unroll
  for (int j = 0; j < kTileN / 16; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int b = b0 + 16 * warp + lane / 4 + 8 * i;
      if (b >= batch) continue;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = d0 + kTileN / 2 * wg + 8 * j + 2 * (lane % 4) + e;
        if (col >= d) continue;
        const long long at =
            (static_cast<long long>(b) * num_frames + f) * d + col;
        dx[at] = __float2bfloat16_rn(
            __bfloat162float(x[at]) > 0.f ? acc[4 * j + 2 * i + e] : 0.f);
      }
    }
}

// The dW tile `blk`: unit (scale, position) z, H rows h0.., D columns
// d0..., of member `member` (x, g, masks, dw and db already its own).  dw
// and db: the flat gradient buffers (dW_i at h*d*(its first unit), db_i
// at h*i).
template <bool kVec>
__device__ __forceinline__ void dw_tile(
    const Plan& plan, const Maps& maps, int member, const bf16* __restrict__ x,
    const bf16* __restrict__ g, const unsigned char* __restrict__ masks,
    bf16* __restrict__ dw, bf16* __restrict__ db, int batch, int num_frames,
    int d, int h, int blk, unsigned char* smem) {
  const int tiles_d = (d + kTileN - 1) / kTileN;
  const int tiles_h = (h + kTileM - 1) / kTileM;
  const int z = blk / (tiles_h * tiles_d);
  const int rem = blk % (tiles_h * tiles_d);
  const int h0 = rem / tiles_d * kTileM, d0 = rem % tiles_d * kTileN;
  const int4 u0 = __ldg(&plan.units[3 * z]);      // i, p, n_sub, slot
  const int sub0 = __ldg(&plan.units[3 * z + 1]).w;
  const int4 u2 = __ldg(&plan.units[3 * z + 2]);  // frames, k
  const int scale = u0.x, p = u0.y;
  const int n_scales = num_frames - 1;
  const int b_chunks = (batch + kTileK - 1) / kTileK;
  // one block per H tile of each scale also reduces db
  const bool db_block = p == 0 && d0 == 0;
  const int tid = threadIdx.x;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + kBars);

  auto produce = [&](int c, int s, uint64_t* full) {
    if (tid != ta3n::kConsumers) return;  // one thread issues the boxes
    const int j = c / b_chunks;
    const int bk = c % b_chunks * kTileK;
    const int f = j == 0 ? u2.x : j == 1 ? u2.y : u2.z;
    unsigned char* st = smem + s * kStageBytes;
    ta3n::mbar_arrive_expect_tx(full, kStageBytes);
    ta3n::tma_load_4d(st, &maps.g, h0, scale, bk, member, full);
    ta3n::tma_load_3d(st + kMaskOffset, &maps.mask, (sub0 + j) * h + h0, bk,
                      member, full);
#pragma unroll
    for (int pn = 0; pn < 2; ++pn)
      ta3n::tma_load_4d(st + kBOffset + pn * ta3n::kPanelBytes, &maps.x,
                        d0 + 64 * pn, f, bk, member, full);
  };
  auto issue_plain = [&](int c, int s) {
    const int j = c / b_chunks;
    const int bk = c % b_chunks * kTileK;
    const int f = j == 0 ? u2.x : j == 1 ? u2.y : u2.z;
    const int sub = sub0 + j;
    unsigned char* st = smem + s * kStageBytes;
    stage_plain(
          st, tid,
          [&](int r) -> const bf16* {
            const int b = bk + r;
            return b < batch ? g + (static_cast<long long>(b) * n_scales +
                                    scale) * h + h0
                             : nullptr;
          },
          [&](int r) -> const unsigned char* {
            const int b = bk + r;
            return b < batch ? masks + (static_cast<long long>(b) *
                                            plan.n_sub_total + sub) * h + h0
                             : nullptr;
          },
          [&](int r) -> const bf16* {
            const int b = bk + r;
            return b < batch ? x + (static_cast<long long>(b) * num_frames +
                                    f) * d + d0
                             : nullptr;
          },
          h - h0, d - d0);
  };
  // db: this thread's sums of columns h0 + 8 * (tid % 8) + e over its rows
  float db_part[8] = {};
  auto convert = [&](int, int s) {
    unsigned char* st = smem + s * kStageBytes;
    mask_pass(st, tid, [&](const uint4& v) {
      if (!db_block) return;
      const bf16* vals = reinterpret_cast<const bf16*>(&v);
#pragma unroll
      for (int e = 0; e < 8; ++e) db_part[e] += __bfloat162float(vals[e]);
    });
    // relu(x) in place: eight values of rows tid / 8 + 32q, both panels
    unsigned char* at =
        st + kBOffset + ta3n::swizzle128((tid / 8) * 128 + (tid % 8) * 16);
    uint4 v[kRowsPer][2];
#pragma unroll
    for (int q = 0; q < kRowsPer; ++q)
#pragma unroll
      for (int pn = 0; pn < 2; ++pn)
        v[q][pn] = *reinterpret_cast<const uint4*>(
            at + kRowStep * 128 * q + pn * ta3n::kPanelBytes);
#pragma unroll
    for (int q = 0; q < kRowsPer; ++q)
#pragma unroll
      for (int pn = 0; pn < 2; ++pn) {
        uint4 r = v[q][pn];
        r.x = ta3n::relu2(r.x);
        r.y = ta3n::relu2(r.y);
        r.z = ta3n::relu2(r.z);
        r.w = ta3n::relu2(r.w);
        *reinterpret_cast<uint4*>(at + kRowStep * 128 * q +
                                  pn * ta3n::kPanelBytes) = r;
      }
  };
  // each warpgroup's half of the tile: D columns d0 + 64wg.., panel wg
  const int wg = tid / 128;
  float acc[kTileN / 4] = {};
  auto mma = [&](int, int s) {
    unsigned char* st = smem + s * kStageBytes;
    const uint64_t a = ta3n::mnmajor_desc(st);
    const uint64_t b =
        ta3n::mnmajor_desc(st + kBOffset + wg * ta3n::kPanelBytes);
#pragma unroll
    for (int k = 0; k < kTileK / 16; ++k)
      ta3n::wgmma<1, 1>(acc, a + k * ta3n::kMNMajorStep,
                        b + k * ta3n::kMNMajorStep);
  };
  if constexpr (kVec)
    ta3n::wgmma_pipeline_ws<kStages>(u0.z * b_chunks, acc, bars,
                                     bars + kStages, tid, produce, convert,
                                     mma);
  else if (tid < ta3n::kConsumers)
    ta3n::wgmma_pipeline<kStages>(u0.z * b_chunks, acc, issue_plain,
                                  [](int, int) {}, convert, mma);
  if (tid >= ta3n::kConsumers) return;

  // dW_i [h, k*d] starts at the unit of its position 0, z - p
  dw += static_cast<long long>(h) * d * (z - p);
  const long long row = static_cast<long long>(u2.w) * d;
  const int lane = tid % 32, warp = tid % 128 / 32;
#pragma unroll
  for (int j = 0; j < kTileN / 16; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int gh = h0 + 16 * warp + lane / 4 + 8 * i;
      if (gh >= h) continue;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = d0 + kTileN / 2 * wg + 8 * j + 2 * (lane % 4) + e;
        if (col < d)
          dw[gh * row + static_cast<long long>(p) * d + col] =
              __float2bfloat16_rn(acc[4 * j + 2 * i + e]);
      }
    }
  if (db_block) {
    // the kRowStep threads of each column group in a fixed order; the
    // ring is free after the pipeline
    float* red = reinterpret_cast<float*>(smem);
#pragma unroll
    for (int e = 0; e < 8; ++e)
      red[(tid / 8) * kTileM + 8 * (tid % 8) + e] = db_part[e];
    ta3n::named_sync(ta3n::kConsumers);
    if (tid < kTileM && h0 + tid < h) {
      float sum = 0.f;
      for (int r = 0; r < kRowStep; ++r) sum += red[r * kTileM + tid];
      db[static_cast<long long>(scale) * h + h0 + tid] =
          __float2bfloat16_rn(sum);
    }
  }
}

// grid (dx_blocks + dW blocks, members): the dx tiles first, then the dW
// tiles, of member blockIdx.y, whose x, g, masks, dx, dw and db follow the
// members before it (each of one member's size).  kVec: the tiles by TMA
// (D % 8 == 0, H % 16 == 0, 16-byte aligned pointers); maps then name
// them.  ptrs: each unit's weight (its scale's, member 0's).  Dynamic
// shared memory: the ring, its mbarriers, then the triples of the frame
// with the most.
template <bool kVec>
__global__ void __launch_bounds__(kThreads, 2)
    trn_fused_bwd_bf16_kernel(const __grid_constant__ Maps maps,
                              const Plan plan,
                              const long long* __restrict__ ptrs,
                              const bf16* __restrict__ x,
                              const bf16* __restrict__ g,
                              const unsigned char* __restrict__ masks,
                              bf16* __restrict__ dx, bf16* __restrict__ dw,
                              bf16* __restrict__ db, int batch,
                              int num_frames, int d, int h, int dx_blocks) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (ta3n::smem_addr(smem_raw) & 1023)) & 1023);
  if (kVec && threadIdx.x == 0) {
    uint64_t* bars = reinterpret_cast<uint64_t*>(smem + kBars);
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      ta3n::mbar_init(&bars[s], 1);                // full: the producer
      ta3n::mbar_init(&bars[kStages + s], 2);      // empty: the consumers
    }
    ta3n::mbar_fence_init();
  }
  __syncthreads();
  const int blk = static_cast<int>(blockIdx.x);
  const int member = blockIdx.y;
  const long long x_size = static_cast<long long>(batch) * num_frames * d;
  x += member * x_size;
  dx += member * x_size;
  g += static_cast<long long>(member) * batch * plan.n_scales * h;
  masks += static_cast<long long>(member) * batch * plan.n_sub_total * h;
  dw += static_cast<long long>(member) * h * d * plan.n_units;
  db += static_cast<long long>(member) * plan.n_scales * h;
  if (blk < dx_blocks)
    dx_tile<kVec>(plan, maps, ptrs, member, x, g, masks, dx, batch,
                  num_frames, d, h, blk, smem);
  else
    dw_tile<kVec>(plan, maps, member, x, g, masks, dw, db, batch, num_frames,
                  d, h, blk - dx_blocks, smem);
}

// Above 48 KB of dynamic shared memory a kernel must opt in: raised to
// `bytes` on the current device when a plan needs more than any before
// there (smem_optin.cuh).
template <bool kVec>
cudaError_t allow_smem(int bytes) {
  static std::atomic<int> granted[ta3n::kMaxDevices];
  return ta3n::allow_smem_on_device(trn_fused_bwd_bf16_kernel<kVec>,
                                    granted, bytes);
}

}  // namespace

// The bfloat16 backward: as ta3n_trn_fused_bwd_f32 (trn_fused_bwd.cu)
// with x, g, the weights, dx, dw and db bfloat16 (the masks from
// ta3n_trn_fused_fwd_train_bf16), for at most kMaxWeightMaps scales
// (wgmma_bf16.cuh).  dx_blocks and dw_blocks: one member's grid,
// ceil(batch / 64) * ceil(d / 128) * num_frames dx tiles and ceil(d /
// 128) * ceil(h / 64) * n_units dW/db tiles (ops/trn_fused.py::
// bf16_bwd_grid), refused if other.  members (1..65535) stacked members,
// as for ta3n_trn_fused_fwd_bf16: every tensor above holds them one after
// another, and member m's weight of scale i is the pointer's + m *
// h*k_i*d.  Launches one grid of dx and dW/db tiles on `stream`; returns
// cudaGetLastError().
extern "C" int ta3n_trn_fused_bwd_bf16(const void* x, const void* ptrs,
                                       const void* const* host_ptrs,
                                       const void* masks, const void* g,
                                       void* dx, void* dw, void* db,
                                       const int* plan_table, int plan_len,
                                       const int* plan_dev, int batch,
                                       int num_frames, int d, int h,
                                       int dx_blocks, int dw_blocks,
                                       int members, void* stream) {
  if (num_frames < 2 || num_frames - 1 > ta3n::kMaxWeightMaps || batch < 0 ||
      d < 1 || h < 1 || members < 1 || members > 65535 || ptrs == nullptr ||
      host_ptrs == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const ta3n::PlanInfo info =
      ta3n::check_plan(plan_table, plan_len, plan_dev, num_frames);
  if (!info.ok || static_cast<long long>(info.max_k) * d > 0x7fffffffLL ||
      static_cast<long long>(batch) * num_frames * d > 0x7fffffffLL ||
      static_cast<long long>(info.plan.n_sub_total) * h > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long tiles_d = (d + kTileN - 1) / kTileN;
  const long long blocks = static_cast<long long>(dx_blocks) + dw_blocks;
  const long long smem = kTrips + 1024 +
                         static_cast<long long>(info.max_trip) *
                             sizeof(Triple);
  if (dx_blocks != static_cast<long long>((batch + kTileM - 1) / kTileM) *
                       tiles_d * num_frames ||
      dw_blocks != tiles_d * ((h + kTileM - 1) / kTileM) *
                       info.plan.n_units ||
      blocks > 0x7fffffffLL || smem > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto aligned = [](const void* p) {
    return reinterpret_cast<unsigned long long>(p) % 16 == 0;
  };
  // (D % 8 == 0 and H % 16 == 0 make every stride of the maps, the
  // members' too, a multiple of 16 bytes)
  bool vec = d % 8 == 0 && h % 16 == 0 && aligned(x) && aligned(g) &&
             aligned(masks);
  for (int z = 0; z < info.plan.n_units; ++z)
    vec = vec && aligned(host_ptrs[z]);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  Maps maps{};
  if (vec && batch > 0) {
    const int n_scales = num_frames - 1;
    const cuuint64_t bf = 2, n = static_cast<cuuint64_t>(members),
                     b = static_cast<cuuint64_t>(batch);
    const cuuint64_t g_row = bf * h, g_video = g_row * n_scales;
    const cuuint64_t m_row = static_cast<cuuint64_t>(info.plan.n_sub_total) *
                             h;
    const cuuint64_t x_row = bf * d, x_video = x_row * num_frames;
    int err = ta3n::encode_map(
        &maps.g, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, g,
        {static_cast<cuuint64_t>(h), static_cast<cuuint64_t>(n_scales), b,
         n},
        {g_row, g_video, g_video * b}, {kTileK, 1, kTileM, 1},
        CU_TENSOR_MAP_SWIZZLE_128B);
    if (err == 0)
      err = ta3n::encode_map(&maps.mask, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3,
                             masks, {m_row, b, n}, {m_row, m_row * b},
                             {kTileK, kTileM, 1}, CU_TENSOR_MAP_SWIZZLE_NONE);
    if (err == 0)
      err = ta3n::encode_map(
          &maps.x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, x,
          {static_cast<cuuint64_t>(d), static_cast<cuuint64_t>(num_frames), b,
           n},
          {x_row, x_video, x_video * b}, {64, 1, kTileK, 1},
          CU_TENSOR_MAP_SWIZZLE_128B);
    if (err == 0)
      err = ta3n::scale_weight_maps(plan_table, n_scales, host_ptrs, d, h,
                                    members, 64, kTileK, &maps.w);
    if (err != 0) return err;
  }
  const int bytes = static_cast<int>(smem);
  const cudaError_t attr =
      vec ? allow_smem<true>(bytes) : allow_smem<false>(bytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  (vec ? trn_fused_bwd_bf16_kernel<true> : trn_fused_bwd_bf16_kernel<false>)
      <<<dim3(static_cast<unsigned>(blocks), members), kThreads, bytes, s>>>(
          maps, info.plan,
          static_cast<const long long*>(ptrs), static_cast<const bf16*>(x),
          static_cast<const bf16*>(g),
          static_cast<const unsigned char*>(masks), static_cast<bf16*>(dx),
          static_cast<bf16*>(dw), static_cast<bf16*>(db), batch, num_frames,
          d, h, dx_blocks);
  return static_cast<int>(cudaGetLastError());
}
