// Fused multi-scale TRN forward in bfloat16, for Hopper (sm_90a): wgmma
// from 128-byte swizzled shared tiles filled by TMA boxes, float32
// accumulation; the inference variant and the training variant that also
// writes the relu mask of every subset.
//
// Replaces ta3n_tpu/ops/trn_fused.py::_fwd_kernel, both variants
// (with_masks=False through trn_multiscale_infer, with_masks=True through
// trn_multiscale_fused), under the JAX model's bfloat16 compute
// (ta3n_tpu/models/trn.py:138-143): the function of trn_fused_fwd.cu (see
// its head) with x, the weights and the biases bfloat16.  For every scale
// i and selected subset j,
//     z_j          = sum_p relu(x[:, f_jp, :]) @ W_i[:, p*D:(p+1)*D]^T + b_i
//     out[:, i, :] = sum_j relu(z_j)
// where every product of bfloat16 values is exact in float32, the sums and
// the bias are float32, the mask (z_j > 0) comes from the float32 z, and
// out is rounded to bfloat16 once, as the Pallas kernel's
// acc.astype(out dtype).
//
// What bounds it on the card.  At the flagship widths (S=5, D=512, H=256)
// the work is 2*B*H*D*32 FLOP: 0.54 GFLOP at B=64 (0.54 us at the dense
// bfloat16 rate of 989 TFLOP/s) and 1.69 GFLOP at B=202 (1.7 us); the
// bytes are the weights (14*D*H*2, 3.7 MB), x, out and the masks: 4.0 MB
// at B=64 (1.2 us at 3.35 TB/s), 5.4 + 0.9 MB at B=202 (1.9 us).  So a
// few microseconds at best, against which the launch of two kernels, the
// latency of a ring's first chunks, each chunk's conversion and the
// float32 partials' round trip through L2 count.  The float32 mma.sync
// kernel's design (64 x 64 tiles of 4 warps, 32-deep chunks, fragments by
// 32-bit shared loads with relu applied by every warp that loads a value)
// left its bfloat16 instance at 4.5-6.3% of that bound.
//
// What the design does about that.
//  * The work split of trn_fused_fwd.cu: a unit is one (scale i, position
//    p) pair, and each (subset j, position p) partial z lands in its own
//    float32 scratch plane, slot = slot0_i + p*n_sub_i + j, summed by the
//    epilogue below in a fixed order.  A block takes one slot: 64 videos
//    of one subset (a row tile) by 128 H columns (an H tile) over one
//    slice of D.  So its A tile is one TMA box of a 3-d map over x [B, S,
//    D]: 64 D values of frame f_jp for 64 videos at (c*64, f_jp, b0).
//    Rows past B are zero-filled boxes, and computed and dropped: at B=202
//    4 row tiles of 64 hold 202 videos (21% of the rows idle).
//  * Its B tile is one box of 64 D values of 128 rows of W_i, a 2-d map
//    over W_i [H, k_i*D] at (p*D + c*64, h0).  Both operands are K-major
//    as they lie in memory: descriptors with SBO 1024 bytes, +32 bytes a
//    k16 step (wgmma_bf16.cuh).  A box that runs past D into the next
//    position's columns meets the zero-filled columns of the A box.
//  * Two consumer warpgroups, each wgmma.mma_async m64n64k16 on one
//    64-column half of the 64 x 128 tile, in 64-deep chunks (four k16
//    products a chunk, 8 chunks at D=512), a ring of 4 stages fed by a
//    producer warp (wgmma_pipeline_ws), 2 blocks an SM (97 KB of shared
//    memory each).
//  * relu once per staged element: after a chunk's boxes land, the
//    consumers rewrite the x tile in place (relu is elementwise, so the
//    swizzle does not matter), then fence.proxy.async and a barrier; the
//    pass overlaps the previous chunk's products.
//  * The grid is chosen by the wrapper (ops/trn_fused.py::bf16_fwd_grid):
//    row tiles, H tiles and D slices, with the D slices filling the SMs
//    where the output tiles do not (B = 1 and 64: 64 tiles at S=5).
//  * The tensor maps: x's changes every call and is a __grid_constant__
//    parameter; each scale's weight map is made once per weight pointer
//    and shape (wgmma_bf16.cuh::weight_map) and passed by value with it
//    (WeightMaps), so nothing is copied to the device at a launch.
//  * The epilogue is a second kernel, a block per (b, i) row of out and a
//    thread per h: the partials of each subset in a fixed order
//    (positions, then D slices), the bias, the mask and relu, out rounded
//    once.  No atomics: a second run gives the same bits.  It is launched
//    as a programmatic dependent of the GEMM: it reads its plan record
//    while the GEMM drains and then waits for the GEMM's stores; it
//    issues the loads of four (position, slice) steps of all the scale's
//    subsets together, since its time is latency at small B.
//  * Where D % 8 != 0 or a pointer is not 16-byte aligned (TMA's rules)
//    the consumers stage both tiles by plain loads instead
//    (wgmma_pipeline, no producer), into the same swizzled layout.
// Ragged B, H and D are zero-filled and masked, so any widths are taken.
// PERF.md (section 6) has the measured split between the two kernels and
// the variants tried.
//
// Members (ensembles, where the Pallas kernel runs under jax.vmap with a
// grid axis over members): blockIdx.y is the member, in the GEMM and in
// the epilogue.  x is [N, B, S, D] (a rank-4 map, the member its outermost
// coordinate), each scale's weights [N, H, k_i*D] (one rank-3 map,
// wgmma_bf16.cuh), each bias [N, H], and the member's scratch, out and
// masks lie one member's size past the one before.  The grid of a member
// is the one-member grid the wrapper chose from one member's shape, so
// its blocks sum the same partials in the same order as a solo launch:
// its outputs are bitwise a solo launch's.  A solo launch is N = 1.

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

// two consumer warpgroups, one per 64 H columns, and a producer warp
constexpr int kThreads = ta3n::kConsumers + 32;
constexpr int kTileM = 64;   // videos of one subset
constexpr int kTileN = 128;  // H columns
constexpr int kTileK = 64;   // D values a chunk
constexpr int kStages = 4;
constexpr int kMaxSplits = 8;
constexpr int kEpilogueThreads = 256;
// a stage: the x tile (one panel), then the W tile (128 rows of 128
// bytes); after the stages each one's full and empty mbarriers
constexpr int kBOffset = ta3n::kPanelBytes;
constexpr int kStageBytes = kBOffset + kTileN * 128;
constexpr int kBars = kStages * kStageBytes;
constexpr int kSmem = kBars + 2 * kStages * 8 + 1024;  // + 1024 alignment
static_assert(kStageBytes % 1024 == 0, "1024-byte aligned stages");
static_assert(kTileM * 8 == 2 * ta3n::kConsumers, "two x pieces a thread");

// The tensor maps: x [N, B, S, D] (4-d, boxes of 64 x 1 x 64 x 1) and each
// scale's weights [N, H, k_i*D] (boxes of 64 x 128 x 1), 128-byte swizzle.
struct Maps {
  CUtensorMap x;
  ta3n::WeightMaps w;
};
// and the kernel's other parameters, under 256 bytes
static_assert(sizeof(Maps) + 256 <= ta3n::kParamLimit,
              "the maps fit the kernel parameters");

// One block: scratch slot q (a subset j of unit (i, p)), H tile, row tile
// and D slice, in that order from the slowest, of member blockIdx.y; it
// writes the partial z of its 64 videos and 128 columns into the member's
// plane split * n_slots + q of part.  ptrs: each unit's weight (its
// scale's, member 0's; member m's is m * h * k * d further).  kVec: the
// tiles by TMA.
template <bool kVec>
__global__ void __launch_bounds__(kThreads, 2)
    trn_fused_fwd_bf16_kernel(const __grid_constant__ Maps maps,
                              const Plan plan,
                              const long long* __restrict__ ptrs,
                              const bf16* __restrict__ x,
                              float* __restrict__ part, int batch,
                              int num_frames, int d, int h, int row_tiles,
                              int h_tiles, int splits) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (ta3n::smem_addr(smem_raw) & 1023)) & 1023);
  __shared__ int4 unit_at, unit_frames;  // {i, p, n_sub, slot}, frames/k
  __shared__ const bf16* unit_w;
  const int tid = threadIdx.x;
  const int member = blockIdx.y;
  x += static_cast<long long>(member) * batch * num_frames * d;
  long long rest = blockIdx.x;
  const int split = static_cast<int>(rest % splits);
  rest /= splits;
  const int b0 = static_cast<int>(rest % row_tiles) * kTileM;
  rest /= row_tiles;
  const int h0 = static_cast<int>(rest % h_tiles) * kTileN;
  const int slot = static_cast<int>(rest / h_tiles);
  // the slot's unit: slots slot .. slot + n_sub - 1 are the unit's subsets
  for (int z = tid; z < plan.n_units; z += kThreads) {
    const int4 a = __ldg(&plan.units[3 * z]);
    if (slot >= a.w && slot < a.w + a.z) {
      unit_at = a;
      unit_frames = __ldg(&plan.units[3 * z + 2]);
      unit_w = ta3n::ptr_at<const bf16>(ptrs, z);
    }
  }
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + kBars);
  if (kVec && tid == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      ta3n::mbar_init(&bars[s], 1);            // full: the producer
      ta3n::mbar_init(&bars[kStages + s], 2);  // empty: the consumers
    }
    ta3n::mbar_fence_init();
  }
  __syncthreads();
  const int scale = unit_at.x, p = unit_at.y, j = slot - unit_at.w;
  const int f = j == 0 ? unit_frames.x : j == 1 ? unit_frames.y
                                                : unit_frames.z;
  const long long w_row = static_cast<long long>(unit_frames.w) * d;
  const bf16* w_p =
      unit_w + static_cast<long long>(member) * h * w_row +
      static_cast<long long>(p) * d;

  // this block's D slice, in chunks of kTileK
  const int chunks = (d + kTileK - 1) / kTileK;
  const int c_begin = chunks * split / splits;
  const int n = chunks * (split + 1) / splits - c_begin;

  auto produce = [&](int c, int s, uint64_t* full) {
    if (tid != ta3n::kConsumers) return;  // one thread issues the boxes
    const int col = (c_begin + c) * kTileK;
    unsigned char* st = smem + s * kStageBytes;
    ta3n::mbar_arrive_expect_tx(full, kStageBytes);
    ta3n::tma_load_4d(st, &maps.x, col, f, b0, member, full);
    ta3n::tma_load_3d(st + kBOffset, &maps.w.w[scale], p * d + col, h0,
                      member, full);
  };
  // the plain staging: 16-byte pieces of the 64 x rows and the 128 W rows
  auto issue_plain = [&](int c, int s) {
    const int col = (c_begin + c) * kTileK;
    unsigned char* st = smem + s * kStageBytes;
    const int piece = tid % 8, row0 = tid / 8;
    const int valid = d - col - 8 * piece;
#pragma unroll
    for (int r = 0; r < kTileM; r += ta3n::kConsumers / 8) {
      const int b = b0 + row0 + r;
      ta3n::copy_bytes16(
          st + ta3n::swizzle128((row0 + r) * 128 + piece * 16),
          b < batch ? x + (static_cast<long long>(b) * num_frames + f) * d +
                          col + 8 * piece
                    : x,
          b < batch ? valid : 0);
    }
#pragma unroll
    for (int r = 0; r < kTileN; r += ta3n::kConsumers / 8) {
      const int hh = h0 + row0 + r;
      ta3n::copy_bytes16(
          st + kBOffset + ta3n::swizzle128((row0 + r) * 128 + piece * 16),
          hh < h ? w_p + hh * w_row + col + 8 * piece : w_p,
          hh < h ? valid : 0);
    }
  };
  // relu(x) in place, two 16-byte pieces a thread, both loads first (relu
  // is elementwise, so the swizzle does not matter)
  auto convert = [&](int, int s) {
    uint4* a = reinterpret_cast<uint4*>(smem + s * kStageBytes);
    uint4 v[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) v[r] = a[tid + ta3n::kConsumers * r];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      v[r].x = ta3n::relu2(v[r].x);
      v[r].y = ta3n::relu2(v[r].y);
      v[r].z = ta3n::relu2(v[r].z);
      v[r].w = ta3n::relu2(v[r].w);
      a[tid + ta3n::kConsumers * r] = v[r];
    }
  };
  // each warpgroup's half of the tile: H columns h0 + 64wg.., W rows
  // 64wg.. of the stage's W tile
  const int wg = tid / 128;
  float acc[kTileN / 4] = {};
  auto mma = [&](int, int s) {
    unsigned char* st = smem + s * kStageBytes;
    const uint64_t a = ta3n::kmajor_desc(st);
    const uint64_t b = ta3n::kmajor_desc(st + kBOffset + wg * 64 * 128);
#pragma unroll
    for (int k = 0; k < kTileK / 16; ++k)
      ta3n::wgmma<0, 0>(acc, a + k * ta3n::kKMajorStep,
                        b + k * ta3n::kKMajorStep);
  };
  if constexpr (kVec)
    ta3n::wgmma_pipeline_ws<kStages>(n, acc, bars, bars + kStages, tid,
                                     produce, convert, mma);
  else if (tid < ta3n::kConsumers)
    ta3n::wgmma_pipeline<kStages>(n, acc, issue_plain, [](int, int) {},
                                  convert, mma);
  // the epilogue may be launched now; it waits for this grid's stores
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  if (tid >= ta3n::kConsumers) return;

  float* out =
      part + ((static_cast<long long>(member) * splits + split) *
                  plan.n_slots +
              slot) *
                 batch * h;
  const int lane = tid % 32, warp = tid % 128 / 32;
  const bool pairs = h % 2 == 0;
#pragma unroll
  for (int jn = 0; jn < kTileN / 16; ++jn)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int b = b0 + 16 * warp + lane / 4 + 8 * i;
      const int col = h0 + kTileN / 2 * wg + 8 * jn + 2 * (lane % 4);
      if (b >= batch || col >= h) continue;
      float* dst = out + static_cast<long long>(b) * h + col;
      const float v0 = acc[4 * jn + 2 * i], v1 = acc[4 * jn + 2 * i + 1];
      if (pairs) {
        *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
      } else {
        dst[0] = v0;
        if (col + 1 < h) dst[1] = v1;
      }
    }
}

// The epilogue, a block per (b, i) row of out and a thread per h: z of
// each subset j of scale i is the sum of its float32 partials, positions p
// in order and within each the D slices in order, plus the bias (in
// float32); out = sum_j relu(z_j) rounded to bfloat16 once, and the
// training variant writes (z_j > 0).  The loads of four (position, slice)
// steps of every subset are issued together.  ptrs: each unit's weight,
// then each scale's bias (member 0's; member m's is m * h further).  Of
// member blockIdx.y: its scratch, bias, out and masks.
template <bool kWithMasks>
__global__ void __launch_bounds__(kEpilogueThreads)
    trn_fused_fwd_bf16_epilogue(const Plan plan,
                                const long long* __restrict__ ptrs,
                                const float* __restrict__ part,
                                bf16* __restrict__ out,
                                unsigned char* __restrict__ masks, int batch,
                                int h, int splits) {
  constexpr int kSteps = 4;
  constexpr int kSub = ta3n::kMaxSubsets;
  const int n_scales = plan.n_scales;
  const int i = static_cast<int>(blockIdx.x % n_scales);
  const long long b = blockIdx.x / n_scales;
  // what does not come from the GEMM is read while it drains
  const int4 sc = __ldg(&plan.scales[i]);  // k, n_sub, sub0, slot0
  const int n_sub = sc.y, n_steps = sc.x * splits;
  const long long plane = static_cast<long long>(batch) * h;  // one slot
  const long long member = blockIdx.y;
  part += member * splits * plan.n_slots * plane;
  out += member * batch * n_scales * h;
  if constexpr (kWithMasks) masks += member * batch * plan.n_sub_total * h;
  const bf16* bias_i =
      ta3n::ptr_at<const bf16>(ptrs, plan.n_units + i) + member * h;
  // the partials of the GEMM before it on the stream, complete
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  for (int hh = threadIdx.x; hh < h; hh += kEpilogueThreads) {
    const float* base = part + sc.w * plane + b * h + hh;
    float z[kSub] = {};
    // step q: position p = q / splits, D slice s = q % splits
    for (int q0 = 0, p = 0, s = 0; q0 < n_steps; q0 += kSteps) {
      float v[kSteps][kSub];
#pragma unroll
      for (int u = 0; u < kSteps; ++u) {
        const float* at =
            base + (static_cast<long long>(s) * plan.n_slots + p * n_sub) *
                       plane;
#pragma unroll
        for (int j = 0; j < kSub; ++j)
          v[u][j] = q0 + u < n_steps && j < n_sub ? __ldg(at + j * plane)
                                                  : 0.f;
        if (++s == splits) {
          s = 0;
          ++p;
        }
      }
#pragma unroll
      for (int u = 0; u < kSteps; ++u)
#pragma unroll
        for (int j = 0; j < kSub; ++j) z[j] += v[u][j];
    }
    const float bias = __bfloat162float(bias_i[hh]);
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < kSub; ++j) {
      if (j >= n_sub) break;
      const float zj = z[j] + bias;
      const bool on = zj > 0.f;
      sum += on ? zj : 0.f;
      if constexpr (kWithMasks)
        masks[(b * plan.n_sub_total + sc.z + j) * h + hh] = on;
    }
    out[(b * n_scales + i) * h + hh] = __float2bfloat16_rn(sum);
  }
}

// Above 48 KB of dynamic shared memory a kernel must opt in, once on each
// device (smem_optin.cuh).
template <bool kVec>
cudaError_t allow_smem() {
  static std::atomic<int> granted[ta3n::kMaxDevices];
  return ta3n::allow_smem_on_device(trn_fused_fwd_bf16_kernel<kVec>, granted,
                                    kSmem);
}

template <bool kWithMasks>
int launch(const void* x, const void* ptrs, const void* const* host_ptrs,
           void* out, void* masks, void* part, const int* plan_table,
           int plan_len, const int* plan_dev, int batch, int num_frames,
           int d, int h, int row_tiles, int h_tiles, int splits, int members,
           void* stream) {
  const int chunks = (d + kTileK - 1) / kTileK;
  if (num_frames < 2 || num_frames - 1 > ta3n::kMaxWeightMaps ||
      batch < 1 || d < 1 || h < 1 || members < 1 || members > 65535 ||
      part == nullptr || ptrs == nullptr ||
      host_ptrs == nullptr || row_tiles != (batch + kTileM - 1) / kTileM ||
      h_tiles != (h + kTileN - 1) / kTileN || splits < 1 ||
      splits > kMaxSplits || splits > chunks)
    return static_cast<int>(cudaErrorInvalidValue);
  const ta3n::PlanInfo info =
      ta3n::check_plan(plan_table, plan_len, plan_dev, num_frames);
  if (!info.ok || static_cast<long long>(info.max_k) * d > 0x7fffffffLL ||
      static_cast<long long>(batch) * num_frames * d > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = static_cast<long long>(info.plan.n_slots) *
                           row_tiles * h_tiles * splits;
  // the epilogue's blocks: one per (b, i) row of out
  const long long rows = static_cast<long long>(batch) * (num_frames - 1);
  if (blocks > 0x7fffffffLL || rows > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto aligned = [](const void* ptr) {
    return reinterpret_cast<unsigned long long>(ptr) % 16 == 0;
  };
  // TMA: every row start and stride 16-byte aligned (D % 8 == 0 makes
  // every stride of x and of the weights, the members' too, a multiple of
  // 16 bytes)
  bool vec = d % 8 == 0 && aligned(x);
  for (int z = 0; z < info.plan.n_units; ++z)
    vec = vec && aligned(host_ptrs[z]);
  Maps maps{};
  if (vec) {
    const cuuint64_t bf = 2;
    const cuuint64_t row = bf * d, video = row * num_frames;
    int err = ta3n::encode_map(
        &maps.x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, x,
        {static_cast<cuuint64_t>(d), static_cast<cuuint64_t>(num_frames),
         static_cast<cuuint64_t>(batch), static_cast<cuuint64_t>(members)},
        {row, video, video * batch}, {kTileK, 1, kTileM, 1},
        CU_TENSOR_MAP_SWIZZLE_128B);
    if (err == 0)
      err = ta3n::scale_weight_maps(plan_table, num_frames - 1, host_ptrs,
                                    d, h, members, kTileK, kTileN, &maps.w);
    if (err != 0) return err;
  }
  const cudaError_t attr = vec ? allow_smem<true>() : allow_smem<false>();
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* dev_ptrs = static_cast<const long long*>(ptrs);
  (vec ? trn_fused_fwd_bf16_kernel<true> : trn_fused_fwd_bf16_kernel<false>)
      <<<dim3(static_cast<unsigned>(blocks), members), kThreads, kSmem, s>>>(
          maps, info.plan, dev_ptrs, static_cast<const bf16*>(x),
          static_cast<float*>(part), batch, num_frames, d, h, row_tiles,
          h_tiles, splits);
  const cudaError_t gemm = cudaGetLastError();
  if (gemm != cudaSuccess) return static_cast<int>(gemm);
  // launched while the GEMM runs (programmatic dependent launch); it waits
  // for the GEMM's partials before reading them
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(static_cast<unsigned>(rows), members);
  config.blockDim = dim3(kEpilogueThreads);
  config.stream = s;
  cudaLaunchAttribute early[1];
  early[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  early[0].val.programmaticStreamSerializationAllowed = 1;
  config.attrs = early;
  config.numAttrs = 1;
  const cudaError_t epi = cudaLaunchKernelEx(
      &config, trn_fused_fwd_bf16_epilogue<kWithMasks>, info.plan, dev_ptrs,
      static_cast<const float*>(part), static_cast<bf16*>(out),
      static_cast<unsigned char*>(masks), batch, h, splits);
  if (epi != cudaSuccess) return static_cast<int>(epi);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x [batch, num_frames, d], out [batch, num_frames-1, h]: contiguous
// bfloat16 on the current device.  ptrs is a device array of device
// pointers: for each unit (scale, position) of the plan its scale's weight
// [h, k*d] (row-major, bfloat16), then each scale's bias [h] (bfloat16);
// host_ptrs holds the same pointers on the host (their alignment picks
// TMA or plain staging; the weights' maps are made from them).
// plan_table (plan_len ints, on the host) and plan_dev (the same ints on
// the device, 16-byte aligned) are the relation plan of trn_plan.cuh, of
// at most kMaxWeightMaps scales (wgmma_bf16.cuh); a malformed table is
// refused.  The grid of one member: row_tiles = ceil(batch / 64),
// h_tiles = ceil(h / 128) and splits D slices (1..8, at most one per
// 64-deep chunk); part is float32 scratch of [splits * n_slots, batch, h]
// a member.  members (1..65535) stacked members, one grid row each: x,
// out and part hold them one after another (each of the shapes above),
// and member m's weight of scale i and bias are the pointers' + m times
// the weight's h*k_i*d and the bias's h elements (weights [members, h,
// k_i*d], biases [members, h]).  Launches the GEMM and its epilogue on
// `stream` and returns the first error.
extern "C" int ta3n_trn_fused_fwd_bf16(const void* x, const void* ptrs,
                                       const void* const* host_ptrs,
                                       void* out, void* part,
                                       const int* plan_table, int plan_len,
                                       const int* plan_dev, int batch,
                                       int num_frames, int d, int h,
                                       int row_tiles, int h_tiles,
                                       int splits, int members,
                                       void* stream) {
  return launch<false>(x, ptrs, host_ptrs, out, nullptr, part, plan_table,
                       plan_len, plan_dev, batch, num_frames, d, h,
                       row_tiles, h_tiles, splits, members, stream);
}

// The training variant: as above, and masks [batch, n_sub_total*h] uint8
// (contiguous, on the current device) receives (z > 0) of every subset, in
// the plan's subset order, from the float32 z ([members, batch,
// n_sub_total*h] with members > 1).
extern "C" int ta3n_trn_fused_fwd_train_bf16(
    const void* x, const void* ptrs, const void* const* host_ptrs, void* out,
    void* masks, void* part, const int* plan_table, int plan_len,
    const int* plan_dev, int batch, int num_frames, int d, int h,
    int row_tiles, int h_tiles, int splits, int members, void* stream) {
  return launch<true>(x, ptrs, host_ptrs, out, masks, part, plan_table,
                      plan_len, plan_dev, batch, num_frames, d, h, row_tiles,
                      h_tiles, splits, members, stream);
}
