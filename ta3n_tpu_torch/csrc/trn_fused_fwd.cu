// Fused multi-scale TRN forward, float32 at f32 accuracy on the tensor
// cores (3xTF32), for Hopper (sm_90a): the inference variant and the
// training variant that also writes the relu mask of every subset.  The
// bfloat16 variants are trn_fused_fwd_bf16.cu, on wgmma.
//
// Replaces ta3n_tpu/ops/trn_fused.py::_fwd_kernel, both variants:
// with_masks=False (launched through trn_multiscale_infer) and
// with_masks=True (launched through trn_multiscale_fused, whose backward is
// csrc/trn_fused_bwd.cu).  For every scale i of the static relation plan
// (k_i = S - i frames) and every selected subset j of that scale,
//     z_j          = sum_p relu(x[:, f_jp, :]) @ W_i[:, p*D:(p+1)*D]^T + b_i
//     out[:, i, :] = sum_j relu(z_j)
//     masks[:, s*H:(s+1)*H] = (z_j > 0)     (training variant; s = the
//                                           subset's index over all scales)
// with W_i in torch nn.Linear layout [H, k_i*D], read as it is (no
// per-call transpose).
//
// What bounds it on the card.  At the flagship widths (S=5, D=512, H=256)
// the four scales hold 14*D*H f32 weights, 7.3 MB, and the work is
// 2*B*H*D*sum_i(n_sub_i*k_i) = 2*B*256*512*32 FLOP: 0.54 GFLOP at the serve
// batch B=64, 1.69 GFLOP at the train batch B=202 (128 source + 74 target
// videos).  In 3xTF32 the tensor cores do three products per f32 product:
// 3.3 us at B=64 and 10.3 us at B=202 at the dense TF32 rate of
// 495 TFLOP/s, against about 8.2 MB (2.5 us) and 10.7 MB (3.2 us) of bytes
// at 3.35 TB/s: bound by operations at both.  On the H100 mma.sync reaches
// about half of that TF32 rate, and the split of each operand costs about
// as many instructions as the products (PERF.md).  The scales' work is
// k_i*n_sub_i = 5 : 12 : 9 : 6, so one block per scale and output tile
// leaves the tail to the k=4 scale; and at B=64 the output is only 64 x
// 1024 values, too few tiles to fill 132 SMs.
//
// What the design does about that.
//  * Work units of equal depth: the reduction is split over frame
//    positions.  A unit is one (scale i, position p) pair, 14 at S=5: a
//    GEMM of the rows (j, b) of every subset of the scale, row j*B + b
//    reading x[b, f_jp, :], against the W_i slice of position p, which is
//    so staged once for all the subsets (the reuse the Pallas kernel got
//    from VMEM).  M = n_sub_i*B, N = H, K = D for every unit.  The wrapper
//    may split K (D) further into `splits` slices (ops/trn_fused.py
//    ::_fwd_splits: up to one block an SM; one slice at B=64 and B=202).
//  * Each block writes its partial z into a scratch [splits * slots, B, H]
//    (slot = the scale's first slot + p*n_sub_i + j), and a second kernel
//    does the epilogue for each (b, i, h): sums the partials of each
//    subset over positions and then D slices in a fixed order, adds the
//    bias, writes the mask (training variant) and sums relu over the
//    subsets.  No atomics: a second run gives the same bits.  The scratch
//    is sum_i(k_i*n_sub_i) slots x B x H x 4 bytes: 32 slots at S=5, 6.6
//    MB at B=202, which stays in L2; 922 slots at S=25, 190 MB at B=202.
//  * mma.sync m16n8k8 TF32 with the 3xTF32 split (tf32x3.cuh), relu
//    applied to each x value before it is split (relu is exact, so
//    operands of at most 11 significant bits still multiply exactly).  x
//    rows and W rows are both K-major (D contiguous), so the fragments are
//    32-bit loads from staged rows padded to 36 floats: conflict-free
//    (bank 4g + t).  Each 32-deep chunk is summed into fresh registers and
//    then added to the f32 sum (add_to), against the tensor core's
//    truncating accumulation.
//  * A 64 x 64 tile per block of 4 warps, each warp 32 x 32; a ring of 4
//    stages of 32-deep chunks in dynamic shared memory, filled by cp.async
//    (16-byte copies where D % 4 == 0 and x and every W_i are 16-byte
//    aligned, else 4-byte copies), so three blocks fit on an SM and the
//    next chunks are in flight while one is multiplied.  Each thread
//    stages half a row of x and of W, whose addresses are fixed for the
//    block (its position is fixed).
//  * The relation plan is a table in device memory (trn_plan.cuh), sized
//    by the call, so any S is taken.  A block finds its unit with one
//    cooperative pass over the units: each thread reads a unit's record
//    and weight pointer (one round trip, no load waiting on another) and
//    tests the unit's block range, and the thread that finds it hands the
//    record over in shared memory.  The rows' frames and W slice are then
//    fixed for the whole K loop.
// Ragged B, H and D edges are zero-filled by the copies and masked in the
// stores, so any widths are taken.
//
// Members (the ensembles, where the Pallas kernel runs under jax.vmap with
// a grid axis over members): blockIdx.y is the member.  Each member reads
// its x, weights and biases and writes its scratch, out and masks at one
// member's size past the one before; the pointer table holds member 0's
// weights, and member m's are m times the weight's h*k*d elements further.
// A member's blocks do exactly a one-member launch's work (the wrapper
// slices D by one member's shape), so its outputs are bitwise a solo
// launch's; N members fill N times the blocks, which the card needs at
// the serve batch (128 blocks at B=64).

#include <cuda_runtime.h>

#include "smem_optin.cuh"
#include "tf32x3.cuh"
#include "trn_plan.cuh"

namespace {

using ta3n::Plan;
constexpr int kTileM = 64;  // unit rows (subset, video)
constexpr int kTileH = 64;
constexpr int kTileK = 32;
constexpr int kThreads = 128;  // 4 warps: 2 along M x 2 along H
constexpr int kMinBlocks = 3;  // blocks an SM (registers, shared memory)
constexpr int kStages = 4;
constexpr int kRun = 16;             // values staged per thread and row
constexpr int kMaxSplits = 8;
constexpr int kWarpN = kTileH / 2;   // a warp's columns
constexpr int kNT = kWarpN / 8;      // its m16n8 tiles along H

static_assert(kTileK == 2 * kRun && 2 * kTileM == kThreads,
              "two threads per staged x row");
static_assert(kTileH % (kThreads / 2) == 0, "whole W rows per thread");
static_assert(kTileM == 2 * 32 && kWarpN % 8 == 0, "4 warps of 32 x kWarpN");

// padded staged row of 36 (bank 4g + t), 16-byte rows
constexpr int kStride = kTileK + 4;

struct Stage {
  float x[kTileM][kStride];  // relu applied on use, not here
  float w[kTileH][kStride];
};
constexpr int kSmem = kStages * static_cast<int>(sizeof(Stage));
static_assert(sizeof(Stage) % 16 == 0, "16-byte aligned stages");

// The row tiles of a unit of n subsets: n*B rows of 64.
__device__ __forceinline__ int unit_m_tiles(int n, int mt1, int mt2,
                                            int mt3) {
  return n == 1 ? mt1 : n == 2 ? mt2 : mt3;
}

// One block: unit (scale i, position p), H tile, row tile and D slice, in
// that order from the slowest, of member blockIdx.y; it writes the partial
// z of its rows and columns into the member's part.  A unit of n subsets has m_tiles(n) * h_tiles *
// splits blocks; mt1..mt3 are the row tiles of 1..3 subsets at this B.
// ptrs: each unit's weight (its scale's), then each scale's bias.  kVec:
// 16-byte copies.
template <bool kVec>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    trn_fused_fwd_kernel(const Plan plan, const long long* __restrict__ ptrs,
                         const float* __restrict__ x, float* __restrict__ part,
                         int batch, int num_frames, int d, int h, int splits,
                         int mt1, int mt2, int mt3) {
  extern __shared__ __align__(128) unsigned char smem[];
  Stage* stage = reinterpret_cast<Stage*>(smem);
  __shared__ int4 unit_at, unit_frames;  // {i, p, n_sub, slot}, frames/k
  __shared__ const float* unit_w;
  __shared__ long long unit_b0;

  // the member's x and scratch; its weights below, at the unit's stride
  const long long member = blockIdx.y;
  x += member * batch * num_frames * d;
  part += member * splits * plan.n_slots * batch * h;
  const int h_tiles = (h + kTileH - 1) / kTileH;
  const long long per_tile = static_cast<long long>(h_tiles) * splits;
  const long long blk = blockIdx.x;
  for (int z = threadIdx.x; z < plan.n_units; z += kThreads) {
    const int4 a = __ldg(&plan.units[3 * z]);
    const int4 c = __ldg(&plan.units[3 * z + 1]);
    const int4 f = __ldg(&plan.units[3 * z + 2]);
    const float* w = ta3n::ptr_at<const float>(ptrs, z) +
                     member * h * f.w * d;
    const long long b0 = per_tile * (static_cast<long long>(c.x) * mt1 +
                                     static_cast<long long>(c.y) * mt2 +
                                     static_cast<long long>(c.z) * mt3);
    if (blk >= b0 && blk < b0 + per_tile * unit_m_tiles(a.z, mt1, mt2, mt3)) {
      unit_at = a;
      unit_frames = f;
      unit_w = w;
      unit_b0 = b0;
    }
  }
  __syncthreads();
  const int4 u0 = unit_at, u2 = unit_frames;
  const int p = u0.y, n_sub = u0.z;
  const int m_tiles = unit_m_tiles(n_sub, mt1, mt2, mt3);
  long long rest = blk - unit_b0;
  const int split = static_cast<int>(rest % splits);
  rest /= splits;
  const int mt = static_cast<int>(rest % m_tiles);
  const int h0 = static_cast<int>(rest / m_tiles) * kTileH;
  const int rows = n_sub * batch;
  const int m0 = mt * kTileM;
  const float* w_i = unit_w;

  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t = lane % 4;
  const int wm = 32 * (warp % 2), wn = kWarpN * (warp / 2);

  // this block's D slice, in chunks of kTileK
  const int chunks = (d + kTileK - 1) / kTileK;
  const int c_begin = chunks * split / splits;
  const int c_end = chunks * (split + 1) / splits;

  // what this thread stages: values [col, col + kRun) of a chunk, of unit
  // row m0 + srow (video b of subset j) and of W rows h0 + srow + 64q
  const int srow = tid / 2, col = kRun * (tid % 2);
  const int r = m0 + srow;
  const float* xrow = nullptr;
  if (r < rows) {
    const int j = r / batch, b = r % batch;
    const int f = j == 0 ? u2.x : j == 1 ? u2.y : u2.z;
    xrow = x + (static_cast<long long>(b) * num_frames + f) * d;
  }
  const float* wrow[kTileH / 64];
#pragma unroll
  for (int q = 0; q < kTileH / 64; ++q) {
    const int gh = h0 + srow + 64 * q;
    wrow[q] = gh < h ? w_i + static_cast<long long>(gh) * u2.w * d +
                           static_cast<long long>(p) * d
                     : nullptr;
  }

  auto issue = [&](int c, int s) {
    const int c0 = (c_begin + c) * kTileK + col;
    Stage& st = stage[s];
    ta3n::copy_run16<kVec>(&st.x[srow][col],
                           xrow != nullptr ? xrow + c0 : x, x,
                           xrow != nullptr ? d - c0 : 0);
#pragma unroll
    for (int q = 0; q < kTileH / 64; ++q)
      ta3n::copy_run16<kVec>(&st.w[srow + 64 * q][col],
                             wrow[q] != nullptr ? wrow[q] + c0 : w_i, w_i,
                             wrow[q] != nullptr ? d - c0 : 0);
  };

  float acc[2][kNT][4] = {};
  auto compute = [&](int, int s) {
    const Stage& st = stage[s];
    float part_z[2][kNT][4] = {};
#pragma unroll
    for (int kk = 0; kk < kTileK; kk += 8) {
      float a[2][4], bw[kNT][2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const int row = wm + 16 * mi + g;
        a[mi][0] = fmaxf(st.x[row][kk + t], 0.f);
        a[mi][1] = fmaxf(st.x[row + 8][kk + t], 0.f);
        a[mi][2] = fmaxf(st.x[row][kk + t + 4], 0.f);
        a[mi][3] = fmaxf(st.x[row + 8][kk + t + 4], 0.f);
      }
#pragma unroll
      for (int nj = 0; nj < kNT; ++nj) {
        const int n = wn + 8 * nj + g;
        bw[nj][0] = st.w[n][kk + t];
        bw[nj][1] = st.w[n][kk + t + 4];
      }
      ta3n::mma_3xtf32(part_z, a, bw);
    }
    ta3n::add_to(acc, part_z);
  };
  ta3n::pipeline<kStages>(c_end - c_begin, issue, compute);

  // the unit's rows are contiguous in part: slot (slot0 + p*n_sub + j)
  // holds rows j*B .. j*B + B - 1
  float* out =
      part + (static_cast<long long>(split) * plan.n_slots + u0.w) * batch * h;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int nj = 0; nj < kNT; ++nj)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int om = m0 + wm + 16 * mi + g + 8 * half;
        const int oh = h0 + wn + 8 * nj + 2 * t;
        if (om >= rows) continue;
        float* dst = out + static_cast<long long>(om) * h + oh;
        if (oh < h) dst[0] = acc[mi][nj][2 * half];
        if (oh + 1 < h) dst[1] = acc[mi][nj][2 * half + 1];
      }
}

// The epilogue, one thread per (b, i, h) in out's order: z of each subset
// j of scale i is the sum of its float32 partials, positions p in order
// and within each the D slices in order, plus the bias (in float32);
// out = sum_j relu(z_j), and the training variant writes (z_j > 0).  Of
// member blockIdx.y: its scratch, bias, out and masks.
template <bool kWithMasks>
__global__ void trn_fused_fwd_epilogue(const Plan plan,
                                       const long long* __restrict__ ptrs,
                                       const float* __restrict__ part,
                                       float* __restrict__ out,
                                       unsigned char* __restrict__ masks,
                                       int batch, int h, int splits) {
  const int n_scales = plan.n_scales;
  const long long count = static_cast<long long>(batch) * n_scales * h;
  const long long plane = static_cast<long long>(batch) * h;  // one slot
  const long long member = blockIdx.y;
  part += member * splits * plan.n_slots * plane;
  out += member * count;
  if constexpr (kWithMasks) masks += member * batch * plan.n_sub_total * h;
  for (long long e = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       e < count; e += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int hh = static_cast<int>(e % h);
    const long long bi = e / h;
    const int i = static_cast<int>(bi % n_scales);
    const long long b = bi / n_scales;
    const int4 sc = __ldg(&plan.scales[i]);  // k, n_sub, sub0, slot0
    const int k = sc.x, n_sub = sc.y;
    const float* base = part + static_cast<long long>(sc.w) * plane + b * h + hh;
    const float bias =
        ta3n::ptr_at<const float>(ptrs, plan.n_units + i)[member * h + hh];
    float sum = 0.f;
    for (int j = 0; j < n_sub; ++j) {
      float z = 0.f;
      for (int p = 0; p < k; ++p)
        for (int s = 0; s < splits; ++s)
          z += base[(static_cast<long long>(s) * plan.n_slots + p * n_sub +
                     j) *
                    plane];
      z += bias;
      const bool on = z > 0.f;
      sum += on ? z : 0.f;
      if constexpr (kWithMasks)
        masks[(b * plan.n_sub_total + sc.z + j) * h + hh] = on;
    }
    out[e] = sum;
  }
}

// Above 48 KB of dynamic shared memory a kernel must opt in, once on each
// device (smem_optin.cuh).
template <bool kVec>
cudaError_t allow_smem() {
  static std::atomic<int> granted[ta3n::kMaxDevices];
  return ta3n::allow_smem_on_device(trn_fused_fwd_kernel<kVec>, granted,
                                    kSmem);
}

template <bool kWithMasks>
int launch(const void* x, const void* ptrs, const void* const* host_ptrs,
           void* out, void* masks, void* part, const int* plan_table,
           int plan_len, const int* plan_dev, int batch, int num_frames,
           int d, int h, int splits, int members, void* stream) {
  if (num_frames < 2 || batch < 1 || d < 1 || h < 1 || splits < 1 ||
      splits > kMaxSplits || members < 1 || members > 65535 ||
      part == nullptr || ptrs == nullptr || host_ptrs == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const ta3n::PlanInfo info =
      ta3n::check_plan(plan_table, plan_len, plan_dev, num_frames);
  if (!info.ok || static_cast<long long>(info.max_k) * d > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  int mt[ta3n::kMaxSubsets + 1] = {};
  long long blocks = 0;
  for (int n = 1; n <= ta3n::kMaxSubsets; ++n) {
    const long long tiles =
        (static_cast<long long>(n) * batch + kTileM - 1) / kTileM;
    if (tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
    mt[n] = static_cast<int>(tiles);
    blocks += tiles * info.units_with[n];
  }
  blocks *= static_cast<long long>((h + kTileH - 1) / kTileH) * splits;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const auto aligned = [](const void* ptr) {
    return reinterpret_cast<unsigned long long>(ptr) % 16 == 0;
  };
  // 16-byte copies: every row start 16-byte aligned
  bool vec = d % 4 == 0 && aligned(x);
  for (int z = 0; z < info.plan.n_units; ++z)
    vec = vec && aligned(host_ptrs[z]);
  const cudaError_t attr =
      vec ? allow_smem<true>() : allow_smem<false>();
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* dev_ptrs = static_cast<const long long*>(ptrs);
  (vec ? trn_fused_fwd_kernel<true> : trn_fused_fwd_kernel<false>)
      <<<dim3(static_cast<unsigned>(blocks), members), kThreads, kSmem, s>>>(
          info.plan, dev_ptrs, static_cast<const float*>(x),
          static_cast<float*>(part), batch, num_frames, d, h, splits, mt[1],
          mt[2], mt[3]);
  const long long count = static_cast<long long>(batch) * (num_frames - 1) * h;
  const long long epi = (count + 255) / 256;
  trn_fused_fwd_epilogue<kWithMasks>
      <<<dim3(static_cast<unsigned>(epi < 8192 ? epi : 8192), members), 256,
         0, s>>>(
          info.plan, dev_ptrs, static_cast<const float*>(part),
          static_cast<float*>(out), static_cast<unsigned char*>(masks),
          batch, h, splits);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x [batch, num_frames, d], out [batch, num_frames-1, h]: contiguous f32 on
// the current device.  ptrs is a device array of device pointers: for each
// unit (scale, position) of the plan its scale's weight [h, k*d]
// (row-major), then each scale's bias [h]; host_ptrs holds the same
// pointers on the host (their alignment picks the copy width).  plan_table (plan_len ints, on the host) and
// plan_dev (the same ints on the device, 16-byte aligned) are the relation
// plan of trn_plan.cuh; a malformed table is refused.  splits (1..8) D
// slices per output tile; part is scratch of [splits * n_slots, batch, h]
// f32.  members (1..65535) stacked members, one grid row each (blockIdx.y):
// x, out and part hold them one after another (each of the shapes above),
// and member m's weight of scale i and bias are the pointers' + m times
// the weight's h*k_i*d and the bias's h elements (weights [members, h,
// k_i*d], biases [members, h]).  Each member's blocks do the work of a
// one-member launch on its inputs.  Launches both kernels on `stream` and
// returns cudaGetLastError().
extern "C" int ta3n_trn_fused_fwd_f32(const void* x, const void* ptrs,
                                      const void* const* host_ptrs, void* out,
                                      void* part, const int* plan_table,
                                      int plan_len, const int* plan_dev,
                                      int batch, int num_frames, int d, int h,
                                      int splits, int members, void* stream) {
  return launch<false>(x, ptrs, host_ptrs, out, nullptr, part,
                              plan_table, plan_len, plan_dev, batch,
                              num_frames, d, h, splits, members, stream);
}

// The training variant: as above, and masks [batch, n_sub_total*h] uint8
// (contiguous, on the current device) receives (z > 0) of every subset, in
// the plan's subset order (with members > 1, [members, batch,
// n_sub_total*h]).
extern "C" int ta3n_trn_fused_fwd_train_f32(
    const void* x, const void* ptrs, const void* const* host_ptrs, void* out,
    void* masks, void* part, const int* plan_table, int plan_len,
    const int* plan_dev, int batch, int num_frames, int d, int h, int splits,
    int members, void* stream) {
  return launch<true>(x, ptrs, host_ptrs, out, masks, part,
                             plan_table, plan_len, plan_dev, batch,
                             num_frames, d, h, splits, members, stream);
}
