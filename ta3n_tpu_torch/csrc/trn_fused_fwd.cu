// Fused multi-scale TRN forward, float32 at f32 accuracy on the tensor
// cores (3xTF32), for Hopper (sm_90a): the inference variant and the
// training variant that also writes the relu mask of every subset.
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
//    is 32 slots x B x H x 4 bytes, 6.6 MB at B=202, and stays in L2.
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
//  * The subset plan and the block layout are a kernel parameter
//    (constant bank): frame indices are uniform loads.
// Ragged B, H and D edges are zero-filled by the copies and masked in the
// stores, so any widths are taken.

#include <cuda_runtime.h>

#include "tf32x3.cuh"

namespace {

constexpr int kMaxFrames = 16;
constexpr int kMaxScales = kMaxFrames - 1;
constexpr int kMaxSubsets = 3;
constexpr int kTileM = 64;  // unit rows (subset, video)
constexpr int kTileH = 64;
constexpr int kTileK = 32;
constexpr int kThreads = 128;  // 4 warps: 2 along M x 2 along H
constexpr int kMinBlocks = 3;  // blocks an SM (registers, shared memory)
constexpr int kStages = 4;
constexpr int kStride = kTileK + 4;  // padded row: bank 4g + t, 16-byte rows
constexpr int kRun = 16;             // floats staged per thread and row
constexpr int kMaxSplits = 8;
constexpr int kWarpN = kTileH / 2;   // a warp's columns
constexpr int kNT = kWarpN / 8;      // its m16n8 tiles along H

static_assert(kTileK == 2 * kRun && 2 * kTileM == kThreads,
              "two threads per staged x row");
static_assert(kTileH % (kThreads / 2) == 0, "whole W rows per thread");
static_assert(kTileM == 2 * 32 && kWarpN % 8 == 0, "4 warps of 32 x kWarpN");

struct Plan {
  const float* w[kMaxScales];  // [H, k*D], row-major
  const float* b[kMaxScales];  // [H]
  int k[kMaxScales];
  int n_sub[kMaxScales];
  int sub0[kMaxScales];   // the scale's first subset over all scales
  int slot0[kMaxScales];  // the scale's first (position, subset) slot
  int m_tiles[kMaxScales];      // row tiles of each of the scale's units
  int blk0[kMaxScales + 1];     // the scale's first block; then the grid
  int n_sub_total;
  int n_slots;  // sum of k*n_sub
  int splits;   // D slices per output tile
  unsigned char frames[kMaxScales][kMaxSubsets][kMaxFrames];
};

struct Stage {
  float x[kTileM][kStride];  // relu applied on use, not here
  float w[kTileH][kStride];
};
constexpr int kSmem = kStages * static_cast<int>(sizeof(Stage));
static_assert(sizeof(Stage) % 16 == 0, "16-byte aligned stages");

// One block: scale i, position p, H tile, row tile and D slice, in that
// order from the slowest; it writes the partial z of its rows and columns
// into part.  kVec4: 16-byte copies.
template <bool kVec4>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    trn_fused_fwd_kernel(const __grid_constant__ Plan plan,
                         const float* __restrict__ x,
                         float* __restrict__ part, int batch, int num_frames,
                         int d, int h) {
  extern __shared__ __align__(128) unsigned char smem[];
  Stage* stage = reinterpret_cast<Stage*>(smem);

  int i = 0;
  while (static_cast<int>(blockIdx.x) >= plan.blk0[i + 1]) ++i;
  int rest = blockIdx.x - plan.blk0[i];
  const int split = rest % plan.splits;
  rest /= plan.splits;
  const int mt = rest % plan.m_tiles[i];
  rest /= plan.m_tiles[i];
  const int h_tiles = (h + kTileH - 1) / kTileH;
  const int h0 = rest % h_tiles * kTileH;
  const int p = rest / h_tiles;
  const int n_sub = plan.n_sub[i];
  const int rows = n_sub * batch;
  const int m0 = mt * kTileM;

  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t = lane % 4;
  const int wm = 32 * (warp % 2), wn = kWarpN * (warp / 2);

  // this block's D slice, in chunks of kTileK
  const int chunks = (d + kTileK - 1) / kTileK;
  const int c_begin = chunks * split / plan.splits;
  const int c_end = chunks * (split + 1) / plan.splits;

  // what this thread stages: floats [col, col + kRun) of a chunk, of unit
  // row m0 + srow (video b of subset j) and of W rows h0 + srow + 64q
  const int srow = tid / 2, col = kRun * (tid % 2);
  const int r = m0 + srow;
  const float* xrow = nullptr;
  if (r < rows) {
    const int j = r / batch, b = r % batch;
    xrow = x + (static_cast<long long>(b) * num_frames +
                plan.frames[i][j][p]) * d;
  }
  const float* wrow[kTileH / 64];
#pragma unroll
  for (int q = 0; q < kTileH / 64; ++q) {
    const int gh = h0 + srow + 64 * q;
    wrow[q] = gh < h ? plan.w[i] + static_cast<long long>(gh) * plan.k[i] * d +
                           static_cast<long long>(p) * d
                     : nullptr;
  }

  auto issue = [&](int c, int s) {
    const int c0 = (c_begin + c) * kTileK + col;
    Stage& st = stage[s];
    ta3n::copy_run16<kVec4>(&st.x[srow][col],
                            xrow != nullptr ? xrow + c0 : x, x,
                            xrow != nullptr ? d - c0 : 0);
#pragma unroll
    for (int q = 0; q < kTileH / 64; ++q)
      ta3n::copy_run16<kVec4>(&st.w[srow + 64 * q][col],
                              wrow[q] != nullptr ? wrow[q] + c0 : plan.w[i],
                              plan.w[i], wrow[q] != nullptr ? d - c0 : 0);
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
  float* out = part + (static_cast<long long>(split) * plan.n_slots +
                       plan.slot0[i] + p * n_sub) *
                          batch * h;
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
// j of scale i is the sum of its partials, positions p in order and within
// each the D slices in order, plus the bias; out = sum_j relu(z_j), and
// the training variant writes (z_j > 0).
template <bool kWithMasks>
__global__ void trn_fused_fwd_epilogue(const __grid_constant__ Plan plan,
                                       const float* __restrict__ part,
                                       float* __restrict__ out,
                                       unsigned char* __restrict__ masks,
                                       int batch, int n_scales, int h) {
  const long long count = static_cast<long long>(batch) * n_scales * h;
  const long long plane = static_cast<long long>(batch) * h;  // one slot
  for (long long e = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       e < count; e += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int hh = static_cast<int>(e % h);
    const long long bi = e / h;
    const int i = static_cast<int>(bi % n_scales);
    const long long b = bi / n_scales;
    const int k = plan.k[i], n_sub = plan.n_sub[i];
    const float* base =
        part + static_cast<long long>(plan.slot0[i]) * plane + b * h + hh;
    const float bias = plan.b[i][hh];
    float sum = 0.f;
    for (int j = 0; j < n_sub; ++j) {
      float z = 0.f;
      for (int p = 0; p < k; ++p)
        for (int s = 0; s < plan.splits; ++s)
          z += base[(static_cast<long long>(s) * plan.n_slots + p * n_sub +
                     j) *
                    plane];
      z += bias;
      const bool on = z > 0.f;
      sum += on ? z : 0.f;
      if constexpr (kWithMasks)
        masks[(b * plan.n_sub_total + plan.sub0[i] + j) * h + hh] = on;
    }
    out[e] = sum;
  }
}

// Above 48 KB of dynamic shared memory a kernel must opt in, once.
template <bool kVec4>
cudaError_t allow_smem() {
  static const cudaError_t err = cudaFuncSetAttribute(
      trn_fused_fwd_kernel<kVec4>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  return err;
}

// Fill `plan` from the host plan table and lay out the blocks; false if
// the table is malformed or the grid too large.
bool read_plan(Plan& plan, const void* const* w, const void* const* b,
               const int* t, int num_frames, int batch, int h, int splits) {
  const long long h_tiles = (h + kTileH - 1) / kTileH;
  int n_sub_total = 0, n_slots = 0;
  long long blocks = 0;
  for (int i = 0; i < num_frames - 1; ++i) {
    const int k = *t++;
    const int n_sub = *t++;
    if (k < 1 || k > num_frames || n_sub < 1 || n_sub > kMaxSubsets)
      return false;
    plan.w[i] = static_cast<const float*>(w[i]);
    plan.b[i] = static_cast<const float*>(b[i]);
    plan.k[i] = k;
    plan.n_sub[i] = n_sub;
    plan.sub0[i] = n_sub_total;
    plan.slot0[i] = n_slots;
    n_sub_total += n_sub;
    n_slots += k * n_sub;
    const long long m_tiles =
        (static_cast<long long>(n_sub) * batch + kTileM - 1) / kTileM;
    if (m_tiles > 0x7fffffffLL) return false;
    plan.m_tiles[i] = static_cast<int>(m_tiles);
    plan.blk0[i] = static_cast<int>(blocks);
    blocks += k * m_tiles * h_tiles * splits;
    if (blocks > 0x7fffffffLL) return false;
    for (int j = 0; j < n_sub; ++j) {
      for (int p = 0; p < k; ++p) {
        const int f = *t++;
        if (f < 0 || f >= num_frames) return false;
        plan.frames[i][j][p] = static_cast<unsigned char>(f);
      }
    }
  }
  plan.blk0[num_frames - 1] = static_cast<int>(blocks);
  plan.n_sub_total = n_sub_total;
  plan.n_slots = n_slots;
  plan.splits = splits;
  return true;
}

template <bool kWithMasks>
int launch(const void* x, const void* const* w, const void* const* b,
           void* out, void* masks, void* part, const int* plan_table,
           int batch, int num_frames, int d, int h, int splits,
           void* stream) {
  if (num_frames < 2 || num_frames > kMaxFrames || batch < 1 || d < 1 ||
      h < 1 || splits < 1 || splits > kMaxSplits || part == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  Plan plan{};
  if (!read_plan(plan, w, b, plan_table, num_frames, batch, h, splits))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto aligned = [](const void* ptr) {
    return reinterpret_cast<unsigned long long>(ptr) % 16 == 0;
  };
  bool vec4 = d % 4 == 0 && aligned(x);
  for (int i = 0; i < num_frames - 1; ++i) vec4 = vec4 && aligned(plan.w[i]);
  const cudaError_t attr = vec4 ? allow_smem<true>() : allow_smem<false>();
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  (vec4 ? trn_fused_fwd_kernel<true> : trn_fused_fwd_kernel<false>)
      <<<plan.blk0[num_frames - 1], kThreads, kSmem, s>>>(
          plan, static_cast<const float*>(x), static_cast<float*>(part),
          batch, num_frames, d, h);
  const long long count = static_cast<long long>(batch) * (num_frames - 1) * h;
  const long long blocks = (count + 255) / 256;
  trn_fused_fwd_epilogue<kWithMasks>
      <<<static_cast<unsigned>(blocks < 8192 ? blocks : 8192), 256, 0, s>>>(
          plan, static_cast<const float*>(part), static_cast<float*>(out),
          static_cast<unsigned char*>(masks), batch, num_frames - 1, h);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x [batch, num_frames, d], out [batch, num_frames-1, h]: contiguous f32 on
// the current device.  w and b are host arrays of num_frames-1 device
// pointers.  plan_table is a host int32 array holding, for each scale,
// k, n_sub and then n_sub*k frame indices.  splits (1..8) D slices per
// output tile; part is scratch of [splits * sum(k*n_sub), batch, h] f32.
// Launches both kernels on `stream` and returns cudaGetLastError().
extern "C" int ta3n_trn_fused_fwd_f32(const void* x, const void* const* w,
                                      const void* const* b, void* out,
                                      void* part, const int* plan_table,
                                      int batch, int num_frames, int d, int h,
                                      int splits, void* stream) {
  return launch<false>(x, w, b, out, nullptr, part, plan_table, batch,
                       num_frames, d, h, splits, stream);
}

// The training variant: as above, and masks [batch, n_sub_total*h] uint8
// (contiguous, on the current device) receives (z > 0) of every subset, in
// the plan's subset order.
extern "C" int ta3n_trn_fused_fwd_train_f32(
    const void* x, const void* const* w, const void* const* b, void* out,
    void* masks, void* part, const int* plan_table, int batch,
    int num_frames, int d, int h, int splits, void* stream) {
  return launch<true>(x, w, b, out, masks, part, plan_table, batch,
                      num_frames, d, h, splits, stream);
}
