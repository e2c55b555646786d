// Fused multi-scale TRN forward, inference variant, float32, for Hopper
// (sm_90a).
//
// Replaces ta3n_tpu/ops/trn_fused.py::_fwd_kernel in its inference variant
// (with_masks=False, launched through trn_multiscale_infer): for every
// scale i of the static relation plan (k_i = S - i frames) and every
// selected subset j of that scale,
//     z_j          = sum_p relu(x[:, f_jp, :]) @ W_i[:, p*D:(p+1)*D]^T + b_i
//     out[:, i, :] = sum_j relu(z_j)
// with W_i in torch nn.Linear layout [H, k_i*D], read as it is (no
// per-call transpose).
//
// What bounds it on the card.  At the serve batch B=64 and the flagship
// widths (S=5, D=512, H=256) the four scales hold 14*D*H f32 weights,
// 7.3 MB, against 0.65 MB of x; the work is
// 2*B*H*D*sum_i(n_sub_i*k_i) = 2*64*256*512*32 = 0.54 GFLOP.  Read once,
// the weights cost about 2.2 us of HBM time at 3.35 TB/s and the FMAs
// about 8 us at the 67 TFLOP/s f32 CUDA-core peak: so the kernel is bound
// by f32 FMA issue as long as each weight is read from HBM once, and at
// small B by the number of blocks there are to fill 132 SMs.
//
// What the design does about that.
//  * Weight reuse across subsets: a block owns one scale and one
//    [kTileB, kTileH] output tile and walks frame positions p and D-chunks.
//    Each W_i tile is staged in shared memory once and applied to every
//    subset of the scale (one accumulator set per subset, at most 3), the
//    reuse the Pallas kernel got from VMEM.  The batch tiles of one scale
//    read the same weights, which stay in the 50 MB L2.
//  * Small tiles (16 rows x 32 columns, 128 threads, 2x2 outputs per
//    thread and subset) give ceil(B/16)*ceil(H/32)*(S-1) blocks: 128 at
//    B=64, so the serve batch fills the card without splitting D.
//  * The subset plan is a kernel parameter (constant bank): frame indices
//    are uniform loads, with no index traffic through global memory.
//  * relu(x) on load (trn_fused.py:78), then bias, relu and the subset sum
//    in registers and one store per output element.  No atomics: each
//    output element is written by exactly one thread, so runs are bitwise
//    reproducible.
//  * f32 FMA on the CUDA cores: no tensor cores, no TF32.
// Ragged B, H and D edges are masked in the loads and the store, so any
// widths are taken.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxFrames = 16;
constexpr int kMaxScales = kMaxFrames - 1;
constexpr int kMaxSubsets = 3;
constexpr int kTileB = 16;
constexpr int kTileH = 32;
constexpr int kTileD = 32;
constexpr int kThreads = 128;

static_assert(kTileB * kTileH == kThreads * 4, "2x2 outputs per thread");
static_assert(kTileH * kTileD % kThreads == 0, "whole W tile per pass");
static_assert(kTileB * kTileD % kThreads == 0, "whole x tile per pass");

struct Plan {
  const float* w[kMaxScales];  // [H, k*D], row-major
  const float* b[kMaxScales];  // [H]
  int k[kMaxScales];
  int n_sub[kMaxScales];
  int frames[kMaxScales][kMaxSubsets][kMaxFrames];
};

template <int NSUB>
__device__ __forceinline__ void scale_tile(
    const Plan& plan, int z, const float* __restrict__ x,
    float* __restrict__ out, int batch, int num_frames, int d, int h,
    float (*ws)[kTileH + 1], float (*xs)[kTileD][kTileB + 1]) {
  const int tid = threadIdx.x;
  const int tx = tid % (kTileH / 2);  // output columns 2*tx, 2*tx+1
  const int ty = tid / (kTileH / 2);  // output rows 2*ty, 2*ty+1
  const int b0 = blockIdx.x * kTileB;
  const int h0 = blockIdx.y * kTileH;
  const int k = plan.k[z];
  const long long row = static_cast<long long>(k) * d;  // W row stride
  const float* __restrict__ w = plan.w[z];

  float acc[NSUB][2][2];
#pragma unroll
  for (int j = 0; j < NSUB; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int c = 0; c < 2; ++c) acc[j][r][c] = 0.f;

  for (int p = 0; p < k; ++p) {
    int frame[NSUB];
#pragma unroll
    for (int j = 0; j < NSUB; ++j) frame[j] = plan.frames[z][j][p];

    for (int d0 = 0; d0 < d; d0 += kTileD) {
      // ws[dd][hh] = W[h0 + hh, p*D + d0 + dd]: a warp reads 32
      // consecutive floats of one weight row.
#pragma unroll
      for (int i = 0; i < kTileH * kTileD / kThreads; ++i) {
        const int e = tid + i * kThreads;
        const int hh = e / kTileD, dd = e % kTileD;
        const int gh = h0 + hh, gd = d0 + dd;
        ws[dd][hh] = (gh < h && gd < d)
                         ? w[gh * row + static_cast<long long>(p) * d + gd]
                         : 0.f;
      }
      // xs[j][dd][bb] = relu(x[b0 + bb, frame_j, d0 + dd])
#pragma unroll
      for (int j = 0; j < NSUB; ++j) {
#pragma unroll
        for (int i = 0; i < kTileB * kTileD / kThreads; ++i) {
          const int e = tid + i * kThreads;
          const int bb = e / kTileD, dd = e % kTileD;
          const int gb = b0 + bb, gd = d0 + dd;
          xs[j][dd][bb] =
              (gb < batch && gd < d)
                  ? fmaxf(x[(static_cast<long long>(gb) * num_frames +
                             frame[j]) * d + gd],
                          0.f)
                  : 0.f;
        }
      }
      __syncthreads();

#pragma unroll 8
      for (int dd = 0; dd < kTileD; ++dd) {
        const float w0 = ws[dd][2 * tx];
        const float w1 = ws[dd][2 * tx + 1];
#pragma unroll
        for (int j = 0; j < NSUB; ++j) {
          const float a0 = xs[j][dd][2 * ty];
          const float a1 = xs[j][dd][2 * ty + 1];
          acc[j][0][0] = fmaf(a0, w0, acc[j][0][0]);
          acc[j][0][1] = fmaf(a0, w1, acc[j][0][1]);
          acc[j][1][0] = fmaf(a1, w0, acc[j][1][0]);
          acc[j][1][1] = fmaf(a1, w1, acc[j][1][1]);
        }
      }
      __syncthreads();
    }
  }

  const float* __restrict__ bias = plan.b[z];
  const int n_scales = num_frames - 1;
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    const int gh = h0 + 2 * tx + c;
    if (gh >= h) continue;
    const float bv = bias[gh];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int gb = b0 + 2 * ty + r;
      if (gb >= batch) continue;
      float s = 0.f;
#pragma unroll
      for (int j = 0; j < NSUB; ++j) s += fmaxf(acc[j][r][c] + bv, 0.f);
      out[(static_cast<long long>(gb) * n_scales + z) * h + gh] = s;
    }
  }
}

// grid (ceil(B/kTileB), ceil(H/kTileH), S-1): one block per output tile
// and scale.
__global__ void __launch_bounds__(kThreads)
    trn_fused_fwd_kernel(const __grid_constant__ Plan plan,
                         const float* __restrict__ x, float* __restrict__ out,
                         int batch, int num_frames, int d, int h) {
  __shared__ float ws[kTileD][kTileH + 1];
  __shared__ float xs[kMaxSubsets][kTileD][kTileB + 1];
  const int z = blockIdx.z;
  switch (plan.n_sub[z]) {
    case 1:
      scale_tile<1>(plan, z, x, out, batch, num_frames, d, h, ws, xs);
      break;
    case 2:
      scale_tile<2>(plan, z, x, out, batch, num_frames, d, h, ws, xs);
      break;
    default:
      scale_tile<3>(plan, z, x, out, batch, num_frames, d, h, ws, xs);
      break;
  }
}

}  // namespace

// x [batch, num_frames, d], out [batch, num_frames-1, h]: contiguous f32 on
// the current device.  w and b are host arrays of num_frames-1 device
// pointers.  plan_table is a host int32 array holding, for each scale,
// k, n_sub and then n_sub*k frame indices.  Launches on `stream` and
// returns cudaGetLastError().
extern "C" int ta3n_trn_fused_fwd_f32(const void* x, const void* const* w,
                                      const void* const* b, void* out,
                                      const int* plan_table, int batch,
                                      int num_frames, int d, int h,
                                      void* stream) {
  if (num_frames < 2 || num_frames > kMaxFrames || batch < 1 || d < 1 ||
      h < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Plan plan{};
  const int n_scales = num_frames - 1;
  const int* t = plan_table;
  for (int i = 0; i < n_scales; ++i) {
    const int k = *t++;
    const int n_sub = *t++;
    if (k < 1 || k > num_frames || n_sub < 1 || n_sub > kMaxSubsets)
      return static_cast<int>(cudaErrorInvalidValue);
    plan.w[i] = static_cast<const float*>(w[i]);
    plan.b[i] = static_cast<const float*>(b[i]);
    plan.k[i] = k;
    plan.n_sub[i] = n_sub;
    for (int j = 0; j < n_sub; ++j) {
      for (int p = 0; p < k; ++p) {
        const int f = *t++;
        if (f < 0 || f >= num_frames)
          return static_cast<int>(cudaErrorInvalidValue);
        plan.frames[i][j][p] = f;
      }
    }
  }
  const dim3 grid((batch + kTileB - 1) / kTileB, (h + kTileH - 1) / kTileH,
                  n_scales);
  trn_fused_fwd_kernel<<<grid, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      plan, static_cast<const float*>(x), static_cast<float*>(out), batch,
      num_frames, d, h);
  return static_cast<int>(cudaGetLastError());
}
