// Fused multi-scale TRN backward, float32, for Hopper (sm_90a).
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
// Blocks run concurrently on Hopper, so the TPU kernel's carry of dW and
// db across a sequential batch-tile grid (trn_fused.py:232-242) does not
// translate.  Two output-stationary passes instead, launched in turn on
// the stream, each output element written by exactly one thread that
// reduces in a fixed order: no atomics, so runs are bitwise reproducible.
//  * dx pass, grid (ceil(B/16), ceil(D/64), S): a block owns a [16, 64]
//    tile of dx for one frame and walks the (scale, subset, position)
//    triples whose frame is its own (32 triples over the 5 frames at S=5,
//    fixed in the by-value plan), staging m^T and the W_i[:, p*D + d0 ...]
//    tile in shared memory per 16-deep chunk of H.  (x > 0) in the
//    epilogue.  2*B*H*D*32 FLOP: 1.69 GFLOP at B=202, H=256, D=512.
//  * dW/db pass, grid (ceil(D/32), ceil(H/32), sum_i k_i): a block owns a
//    [32, 32] tile of dW_i at one frame position p and reduces over the
//    batch, 16 rows at a time, for every subset of the scale, staging m
//    and relu(x) tiles in shared memory.  The blocks at p = 0 and the
//    first D tile also sum m's columns into db_i.  The same 1.69 GFLOP.
//    B = 0 still runs this pass, which then writes zeros.
//
// What bounds it on the card.  At B=202 (128 source + 74 target videos)
// and the flagship widths the two passes do 3.39 GFLOP, 50.6 us at the
// 67 TFLOP/s f32 CUDA-core peak, and must move about 20 MB (x, g, masks
// and 7.3 MB of weights in; dx, and 7.3 MB of dW out), 6 us at 3.35 TB/s:
// bound by f32 FMA issue.  The design keeps every reused operand tile in
// shared memory and 8 outputs per thread in registers (2x4 in the dx pass,
// 4x2 in the dW pass), issues the mask and g loads of m = mask * g
// together, and uses f32 FMA on the CUDA cores: no tensor cores, no TF32.
// The staging loads are not double-buffered: each chunk's FMAs wait for
// its loads from device memory.
// Ragged B, H and D edges are masked in the loads and the stores.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxFrames = 16;
constexpr int kMaxScales = kMaxFrames - 1;
constexpr int kMaxSubsets = 3;
// a frame is in a subset at most once: at most one triple per subset
constexpr int kMaxTriples = 1 + (kMaxScales - 1) * kMaxSubsets;
// (scale, position) pairs: sum of k = S..2
constexpr int kMaxPositions = kMaxFrames * (kMaxFrames + 1) / 2 - 1;
constexpr int kThreads = 128;
// threads of a block as a kTy x kTx grid; a thread owns TM x TN outputs at
// rows ty + kTy*r and columns tx + kTx*c (neighbouring lanes on
// neighbouring columns: conflict-free shared loads, coalesced stores)
constexpr int kTx = 16, kTy = 8;
static_assert(kTx * kTy == kThreads, "thread grid");
constexpr int kTileK = 16;  // reduction chunk: H (dx) or batch (dW)
// outputs per thread, rows x columns: the fastest of the tiles tried on the
// H100 at the train batch (2x2, 2x4, 4x2 and 4x4 per pass; chunks of 16
// and 32)
constexpr int kDxTM = 2, kDxTN = 4;  // batch rows x D columns
constexpr int kDwTM = 4, kDwTN = 2;  // H rows x D columns
constexpr int kDxRows = kTy * kDxTM, kDxCols = kTx * kDxTN;
constexpr int kDwRows = kTy * kDwTM, kDwCols = kTx * kDwTN;
// every staging loop moves whole tiles
static_assert(kDxRows * kTileK % kThreads == 0, "dx: whole m tile");
static_assert(kDxCols * kTileK % kThreads == 0, "dx: whole W tile");
static_assert(kDwRows * kTileK % kThreads == 0, "dW: whole m tile");
static_assert(kDwCols * kTileK % kThreads == 0, "dW: whole x tile");

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
  // per blockIdx.z of the dW pass: its scale and frame position
  int n_pos;
  unsigned char pos_scale[kMaxPositions];
  unsigned char pos_p[kMaxPositions];
};

// m = mask * g, as float: the saved mask picks g or 0.  Both loads are
// issued before either is used, so their latencies overlap.
__device__ __forceinline__ float masked_g(const unsigned char* masks,
                                          const float* g, const Plan& plan,
                                          long long row, int scale, int sub,
                                          int gh, int n_scales, int h) {
  const unsigned char on = masks[(row * plan.n_sub_total + sub) * h + gh];
  const float gv = g[(row * n_scales + scale) * h + gh];
  return on ? gv : 0.f;
}

// grid (ceil(B/kDxRows), ceil(D/kDxCols), S): block (batch tile, D tile,
// frame).
template <int TM, int TN>
__global__ void __launch_bounds__(kThreads)
    trn_fused_bwd_dx_kernel(const __grid_constant__ Plan plan,
                            const float* __restrict__ x,
                            const float* __restrict__ g,
                            const unsigned char* __restrict__ masks,
                            float* __restrict__ dx, int batch,
                            int num_frames, int d, int h) {
  constexpr int kRows = kTy * TM, kCols = kTx * TN;
  __shared__ float ms[kTileK][kRows + 1];  // m^T: [h][b]
  __shared__ float ws[kTileK][kCols];      // W slice: [h][d]
  const int tid = threadIdx.x;
  const int tx = tid % kTx, ty = tid / kTx;
  const int b0 = blockIdx.x * kRows;
  const int d0 = blockIdx.y * kCols;
  const int f = blockIdx.z;
  const int n_scales = num_frames - 1;

  float acc[TM][TN] = {};
  for (int t = 0; t < plan.n_trip[f]; ++t) {
    const int trip = plan.trip[f][t];
    const int i = trip & 15, sub = (trip >> 4) & 63, p = trip >> 10;
    const float* __restrict__ w = plan.w[i];
    const long long row = static_cast<long long>(plan.k[i]) * d;
    const long long col = static_cast<long long>(p) * d + d0;
    for (int h0 = 0; h0 < h; h0 += kTileK) {
#pragma unroll
      for (int n = 0; n < kRows * kTileK / kThreads; ++n) {
        const int e = tid + n * kThreads;
        const int bb = e / kTileK, hh = e % kTileK;
        const int gb = b0 + bb, gh = h0 + hh;
        ms[hh][bb] = (gb < batch && gh < h)
                         ? masked_g(masks, g, plan, gb, i, sub, gh,
                                    n_scales, h)
                         : 0.f;
      }
      // a warp reads consecutive floats of one weight row
#pragma unroll
      for (int n = 0; n < kTileK * kCols / kThreads; ++n) {
        const int e = tid + n * kThreads;
        const int hh = e / kCols, dd = e % kCols;
        const int gh = h0 + hh, gd = d0 + dd;
        ws[hh][dd] = (gh < h && gd < d) ? w[gh * row + col + dd] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int hh = 0; hh < kTileK; ++hh) {
        float a[TM], v[TN];
#pragma unroll
        for (int r = 0; r < TM; ++r) a[r] = ms[hh][ty + kTy * r];
#pragma unroll
        for (int c = 0; c < TN; ++c) v[c] = ws[hh][tx + kTx * c];
#pragma unroll
        for (int r = 0; r < TM; ++r)
#pragma unroll
          for (int c = 0; c < TN; ++c)
            acc[r][c] = fmaf(a[r], v[c], acc[r][c]);
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int r = 0; r < TM; ++r) {
    const int gb = b0 + ty + kTy * r;
    if (gb >= batch) continue;
#pragma unroll
    for (int c = 0; c < TN; ++c) {
      const int gd = d0 + tx + kTx * c;
      if (gd >= d) continue;
      const long long idx =
          (static_cast<long long>(gb) * num_frames + f) * d + gd;
      dx[idx] = x[idx] > 0.f ? acc[r][c] : 0.f;
    }
  }
}

// grid (ceil(D/kDwCols), ceil(H/kDwRows), n_pos = sum_i k_i): block
// (D tile, H tile, (scale, position)).
template <int TM, int TN>
__global__ void __launch_bounds__(kThreads)
    trn_fused_bwd_dw_kernel(const __grid_constant__ Plan plan,
                            const float* __restrict__ x,
                            const float* __restrict__ g,
                            const unsigned char* __restrict__ masks,
                            int batch, int num_frames, int d, int h) {
  constexpr int kRows = kTy * TM, kCols = kTx * TN;
  static_assert(kRows <= kThreads, "one db column per thread");
  __shared__ float ms[kTileK][kRows];  // m: [b][h]
  __shared__ float xs[kTileK][kCols];  // relu(x): [b][d]
  const int tid = threadIdx.x;
  const int tx = tid % kTx, ty = tid / kTx;
  const int d0 = blockIdx.x * kCols;
  const int h0 = blockIdx.y * kRows;
  const int i = plan.pos_scale[blockIdx.z];
  const int p = plan.pos_p[blockIdx.z];
  const int n_scales = num_frames - 1;
  // one block per H tile of each scale also reduces db
  const bool db_block = p == 0 && blockIdx.x == 0;

  float acc[TM][TN] = {};
  float db_acc = 0.f;
  for (int j = 0; j < plan.n_sub[i]; ++j) {
    const int f = plan.frames[i][j][p];
    const int sub = plan.sub0[i] + j;
    for (int b0 = 0; b0 < batch; b0 += kTileK) {
#pragma unroll
      for (int n = 0; n < kTileK * kRows / kThreads; ++n) {
        const int e = tid + n * kThreads;
        const int bb = e / kRows, hh = e % kRows;
        const int gb = b0 + bb, gh = h0 + hh;
        ms[bb][hh] = (gb < batch && gh < h)
                         ? masked_g(masks, g, plan, gb, i, sub, gh,
                                    n_scales, h)
                         : 0.f;
      }
#pragma unroll
      for (int n = 0; n < kTileK * kCols / kThreads; ++n) {
        const int e = tid + n * kThreads;
        const int bb = e / kCols, dd = e % kCols;
        const int gb = b0 + bb, gd = d0 + dd;
        xs[bb][dd] =
            (gb < batch && gd < d)
                ? fmaxf(x[(static_cast<long long>(gb) * num_frames + f) * d +
                          gd],
                        0.f)
                : 0.f;
      }
      __syncthreads();
      if (db_block && tid < kRows) {
        for (int bb = 0; bb < kTileK; ++bb) db_acc += ms[bb][tid];
      }
#pragma unroll
      for (int bb = 0; bb < kTileK; ++bb) {
        float a[TM], v[TN];
#pragma unroll
        for (int r = 0; r < TM; ++r) a[r] = ms[bb][ty + kTy * r];
#pragma unroll
        for (int c = 0; c < TN; ++c) v[c] = xs[bb][tx + kTx * c];
#pragma unroll
        for (int r = 0; r < TM; ++r)
#pragma unroll
          for (int c = 0; c < TN; ++c)
            acc[r][c] = fmaf(a[r], v[c], acc[r][c]);
      }
      __syncthreads();
    }
  }

  float* __restrict__ dw = plan.dw[i];
  const long long row = static_cast<long long>(plan.k[i]) * d;
#pragma unroll
  for (int r = 0; r < TM; ++r) {
    const int gh = h0 + ty + kTy * r;
    if (gh >= h) continue;
#pragma unroll
    for (int c = 0; c < TN; ++c) {
      const int gd = d0 + tx + kTx * c;
      if (gd >= d) continue;
      dw[gh * row + static_cast<long long>(p) * d + gd] = acc[r][c];
    }
  }
  if (db_block && tid < kRows && h0 + tid < h)
    plan.db[i][h0 + tid] = db_acc;
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

// x [batch, num_frames, d] f32, masks [batch, n_sub_total*h] uint8 (from
// ta3n_trn_fused_fwd_train_f32), g [batch, num_frames-1, h] f32 and
// dx [batch, num_frames, d] f32: contiguous on the current device.  w, dw
// and db are host arrays of num_frames-1 device pointers: the weights
// [h, k*d] and their gradients [h, k*d] and [h] (f32, contiguous, written
// whole).  plan_table as for ta3n_trn_fused_fwd_f32.  Launches the dx pass
// (when batch > 0) and then the dW/db pass on `stream`; returns
// cudaGetLastError().
extern "C" int ta3n_trn_fused_bwd_f32(const void* x, const void* const* w,
                                      const void* masks, const void* g,
                                      void* dx, void* const* dw,
                                      void* const* db, const int* plan_table,
                                      int batch, int num_frames, int d, int h,
                                      void* stream) {
  if (num_frames < 2 || num_frames > kMaxFrames || batch < 0 || d < 1 ||
      h < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Plan plan{};
  if (!read_plan(plan, w, dw, db, plan_table, num_frames))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* xf = static_cast<const float*>(x);
  const auto* gf = static_cast<const float*>(g);
  const auto* mf = static_cast<const unsigned char*>(masks);
  if (batch > 0) {
    const dim3 grid((batch + kDxRows - 1) / kDxRows,
                    (d + kDxCols - 1) / kDxCols, num_frames);
    trn_fused_bwd_dx_kernel<kDxTM, kDxTN><<<grid, kThreads, 0, s>>>(
        plan, xf, gf, mf, static_cast<float*>(dx), batch, num_frames, d, h);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((d + kDwCols - 1) / kDwCols, (h + kDwRows - 1) / kDwRows,
                  plan.n_pos);
  trn_fused_bwd_dw_kernel<kDwTM, kDwTN><<<grid, kThreads, 0, s>>>(
      plan, xf, gf, mf, batch, num_frames, d, h);
  return static_cast<int>(cudaGetLastError());
}
