// Fused multi-scale TRN forward, float32 at f32 accuracy on the tensor
// cores (3xTF32 on wgmma), for Hopper (sm_90a): the inference variant and
// the training variant that also writes the relu mask of every subset.
// The bfloat16 variants are trn_fused_fwd_bf16.cu.
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
// at 3.35 TB/s: bound by operations at both.
//
// What the design does about that: three kernels, the GEMM on wgmma
// (tf32_wgmma.cuh, the design of K3's float32 GEMM in gather_gemm.cu).
//  * Stage A, trn_fused_fwd_rows: relu(x) is split once a call into TF32
//    hi and lo planes [members * S, B, P] (frame-major, P = D up to 4s, so
//    that TMA takes a frame's rows as one box): 4.1 MB at B=202.  relu is
//    exact, so x values of at most 11 significant bits have lo = 0.
//  * The GEMM, trn_fused_fwd_kernel, launched as a programmatic dependent
//    of stage A: a block is one scratch slot (scale i, position p, subset
//    j), 128 H rows and N videos (N = 128, or at batches up to 64 the
//    power of two from 8 that holds them, so that a narrow batch does not
//    pay for 128 rows of products: m64nNk8), and computes z^T = W_slice
//    relu(x)^T over its D slice: W_i's position-p columns are the
//    register operand, split in registers as they are loaded from their
//    swizzled TMA box (a rank-4 map (d, k, h, member), so a box never
//    reads the next position's columns), and the frame f_jp's rows of the
//    planes the shared operand.  The D slices of a tile (ops/trn_fused.py::
//    _fwd_splits, from one member's shape) are one cluster, summed in
//    slice order through distributed shared memory; the block of each
//    slice writes its rows of the slot's partial z into a scratch
//    [n_slots, B, H] (slot = the scale's first slot + p*n_sub_i + j).
//  * The epilogue, trn_fused_fwd_epilogue, for each (b, i, h): sums the
//    slot partials of each subset over positions in a fixed order, adds
//    the bias, writes the mask (training variant) and sums relu over the
//    subsets.  No atomics: a second run gives the same bits.  The scratch
//    is sum_i(k_i*n_sub_i) slots x B x H x 4 bytes: 32 slots at S=5, 6.6
//    MB at B=202, which stays in L2; 922 slots at S=25, 190 MB at B=202.
//  * The relation plan is a table in device memory (trn_plan.cuh), sized
//    by the call, so any S is taken.  A block finds its slot's unit with
//    one cooperative pass over the units.
// Ragged B, H and D edges are zero-filled by TMA and masked in the
// stores.  Widths TMA cannot take as they are (D not a multiple of 4, a
// weight not 16-byte aligned, or more than 32 scales for the maps a
// kernel parameter holds): launch_trn_repitch first copies every unit's
// slice into rows of P values, read through one map by unit.
//
// Members (the ensembles, where the Pallas kernel runs under jax.vmap with
// a grid axis over members): blockIdx.y is the member.  Each member reads
// its x, weights and biases and writes its planes, scratch, out and masks
// at one member's size past the one before; member m's weight of scale i
// is m times the weight's h*k*d elements past the pointer (the maps' last
// dimension).  A member's blocks do exactly a one-member launch's work
// (the wrapper slices D by one member's shape), so its outputs are bitwise
// a solo launch's.

#include <cuda.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "smem_optin.cuh"
#include "tf32_wgmma.cuh"
#include "trn_plan.cuh"

namespace {

using ta3n::Plan;
namespace tf = ta3n::tf32;

// stage A: one 16-byte piece (4 values) of an x row a thread
constexpr int kRowsThreads = 256;
// the GEMM: a stage is the W box, then relu(x)'s hi and lo boxes
constexpr int kStages = 4;
constexpr int kStageBytes = 3 * tf::kBoxBytes;
constexpr int kBars = kStages * kStageBytes;
constexpr int kSmem = kBars + 2 * kStages * 8 + 1024;
static_assert(kSmem <= 232448, "the 227 KB opt-in");
static_assert(2 * kSmem > 228 * 1024, "one block an SM");
static_assert(tf::kRedBytes <= kBars, "the partial tile fits the ring");

// Stage A: thread p of member blockIdx.y takes piece p % ceil(D/4) of x
// row p / ceil(D/4) (video b, frame f) into row b of layer member * S + f
// of the hi and lo planes a and a + plane.  kVec: D % 4 == 0 and x
// 16-byte aligned, a piece one load.
template <bool kVec>
__global__ void __launch_bounds__(kRowsThreads)
    trn_fused_fwd_rows(const float* __restrict__ x, float* __restrict__ a,
                       int batch, int num_frames, int d, int pitch,
                       long long plane) {
  // the GEMM may be launched now: it waits for this grid's stores
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const int pieces = (d + 3) / 4;
  const long long rows = static_cast<long long>(batch) * num_frames;
  const long long p =
      static_cast<long long>(blockIdx.x) * kRowsThreads + threadIdx.x;
  if (p >= rows * pieces) return;
  const long long member = blockIdx.y;
  const long long row = p / pieces;
  const int col = static_cast<int>(p % pieces) * 4;
  const float* src = x + (member * rows + row) * d + col;
  float v[4];
  if constexpr (kVec) {
    const float4 q = *reinterpret_cast<const float4*>(src);
    v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) v[e] = col + e < d ? src[e] : 0.f;
  }
  unsigned hi[4], lo[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) ta3n::split_tf32(fmaxf(v[e], 0.f), hi[e], lo[e]);
  const long long b = row / num_frames, f = row % num_frames;
  float* dst = a + ((member * num_frames + f) * batch + b) * pitch + col;
  *reinterpret_cast<uint4*>(dst) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
  *reinterpret_cast<uint4*>(dst + plane) =
      make_uint4(lo[0], lo[1], lo[2], lo[3]);
}

// Every unit's weight slice of every member into rows [members, h,
// n_units, pitch]: for weights whose rows or slices TMA cannot take.
__global__ void trn_fused_repitch(const Plan plan,
                                  const long long* __restrict__ ptrs,
                                  float* __restrict__ out, int d, int h,
                                  int pitch, long long count) {
  for (long long e = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       e < count; e += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int dd = static_cast<int>(e % d);
    long long rest = e / d;
    const int z = static_cast<int>(rest % plan.n_units);
    rest /= plan.n_units;  // member * h + row
    const int k = __ldg(&plan.units[3 * z + 2]).w;
    const int p = __ldg(&plan.units[3 * z]).y;
    const long long member = rest / h, row = rest % h;
    out[rest * plan.n_units * pitch + static_cast<long long>(z) * pitch +
        dd] = ta3n::ptr_at<const float>(ptrs, z)
        [(member * h + row) * k * d + static_cast<long long>(p) * d + dd];
  }
}

// The GEMM's tensor maps: the weights (tf32_wgmma.cuh::trn_weight_maps,
// boxes of 128 rows) and relu(x)'s planes [2 * members * S, B, P] (hi
// layers, then lo), boxes of 32 x N.
struct Maps {
  ta3n::WeightMaps w;
  CUtensorMap x;
};

// The GEMM.  Block (blockIdx.x = (slot * h_tiles + H tile) * b_tiles +
// video tile, member blockIdx.y, D slice blockIdx.z of gridDim.z, a
// cluster along z): the partial z of its slot's kN videos and 128 H
// columns, into part [members, n_slots, B, H].  by_unit: the weights'
// map is by unit (tf32_wgmma.cuh::TrnWeights).  quads: rows of part may
// be written 4 values at a time (H % 4 == 0).
template <int kN>
__global__ void __launch_bounds__(tf::kThreads, 1)
    trn_fused_fwd_kernel(const __grid_constant__ Maps maps, const Plan plan,
                         float* __restrict__ part, int batch, int num_frames,
                         int d, int h, int h_tiles, int b_tiles, int by_unit,
                         int quads) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (ta3n::smem_addr(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kBars);
  uint64_t* empty = full + kStages;
  __shared__ int4 slot_at;  // {map, position coordinate, frame, -}
  const int tid = threadIdx.x;
  const int member = blockIdx.y, members = gridDim.y;
  const int split = blockIdx.z, splits = gridDim.z;
  const int bt = blockIdx.x % b_tiles;
  const int ht = blockIdx.x / b_tiles % h_tiles;
  const int slot = blockIdx.x / b_tiles / h_tiles;
  for (int z = tid; z < plan.n_units; z += tf::kThreads) {
    const int4 u0 = __ldg(&plan.units[3 * z]);  // i, p, n_sub, slot
    if (slot >= u0.w && slot < u0.w + u0.z) {
      const int4 f = __ldg(&plan.units[3 * z + 2]);
      const int j = slot - u0.w;
      slot_at = make_int4(by_unit ? 0 : u0.x, by_unit ? z : u0.y,
                          j == 0 ? f.x : j == 1 ? f.y : f.z, 0);
    }
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
  const int4 at = slot_at;
  const int h0 = ht * tf::kTile, b0 = bt * kN;
  // this block's D slice, in 32-deep chunks (none where splits > chunks)
  const int chunks = (d + tf::kTileK - 1) / tf::kTileK;
  const int c_begin = chunks * split / splits;
  const int n = chunks * (split + 1) / splits - c_begin;

  // one branch a role, never rejoined, so that setmaxnreg holds
  if (tid >= ta3n::kConsumers) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
        tf::kProducerRegs));
    if (tid == ta3n::kConsumers) {
      const int layer = member * num_frames + at.z;
      tf::produce<kStages>(
          n, full, empty,
          [&](int i, int s, uint64_t* bar) {
            ta3n::mbar_arrive_expect_tx(bar, tf::kBoxBytes + 2 * kN * 128);
            ta3n::tma_load_4d(smem + s * kStageBytes, &maps.w.w[at.x],
                              (c_begin + i) * tf::kTileK, at.y, h0, member,
                              bar);
          },
          [&](int i, int s, uint64_t* bar) {
            unsigned char* st = smem + s * kStageBytes;
            const int k0 = (c_begin + i) * tf::kTileK;
            ta3n::tma_load_3d(st + tf::kBoxBytes, &maps.x, k0, b0, layer,
                              bar);
            ta3n::tma_load_3d(st + tf::kBoxBytes + kN * 128, &maps.x, k0, b0,
                              layer + members * num_frames, bar);
          });
    }
    // the consumers' two cluster barriers below
    ta3n::cluster_sync();
    ta3n::cluster_sync();
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
      tf::kConsumerRegs));

  float acc[kN / 2];
  tf::consume<kStages>(
      n, smem, kStageBytes, tf::kBoxBytes, kN * 128, full, empty, acc,
      [&](const unsigned char* st, unsigned (&hi)[4][4],
          unsigned (&lo)[4][4]) {
#pragma unroll
        for (int kk = 0; kk < tf::kTileK / 8; ++kk)
#pragma unroll
          for (int r = 0; r < 4; ++r)
            ta3n::split_tf32(
                *reinterpret_cast<const float*>(st + tf::frag_kmajor(kk, r)),
                hi[kk][r], lo[kk][r]);
      });

  // z^T's tile as z's rows (videos), summed over the cluster's D slices
  float* red = reinterpret_cast<float*>(smem);
  tf::stage_partial<true>(red, acc);
  ta3n::cluster_sync();
  float* out = part + (static_cast<long long>(member) * plan.n_slots + slot) *
                          batch * h;
  tf::cluster_sum<kN>(red, split, splits, [&](int row, int col, float4 v) {
    const int b = b0 + row, hh = h0 + col;
    if (b < batch && hh < h)
      tf::store4(out + static_cast<long long>(b) * h + hh, v, h - hh,
                 quads != 0);
  });
  // no block leaves while the others read its shared memory
  ta3n::cluster_sync();
}

// The epilogue, one thread per (b, i, h) in out's order: z of each subset
// j of scale i is the sum of its float32 slot partials, positions p in
// order, plus the bias (in float32); out = sum_j relu(z_j), and the
// training variant writes (z_j > 0).  Of member blockIdx.y: its scratch,
// bias, out and masks.
template <bool kWithMasks>
__global__ void trn_fused_fwd_epilogue(const Plan plan,
                                       const long long* __restrict__ ptrs,
                                       const float* __restrict__ part,
                                       float* __restrict__ out,
                                       unsigned char* __restrict__ masks,
                                       int batch, int h) {
  const int n_scales = plan.n_scales;
  const long long count = static_cast<long long>(batch) * n_scales * h;
  const long long plane = static_cast<long long>(batch) * h;  // one slot
  const long long member = blockIdx.y;
  part += member * plan.n_slots * plane;
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
    const float* base =
        part + static_cast<long long>(sc.w) * plane + b * h + hh;
    const float bias =
        ta3n::ptr_at<const float>(ptrs, plan.n_units + i)[member * h + hh];
    float sum = 0.f;
    for (int j = 0; j < n_sub; ++j) {
      // the positions' loads issued together, summed in order
      float z = 0.f;
#pragma unroll 8
      for (int p = 0; p < k; ++p)
        z += base[static_cast<long long>(p * n_sub + j) * plane];
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
// device, and past 8 blocks a cluster (smem_optin.cuh).
template <int kN>
cudaError_t allow_smem() {
  static std::atomic<int> granted[ta3n::kMaxDevices];
  return ta3n::allow_smem_on_device(trn_fused_fwd_kernel<kN>, granted, kSmem,
                                    true);
}

// The GEMM's video tile at this batch (ops/trn_fused.py::_f32_fwd_width),
// and its instance with its opt-in.
int video_tile(int batch) {
  for (int n = 8; n <= 64; n *= 2)
    if (batch <= n) return n;
  return tf::kTile;
}

template <int kN>
cudaError_t gemm_for(void (**kernel)(Maps, Plan, float*, int, int, int, int,
                                     int, int, int, int)) {
  *kernel = trn_fused_fwd_kernel<kN>;
  return allow_smem<kN>();
}

template <bool kWithMasks>
int launch(const void* x, const void* ptrs, const void* const* host_ptrs,
           void* out, void* masks, void* scratch, const int* plan_table,
           int plan_len, const int* plan_dev, int batch, int num_frames,
           int d, int h, int splits, int members, void* stream) {
  if (num_frames < 2 || batch < 1 || d < 1 || h < 1 || splits < 1 ||
      splits > tf::kMaxSplits || members < 1 || members > 65535 ||
      scratch == nullptr || ptrs == nullptr || host_ptrs == nullptr ||
      reinterpret_cast<unsigned long long>(scratch) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const ta3n::PlanInfo info =
      ta3n::check_plan(plan_table, plan_len, plan_dev, num_frames);
  if (!info.ok || static_cast<long long>(info.max_k) * d > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long h_tiles = (h + tf::kTile - 1) / tf::kTile;
  const int width = video_tile(batch);
  const long long b_tiles = (batch + width - 1) / width;
  const long long tiles = info.plan.n_slots * h_tiles * b_tiles;
  const long long x_rows = static_cast<long long>(batch) * num_frames;
  const int pieces = (d + 3) / 4;
  const long long rows_blocks =
      (x_rows * pieces + kRowsThreads - 1) / kRowsThreads;
  if (tiles > 0x7fffffffLL || rows_blocks > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);

  // scratch (ops/trn_fused.py::f32_fwd_scratch sizes it alike): the slot
  // partials, relu(x)'s hi and lo planes, then the copied weights where
  // TMA cannot take them as they are
  const tf::TrnWeights how = tf::trn_weights(plan_table, host_ptrs, d);
  float* part = static_cast<float*>(scratch);
  float* planes =
      part + tf::scratch_floats(static_cast<long long>(members) *
                                info.plan.n_slots * batch * h);
  const long long plane =
      static_cast<long long>(members) * x_rows * how.pitch;
  float* w_rows = planes + 2 * plane;
  Maps maps{};
  int err = tf::trn_weight_maps(plan_table, host_ptrs, how, w_rows, d, h,
                                members, tf::kTile, &maps.w);
  if (err == 0)
    err = tf::operand_map(planes, d, batch,
                          2LL * members * num_frames, how.pitch, width,
                          &maps.x);
  if (err != 0) return err;
  void (*kernel)(Maps, Plan, float*, int, int, int, int, int, int, int, int);
  const cudaError_t attr =
      width == 8    ? gemm_for<8>(&kernel)
      : width == 16 ? gemm_for<16>(&kernel)
      : width == 32 ? gemm_for<32>(&kernel)
      : width == 64 ? gemm_for<64>(&kernel)
                    : gemm_for<tf::kTile>(&kernel);
  if (attr != cudaSuccess) return static_cast<int>(attr);

  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* dev_ptrs = static_cast<const long long*>(ptrs);
  if (how.by_unit)
    ta3n::tf32::launch_trn_repitch(info.plan, dev_ptrs, w_rows, d, h,
                                   how.pitch, members, s);
  const bool vec = d % 4 == 0 &&
                   reinterpret_cast<unsigned long long>(x) % 16 == 0;
  (vec ? trn_fused_fwd_rows<true> : trn_fused_fwd_rows<false>)
      <<<dim3(static_cast<unsigned>(rows_blocks), members), kRowsThreads, 0,
         s>>>(static_cast<const float*>(x), planes, batch, num_frames, d,
              how.pitch, plane);
  const cudaError_t rows_err = cudaGetLastError();
  if (rows_err != cudaSuccess) return static_cast<int>(rows_err);

  // the GEMM, launched while stage A runs, a tile's D slices one cluster
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(static_cast<unsigned>(tiles), members, splits);
  config.blockDim = dim3(tf::kThreads);
  config.dynamicSmemBytes = kSmem;
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
      &config, kernel, maps, info.plan, part, batch,
      num_frames, d, h, static_cast<int>(h_tiles), static_cast<int>(b_tiles),
      how.by_unit, h % 4 == 0 ? 1 : 0);
  if (gemm != cudaSuccess) return static_cast<int>(gemm);

  const long long count = static_cast<long long>(batch) * (num_frames - 1) * h;
  const long long epi = (count + 255) / 256;
  trn_fused_fwd_epilogue<kWithMasks>
      <<<dim3(static_cast<unsigned>(epi < 8192 ? epi : 8192), members), 256,
         0, s>>>(info.plan, dev_ptrs, part, static_cast<float*>(out),
                 static_cast<unsigned char*>(masks), batch, h);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

namespace ta3n {
namespace tf32 {
void launch_trn_repitch(const Plan& plan, const long long* ptrs, float* out,
                        int d, int h, int pitch, int members,
                        cudaStream_t stream) {
  const long long count =
      static_cast<long long>(members) * h * plan.n_units * d;
  const long long blocks = (count + 255) / 256;
  trn_fused_repitch<<<static_cast<unsigned>(blocks < 4096 ? blocks : 4096),
                      256, 0, stream>>>(plan, ptrs, out, d, h, pitch, count);
}
}  // namespace tf32
}  // namespace ta3n

// x [batch, num_frames, d], out [batch, num_frames-1, h]: contiguous f32 on
// the current device.  ptrs is a device array of device pointers: for each
// unit (scale, position) of the plan its scale's weight [h, k*d]
// (row-major), then each scale's bias [h]; host_ptrs holds the same
// pointers on the host (their alignment decides whether the weights are
// read as they are).  plan_table (plan_len ints, on the host) and plan_dev
// (the same ints on the device, 16-byte aligned) are the relation plan of
// trn_plan.cuh; a malformed table is refused.  splits (1..16) D slices per
// output tile, one thread block cluster; part is 16-byte aligned scratch
// of ops/trn_fused.py::f32_fwd_scratch float32 values (the slot partials
// [members, n_slots, batch, h], relu(x)'s TF32 planes, the copied weights
// where TMA cannot read them as they are).  members (1..65535) stacked
// members, one grid row each (blockIdx.y): x and out hold them one after
// another (each of the shapes above), and member m's weight of scale i
// and bias are the pointers' + m times the weight's h*k_i*d and the
// bias's h elements (weights [members, h, k_i*d], biases [members, h]).
// Each member's blocks do the work of a one-member launch on its inputs.
// Launches the kernels on `stream` and returns the first error.
extern "C" int ta3n_trn_fused_fwd_f32(const void* x, const void* ptrs,
                                      const void* const* host_ptrs, void* out,
                                      void* part, const int* plan_table,
                                      int plan_len, const int* plan_dev,
                                      int batch, int num_frames, int d, int h,
                                      int splits, int members, void* stream) {
  return launch<false>(x, ptrs, host_ptrs, out, nullptr, part, plan_table,
                       plan_len, plan_dev, batch, num_frames, d, h, splits,
                       members, stream);
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
  return launch<true>(x, ptrs, host_ptrs, out, masks, part, plan_table,
                      plan_len, plan_dev, batch, num_frames, d, h, splits,
                      members, stream);
}
