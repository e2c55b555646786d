// Fused row gather + first-FC GEMM at bfloat16 compute, for Hopper
// (sm_90a): wgmma from 128-byte swizzled shared tiles, from a float32,
// bfloat16 or int8 store.
//
// Replaces ta3n_tpu/ops/gather_gemm.py::_kernel (launched through
// gathered_gemm) under the JAX model's bfloat16 compute: the function of
// gather_gemm.cu (see its head), with W bfloat16 [H, k*D], each gathered
// value scaled and rounded to bfloat16 exactly as there,
//     float32 store  v * row_scale
//     bfloat16 store __fmul_rn(float(v), row_scale)
//     int8 store     __fmul_rn(__fmul_rn(float(q), qscale[row]), row_scale)
// then __float2bfloat16_rn: the value the product and x_res see, bit for
// bit the plain version's.  z = rows @ W^T with float32 accumulation,
// rounded to bfloat16 once (after the split-K sum); x_res holds the
// bfloat16 rows.  gather_gemm.cu's C entry ta3n_gather_gemm_members
// launches this kernel and its split-K sum for compute kind 1.
//
// What bounds it on the card.  At the flagship train shape (N = 640 rows,
// D = 2048, H = 512) the work is 1.34 GFLOP, 1.4 us at the dense bfloat16
// rate of 989 TFLOP/s, against 2.0 MB of W, 2.6 MB of x_res, 0.7 MB of z
// and the rows (1.3 MB from an int8 store, 5.2 MB from a float32 one):
// 2.0-4.5 us at 3.35 TB/s.  So the bound is bytes; what takes the time
// is latency: a block runs only a few K chunks, and each chunk's loads,
// conversion and barriers follow one another.  So the work per staged
// value and per barrier has to be small: no value scaled, rounded and
// packed again by every warp that reads it, many products a barrier.
//
// What the design does about that.
//  * A 64 x 128 output tile per block of two warpgroups, each running
//    wgmma.mma_async m64n64k16 bf16 (wgmma_bf16.cuh) on 64 of the columns
//    with float32 accumulators in registers; both operands K-major from
//    128-byte swizzled shared tiles, the converted rows [64, 64] (shared
//    by the two warpgroups) and W [128, 64] in nn.Linear layout.  At H =
//    512 a gathered row is read by 4 column tiles.
//  * 64-deep K chunks: one 128-byte bfloat16 row fills one swizzle row,
//    four k16 products a chunk.  A chunk never crosses a gathered row, so
//    a staged row has one address and one scale; values past D are zero.
//  * A ring of 3 stages: W by one TMA box a chunk (a 2-d tensor map of W
//    with the 128-byte swizzle, made once per weight, completing on the
//    stage's mbarrier), and the raw rows in their store type by 16-byte
//    cp.async (eight consecutive threads on consecutive pieces of a row,
//    each thread's row addresses in registers, located again only when a
//    chunk passes to the next gathered row).  Widths whose rows are not
//    16-byte aligned (D = 37, 22) are staged by plain loads.
//  * A convert pass, once per block and element: each thread turns eight
//    staged values of a row into bfloat16 as above (at the common row
//    scale 1 the multiply by it is skipped, exactly) and writes them as
//    one 16-byte piece of the A tile (double-buffered, so the next chunk is
//    converted while this one's products run) and, with x_res, as one
//    16-byte store of x_res.  The blocks of a row tile's column tiles
//    share that write: block y writes the rows of 16-row group p when
//    p % min(column tiles, 4) == y.
//  * Split K only where the tiles leave SMs without a block: gridDim.z
//    blocks share an output tile over slices of the chunks into float32
//    partials [splits, M, H], summed in a fixed order and rounded once by
//    gather_gemm_bf16_sum, launched as a programmatic dependent launch so
//    that its launch overlaps this kernel's end (no atomics: a second call
//    gives the same bits); the host's choice is
//    ops/gather_gemm.py::bf16_grid.
// Indices are not checked here: the Python wrapper only launches with
// indices it checked on the host (0 <= idx < R).
//
// Members (ensembles): N weights [N, H, K] over one store in one launch,
// the member folded into blockIdx.y beside the column tiles (member *
// column tiles + tile), W by one rank-3 map with the member outermost
// (wgmma_bf16.cuh).  With one index set for every member the rows are
// gathered N times (from L2 after the first) and x_res is written once,
// by member 0's blocks; with one each, every member writes its own x_res.
// The K slices are chosen from one member's tiles, so each member's z is
// bitwise its solo launch's; a solo launch is N = 1.

#include <cuda.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "bf16.cuh"
#include "smem_optin.cuh"
#include "tf32x3.cuh"
#include "wgmma_bf16.cuh"

namespace {

using ta3n::bf16;

constexpr int kTileM = 64;     // a warpgroup's wgmma rows
constexpr int kTileN = 128;    // output columns per block, 64 a warpgroup
constexpr int kTileK = 64;     // one 128-byte row of bfloat16
constexpr int kThreads = ta3n::kConsumers;  // two warpgroups
constexpr int kStages = 3;
constexpr int kWBytes = kTileN * 128;  // a W tile, K-major

// Raw rows staged in the store's type, 64 values and 16 bytes of padding
// a row; E values make a 16-byte piece, P pieces a row, and each thread
// stages piece tid % P of kRowsPer rows, kRowStep apart.
template <class S>
struct Raw {
  static constexpr int E = 16 / static_cast<int>(sizeof(S));
  static constexpr int P = kTileK / E;
  static constexpr int kPitch = kTileK + E;
  static constexpr int kRowsPer = kTileM * P / kThreads;
  static constexpr int kRowStep = kThreads / P;
  static constexpr int kBytes = kTileM * kPitch * static_cast<int>(sizeof(S));
};

// Dynamic shared memory, from a 1024-byte aligned base: the W tiles of
// the ring, the two converted A tiles, the raw rows of the ring, each
// stage's row scales (an int8 store's scales after them), and each
// stage's mbarrier.
template <class S>
struct Layout {
  static constexpr int kA = kStages * kWBytes;
  static constexpr int kRaw = kA + 2 * ta3n::kPanelBytes;
  static constexpr int kScales = kRaw + kStages * Raw<S>::kBytes;
  static constexpr int kBars = kScales + kStages * 2 * kTileM * 4;
  static constexpr int kEnd = kBars + kStages * 8;
  static constexpr int kSmem = kEnd + 1024;  // room to align the base
};

// Eight staged values from p (16-byte aligned) as float32, exactly (and a
// bfloat16 piece's bits as they are).
__device__ __forceinline__ void load8(const float* p, float (&v)[8],
                                      unsigned (&)[4]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
  v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
}
__device__ __forceinline__ void load8(const bf16* p, float (&v)[8],
                                      unsigned (&bits)[4]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  bits[0] = u.x, bits[1] = u.y, bits[2] = u.z, bits[3] = u.w;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(bits[i] << 16);
    v[2 * i + 1] = __uint_as_float(bits[i] & 0xffff0000u);
  }
}
__device__ __forceinline__ void load8(const int8_t* p, float (&v)[8],
                                      unsigned (&)[4]) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
#pragma unroll
  for (int e = 0; e < 8; ++e)
    v[e] = static_cast<float>(static_cast<int8_t>(
        ((e < 4 ? u.x : u.y) >> (8 * (e % 4))) & 0xffu));
}

// The staged value as the product and x_res see it, before rounding.
template <class S>
__device__ __forceinline__ float value(float v, float rs, float qs) {
  if constexpr (std::is_same_v<S, float>)
    return v * rs;
  else if constexpr (std::is_same_v<S, bf16>)
    return __fmul_rn(v, rs);
  else
    return __fmul_rn(__fmul_rn(v, qs), rs);
}

// grid (ceil(M/64), members * ceil(H/128), splits): blockIdx.y = member
// * column tiles + column tile.  Member m reads W and writes z and part
// at m times one member's size, and reads idx and scale at m * idx_stride
// (0: one index set for all, whose x_res member 0 writes; n_idx: its own,
// and its own x_res).  kVec (D a multiple of 8 and of a 16-byte piece of
// the store, 16-byte aligned store, W and x_res): the rows are staged by
// 16-byte cp.async, each W tile is one TMA box of w_map completing on the
// stage's mbarrier, and x_res is stored 16 bytes at a time; else plain
// loads.  With splits > 1 the block writes float32 partials into part
// (summed by gather_gemm_bf16_sum), else bfloat16 values into z.
template <class S, bool kVec>
__global__ void __launch_bounds__(kThreads, 2)
    gather_gemm_bf16_kernel(const __grid_constant__ CUtensorMap w_map,
                            const S* __restrict__ store,
                            const float* __restrict__ qscale,
                            const int* __restrict__ idx,
                            const float* __restrict__ scale,
                            const bf16* __restrict__ w, bf16* __restrict__ z,
                            float* __restrict__ part,
                            bf16* __restrict__ x_res, long long m_rows,
                            int streams, int d, int k_rows, int h,
                            long long idx_stride) {
  using R = Raw<S>;
  using L = Layout<S>;
  constexpr bool kInt8 = std::is_same_v<S, int8_t>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (ta3n::smem_addr(smem_raw) & 1023)) & 1023);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::kBars);

  const int tid = threadIdx.x, lane = tid % 32;
  const int wg = tid / 128, warp = tid % 128 / 32;  // warp of its group
  const long long m0 = static_cast<long long>(blockIdx.x) * kTileM;
  const int h_tiles = (h + kTileN - 1) / kTileN;
  const int member = blockIdx.y / h_tiles, h_tile = blockIdx.y % h_tiles;
  const int h0 = h_tile * kTileN;
  const long long kdim = static_cast<long long>(k_rows) * d;  // W row
  w += static_cast<long long>(member) * h * kdim;
  z += static_cast<long long>(member) * m_rows * h;
  idx += member * idx_stride;
  if (scale != nullptr) scale += member * idx_stride;
  if (gridDim.z > 1)
    part += (static_cast<long long>(member) * gridDim.z + blockIdx.z) *
            m_rows * h;
  const int valid_rows =
      m_rows - m0 < kTileM ? static_cast<int>(m_rows - m0) : kTileM;
  // the x_res rows of 16-row group p this block writes: p % writers ==
  // its column tile; of shared indices only member 0's blocks write
  const int writers = h_tiles < 4 ? h_tiles : 4;
  const bool write_any = x_res != nullptr && h_tile < 4 &&
                         (idx_stride != 0 || member == 0);
  if (write_any) x_res += static_cast<long long>(member) * m_rows * kdim;

  // this block's K slice, in chunks of kTileK within one gathered row
  const int per_row = (d + kTileK - 1) / kTileK;
  const long long chunks = static_cast<long long>(k_rows) * per_row;
  const int c_begin = static_cast<int>(chunks * blockIdx.z / gridDim.z);
  const int c_end = static_cast<int>(chunks * (blockIdx.z + 1) / gridDim.z);

  if constexpr (kVec) {
    if (tid == 0) {
#pragma unroll
      for (int s = 0; s < kStages; ++s) ta3n::mbar_init(&bars[s], 1);
      ta3n::mbar_fence_init();
    }
    __syncthreads();
  }

  // the rows this thread stages, of the current chunk's gathered row j
  // (located again only when a chunk passes to the next gathered row):
  // rows srow0 + kRowStep * i, i < kRowsPer (kVec), or row tid % 64 (a
  // quarter of it each by four threads)
  constexpr int kRows = kVec ? R::kRowsPer : 1;
  const int piece = tid % R::P;
  const int srow0 = kVec ? tid / R::P : tid % kTileM;
  int row_j = -1;
  const S* rows[kRows];
  float row_scale[kRows], row_q[kRows];
  auto locate = [&](int j) {
    row_j = j;
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const long long m = m0 + srow0 + R::kRowStep * i;
      rows[i] = nullptr;
      row_scale[i] = 0.f;
      row_q[i] = 1.f;
      if (m < m_rows) {
        const long long q = m * k_rows + j;
        const long long n = q / streams;
        const long long r = idx[n];
        rows[i] = store + (r * streams + q % streams) * d;
        row_scale[i] = scale != nullptr ? scale[n] : 1.f;
        if constexpr (kInt8) row_q[i] = qscale[r];
      }
    }
  };

  auto issue = [&](int c, int s) {
    c += c_begin;
    const int j = c / per_row;
    const int c0 = (c % per_row) * kTileK;
    unsigned char* wt = smem + s * kWBytes;
    S* raw = reinterpret_cast<S*>(smem + L::kRaw + s * R::kBytes);
    float* scales = reinterpret_cast<float*>(smem + L::kScales) +
                    s * 2 * kTileM;
    const int cols = d - c0 < kTileK ? d - c0 : kTileK;
    if constexpr (kVec) {
      // W first (it needs no index), by one thread of the last warp
      if (tid == kThreads - 32) {
        ta3n::mbar_arrive_expect_tx(&bars[s], kWBytes);
        ta3n::tma_load_3d(wt, &w_map, static_cast<int>(j * d + c0), h0,
                          member, &bars[s]);
      }
    }
    if (j != row_j) locate(j);
    if constexpr (kVec) {
      const int col = piece * R::E;
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const int r = srow0 + R::kRowStep * i;
        if (piece == 0) {
          scales[r] = row_scale[i];
          if constexpr (kInt8) scales[kTileM + r] = row_q[i];
        }
        const bool in = rows[i] != nullptr && col < cols;
        ta3n::cp_async16(raw + r * R::kPitch + col,
                         in ? rows[i] + c0 + col : store, in ? 16 : 0);
      }
      ta3n::cp_async_commit();
    } else {
      // the row chunk by four threads, a quarter each; W by pieces
      const int quarter = tid / kTileM;
      if (quarter == 0) {
        scales[srow0] = row_scale[0];
        if constexpr (kInt8) scales[kTileM + srow0] = row_q[0];
      }
#pragma unroll
      for (int pc = 0; pc < R::P / 4; ++pc) {
        const int col = (quarter * R::P / 4 + pc) * R::E;
        ta3n::copy_bytes16(raw + srow0 * R::kPitch + col,
                           rows[0] != nullptr ? rows[0] + c0 + col : store,
                           rows[0] != nullptr ? cols - col : 0);
      }
      const int wpiece = tid % 8, wrow0 = tid / 8;
#pragma unroll
      for (int i = 0; i < kTileN * 8 / kThreads; ++i) {
        const int r = wrow0 + kThreads / 8 * i;
        const int gh = h0 + r;
        const bf16* src =
            w + gh * kdim + static_cast<long long>(j) * d + c0 + 8 * wpiece;
        ta3n::copy_bytes16(wt + ta3n::swizzle128(r * 128 + wpiece * 16),
                           gh < h ? src : w, gh < h ? cols - 8 * wpiece : 0);
      }
    }
  };
  const int n_chunks = c_end - c_begin;
  auto land = [&](int c, int s) {
    if constexpr (kVec) {
      ta3n::cp_async_land<kStages>(c, n_chunks);
      ta3n::mbar_wait(&bars[s], (c / kStages) & 1);
    }
  };

  // convert: piece cp = tid % 8 (values 8cp..8cp+7) of rows
  // tid / 8 + 32p, p = 0, 1; rows past M and values past D become 0
  constexpr int kConv = kTileM * 8 / kThreads, kConvStep = kThreads / 8;
  const int cp = tid % 8, crow0 = tid / 8;
  auto convert = [&](int c, int s) {
    const S* raw = reinterpret_cast<const S*>(smem + L::kRaw + s * R::kBytes);
    const float* scales = reinterpret_cast<const float*>(smem + L::kScales) +
                          s * 2 * kTileM;
    unsigned char* a = smem + L::kA + (c % 2) * ta3n::kPanelBytes;
    const int cg = c + c_begin;
    const int j = cg / per_row;
    const int col = (cg % per_row) * kTileK + 8 * cp;
    // all loads first, then the stores (the compiler cannot tell the
    // shared addresses apart and would wait out each load in turn); the
    // rows are 32 apart, so their swizzled pieces 4096 bytes apart
    float v[kConv][8], rs[kConv], qs[kConv];
    unsigned raw_bits[kConv][4];  // a bfloat16 row's piece as staged
#pragma unroll
    for (int p = 0; p < kConv; ++p) {
      const int r = crow0 + kConvStep * p;
      rs[p] = scales[r];
      qs[p] = kInt8 ? scales[kTileM + r] : 1.f;
      load8(raw + r * R::kPitch + 8 * cp, v[p], raw_bits[p]);
    }
    unsigned char* a_piece = a + ta3n::swizzle128(crow0 * 128 + cp * 16);
    bf16* x_row = x_res + ((m0 + crow0) * k_rows + j) * d + col;
    const long long x_step = static_cast<long long>(kConvStep) * k_rows * d;
#pragma unroll
    for (int p = 0; p < kConv; ++p) {
      const int r = crow0 + kConvStep * p;
      const bool row_in = r < valid_rows;
      unsigned packed[4];
      if (kVec && rs[p] == 1.f) {
        // the common row scale: the multiply by it is exact and skipped
        // (a bfloat16 row is its own rounding, bit for bit but for a NaN's
        // payload)
        const bool in = row_in && col < d;
#pragma unroll
        for (int e = 0; e < 8; e += 2) {
          if constexpr (std::is_same_v<S, bf16>)
            packed[e / 2] = raw_bits[p][e / 2];
          else
            packed[e / 2] = ta3n::pack2f(value<S>(v[p][e], 1.f, qs[p]),
                                         value<S>(v[p][e + 1], 1.f, qs[p]));
          if (!in) packed[e / 2] = 0;
        }
      } else {
#pragma unroll
        for (int e = 0; e < 8; e += 2) {
          const bool in0 = row_in && (kVec ? col < d : col + e < d);
          const bool in1 = row_in && (kVec ? col < d : col + e + 1 < d);
          packed[e / 2] = ta3n::pack2f(
              in0 ? value<S>(v[p][e], rs[p], qs[p]) : 0.f,
              in1 ? value<S>(v[p][e + 1], rs[p], qs[p]) : 0.f);
        }
      }
      const uint4 piece = make_uint4(packed[0], packed[1], packed[2],
                                     packed[3]);
      *reinterpret_cast<uint4*>(a_piece + kConvStep * 128 * p) = piece;
      if (write_any && r / 16 % writers == h_tile && row_in && col < d) {
        bf16* dst = x_row + x_step * p;
        if constexpr (kVec) {
          *reinterpret_cast<uint4*>(dst) = piece;
        } else {
          const bf16* vals = reinterpret_cast<const bf16*>(&piece);
#pragma unroll
          for (int e = 0; e < 8; ++e)
            if (col + e < d) dst[e] = vals[e];
        }
      }
    }
  };

  // each warpgroup's half of the tile: columns (W rows) 64wg..64wg+63
  float acc[kTileN / 4] = {};
  auto mma = [&](int c, int s) {
    const uint64_t a =
        ta3n::kmajor_desc(smem + L::kA + (c % 2) * ta3n::kPanelBytes);
    const uint64_t b =
        ta3n::kmajor_desc(smem + s * kWBytes + wg * (kTileN / 2) * 128);
#pragma unroll
    for (int k = 0; k < kTileK / 16; ++k)
      ta3n::wgmma<0, 0>(acc, a + k * ta3n::kKMajorStep,
                        b + k * ta3n::kKMajorStep);
  };
  ta3n::wgmma_pipeline<kStages>(n_chunks, acc, issue, land, convert, mma);
  // the split-K sum may be launched now; it waits for this grid's stores
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");

  const bool pairs = h % 2 == 0;
#pragma unroll
  for (int jn = 0; jn < kTileN / 16; ++jn)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const long long om = m0 + 16 * warp + lane / 4 + 8 * i;
      const int oh = h0 + kTileN / 2 * wg + 8 * jn + 2 * (lane % 4);
      if (om >= m_rows || oh >= h) continue;
      const float v0 = acc[4 * jn + 2 * i], v1 = acc[4 * jn + 2 * i + 1];
      if (gridDim.z > 1) {
        float* dst = part + om * h + oh;
        if (pairs) {
          *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
        } else {
          dst[0] = v0;
          if (oh + 1 < h) dst[1] = v1;
        }
      } else {
        bf16* dst = z + om * h + oh;
        if (pairs) {
          *reinterpret_cast<unsigned*>(dst) = ta3n::pack2f(v0, v1);
        } else {
          dst[0] = __float2bfloat16_rn(v0);
          if (oh + 1 < h) dst[1] = __float2bfloat16_rn(v1);
        }
      }
    }
}

// z[i] = sum over s of part[s][i], s in order, rounded to bfloat16 once:
// the split-K sum of each member (part [members, splits, count], z
// [members, count]), four elements a thread where count % 4 == 0.
__global__ void gather_gemm_bf16_sum(const float* __restrict__ part,
                                     bf16* __restrict__ z, long long count,
                                     int splits, int members) {
  // the partials of the kernel before it on the stream, complete
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long first =
      blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  if (count % 4 == 0) {
    const long long n4 = count / 4;
    const float4* part4 = reinterpret_cast<const float4*>(part);
    for (long long e = first; e < n4 * members; e += step) {
      const float4* p = part4 + e / n4 * splits * n4 + e % n4;
      float4 sum = p[0];
      for (int s = 1; s < splits; ++s) {
        const float4 v = p[s * n4];
        sum.x += v.x;
        sum.y += v.y;
        sum.z += v.z;
        sum.w += v.w;
      }
      reinterpret_cast<uint2*>(z)[e] =
          make_uint2(ta3n::pack2f(sum.x, sum.y), ta3n::pack2f(sum.z, sum.w));
    }
  } else {
    for (long long e = first; e < count * members; e += step) {
      const float* p = part + e / count * splits * count + e % count;
      float sum = p[0];
      for (int s = 1; s < splits; ++s) sum += p[s * count];
      z[e] = __float2bfloat16_rn(sum);
    }
  }
}

// Above 48 KB of dynamic shared memory a kernel must opt in, once on each
// device (smem_optin.cuh).
template <class S, bool kVec>
cudaError_t allow_smem() {
  static std::atomic<int> granted[ta3n::kMaxDevices];
  return ta3n::allow_smem_on_device(gather_gemm_bf16_kernel<S, kVec>,
                                    granted, Layout<S>::kSmem);
}

template <class S>
int launch(const void* store, const void* qscale, const void* idx,
           const void* scale, const void* w, void* z, void* x_res,
           void* part, long long m_rows, int streams, int d, int k_rows,
           int h, int splits, int members, long long idx_stride,
           cudaStream_t stream) {
  const long long tiles = (m_rows + kTileM - 1) / kTileM;
  const long long h_tiles = (h + kTileN - 1) / kTileN;
  if (tiles > 0x7fffffffLL || h_tiles * members > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto aligned = [](const void* p) {
    return reinterpret_cast<unsigned long long>(p) % 16 == 0;
  };
  // (D % 8 == 0 makes W's strides, the members' too, multiples of 16
  // bytes, and each member's x_res and W 16-byte aligned)
  const bool vec = d % 8 == 0 && d % Raw<S>::E == 0 && aligned(store) &&
                   aligned(w) && (x_res == nullptr || aligned(x_res));
  CUtensorMap map{};
  if (vec) {
    const int err = ta3n::weight_map(w, static_cast<long long>(k_rows) * d,
                                     h, members, kTileK, kTileN, &map);
    if (err != 0) return err;
  }
  const cudaError_t attr =
      vec ? allow_smem<S, true>() : allow_smem<S, false>();
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid(static_cast<unsigned>(tiles),
                  static_cast<unsigned>(h_tiles * members), splits);
  (vec ? gather_gemm_bf16_kernel<S, true>
       : gather_gemm_bf16_kernel<S, false>)
      <<<grid, kThreads, Layout<S>::kSmem, stream>>>(
          map, static_cast<const S*>(store),
          static_cast<const float*>(qscale), static_cast<const int*>(idx),
          static_cast<const float*>(scale), static_cast<const bf16*>(w),
          static_cast<bf16*>(z), static_cast<float*>(part),
          static_cast<bf16*>(x_res), m_rows, streams, d, k_rows, h,
          idx_stride);
  if (splits > 1) {
    // launched while the first kernel runs (programmatic dependent
    // launch); it waits for that kernel's partials before reading them
    const long long count = m_rows * h;
    const long long blocks = (count * members / 4 + 255) / 256;
    cudaLaunchConfig_t config = {};
    config.gridDim = dim3(static_cast<unsigned>(blocks < 1024 ? blocks + 1
                                                              : 1024));
    config.blockDim = dim3(256);
    config.stream = stream;
    cudaLaunchAttribute early[1];
    early[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    early[0].val.programmaticStreamSerializationAllowed = 1;
    config.attrs = early;
    config.numAttrs = 1;
    const cudaError_t err = cudaLaunchKernelEx(
        &config, gather_gemm_bf16_sum, static_cast<const float*>(part),
        static_cast<bf16*>(z), count, splits, members);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

namespace ta3n {

// The kernel's launch for store_kind 0 (float32), 1 (bfloat16) or 2
// (int8), on arguments that ta3n_gather_gemm_members (gather_gemm.cu)
// checked, of `members` members (idx and scale idx_stride apart: 0 when
// shared), and with splits > 1 its split-K sum from part [members,
// splits, m, h] float32.  Returns cudaGetLastError().
int launch_gather_gemm_bf16(const void* store, const void* qscale,
                            const void* idx, const void* scale,
                            const void* w, void* z, void* x_res, void* part,
                            long long m_rows, int streams, int d, int k_rows,
                            int h, int splits, int store_kind, int members,
                            long long idx_stride, cudaStream_t stream) {
  if (store_kind == 0)
    return launch<float>(store, qscale, idx, scale, w, z, x_res, part,
                         m_rows, streams, d, k_rows, h, splits, members,
                         idx_stride, stream);
  if (store_kind == 1)
    return launch<bf16>(store, qscale, idx, scale, w, z, x_res, part,
                        m_rows, streams, d, k_rows, h, splits, members,
                        idx_stride, stream);
  if (store_kind == 2)
    return launch<int8_t>(store, qscale, idx, scale, w, z, x_res, part,
                          m_rows, streams, d, k_rows, h, splits, members,
                          idx_stride, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace ta3n
