// Building blocks of the kernels on Hopper's warpgroup matrix multiply
// (gather_gemm_bf16.cu, trn_fused_fwd_bf16.cu, trn_fused_bwd_bf16.cu, and
// the float32 kernels, whose tf32 products are tf32_wgmma.cuh's):
// shared-memory tiles in the 128-byte swizzled layout, their matrix
// descriptors, the asynchronous products wgmma.mma_async m64nNk16 bf16
// with float32 accumulation, the fences and waits around them, TMA
// tensor maps and mbarriers, and the exchange within a thread block
// cluster.
//
// Tiles.  Every operand tile in shared memory is made of panels of rows
// of 64 bfloat16 values (128 bytes), panels 8 KB apart, each panel
// 1024-byte aligned, and within a panel the 16-byte pieces of row r
// permuted by XOR with r % 8 (swizzle128): the layout of
// CU_TENSOR_MAP_SWIZZLE_128B, which wgmma reads without bank conflicts.
// Eight rows (1024 bytes) form one swizzle atom.
//  * K-major operand (a row per M or N index, K along the row): one panel
//    of up to 256 rows of a 64-deep K chunk.  Descriptor: SBO 1024 bytes
//    between atoms of 8 rows; LBO unused.  A k16 step is +32 bytes on the
//    start address (the hardware swizzles the address it computes).
//  * MN-major operand (a row per K index, M or N along the row, taken
//    with the transpose bit): 64 K rows a panel, one panel per 64 M or N
//    columns.  Descriptor: SBO 1024 bytes between atoms of 8 K rows, LBO
//    8192 bytes between panels.  A k16 step is +2048 bytes (two atoms).
// A product of two bfloat16 values is exact in float32, so a wgmma sum is
// the float32 dot of the bfloat16 operands up to the order of the sum, as
// the mma.sync m16n8k16 of bf16.cuh.
//
// Accumulator fragment of m64nNk16 (PTX ISA, "wgmma ... register
// fragments"): thread t of the warpgroup (warp w = t / 32, lane l) holds
// d[4j + 2i + e] = D[16w + l/4 + 8i][8j + 2(l%4) + e], i, e in {0, 1}, for
// the N/8 column blocks j: the m16n8 C fragment of bf16.cuh, warp w on
// rows 16w..16w+15.
//
// Ordering.  Shared stores of the generic proxy (plain st.shared and
// cp.async) are made visible to wgmma, which reads through the async
// proxy, by fence.proxy.async.shared::cta in the writing threads and then
// a barrier; TMA boxes land in the async proxy and are visible once their
// mbarrier phase completes.  wgmma.fence orders the accumulator registers
// and shared memory before the first product of a batch; commit_group
// closes a batch and wait_group<N> waits until at most N batches of this
// warpgroup are in flight, after which their tiles may be overwritten
// (once the other warpgroup's batches are done with them too).
//
// Rings.  wgmma_pipeline: every thread stages, converts and multiplies, a
// chunk ahead (K1's and K2's plain-load variants).  wgmma_pipeline_ws: a
// producer warp issues TMA boxes up to kStages chunks ahead, the consumer
// warpgroups convert (K1, K2) or not (K3, whose rows were converted by a
// kernel before it) and multiply.
//
// Weight maps.  The tensor map of a weight is made on the host once per
// pointer, shape, member count and box (weight_map, a cache: a map holds
// only those, so it stays right for any weight later allocated there) and
// reaches the kernel by value, as a __grid_constant__ parameter
// (WeightMaps: one per TRN scale, up to kMaxWeightMaps), so a launch
// copies nothing to the device and a captured CUDA graph replays it as it
// is.  Members (ensembles, one launch for N members' stacked weights [N,
// rows, row]): a map is rank 3, the member its outermost coordinate (a
// box depth of 1, the member stride rows * row * 2 bytes), so one map per
// scale serves every member and the parameter's size does not grow with
// N; a solo launch is N = 1.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <initializer_list>
#include <mutex>

#include "tf32x3.cuh"
#include "trn_plan.cuh"

namespace ta3n {

constexpr int kPanelBytes = 8192;  // 64 rows of 128 bytes
constexpr int kAtomBytes = 1024;   // 8 rows of 128 bytes

// The swizzled byte offset of the byte at `off` within a 1024-byte
// aligned panel (or a run of them): 16-byte piece (off >> 4) & 7 of row
// off >> 7 moves to piece ((off >> 4) ^ (off >> 7)) & 7.
__device__ __forceinline__ unsigned swizzle128(unsigned off) {
  return off ^ ((off >> 3) & 0x70u);
}

// The byte offset of element (row, col) of a bfloat16 tile of 64-column
// panels: row within its panel, column col % 64 of panel col / 64.
__device__ __forceinline__ unsigned tile_offset(int row, int col) {
  return static_cast<unsigned>(col / 64) * kPanelBytes +
         swizzle128(static_cast<unsigned>(row * 128 + (col % 64) * 2));
}

// The matrix descriptor of a 128-byte swizzled tile at `tile` (1024-byte
// aligned in shared memory): start address, LBO and SBO in 16-byte units,
// layout type 1 (128-byte swizzle), base offset 0.
__device__ __forceinline__ uint64_t tile_desc(const void* tile, unsigned lbo,
                                              unsigned sbo) {
  return static_cast<uint64_t>((smem_addr(tile) & 0x3ffffu) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3fffu) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3fffu) << 32 |
         static_cast<uint64_t>(1) << 62;
}
__device__ __forceinline__ uint64_t kmajor_desc(const void* tile) {
  return tile_desc(tile, 16, kAtomBytes);
}
__device__ __forceinline__ uint64_t mnmajor_desc(const void* tile) {
  return tile_desc(tile, kPanelBytes, kAtomBytes);
}
// the descriptor advanced by k16 steps (the address field is in 16-byte
// units): K-major 32 bytes a step, MN-major two atoms
constexpr uint64_t kKMajorStep = 32 >> 4;
constexpr uint64_t kMNMajorStep = (2 * kAtomBytes) >> 4;

// A barrier of the first `count` threads of the block (barrier 1; 0 is
// __syncthreads'), for the consumer warpgroups when a producer warp runs
// beside them.
__device__ __forceinline__ void named_sync(int count) {
  asm volatile("bar.sync 1, %0;\n" ::"r"(count) : "memory");
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// mbarriers and the TMA copies that complete on them: a stage's barrier
// is armed by the thread that issues its boxes, with the bytes they bring
// (arrive.expect_tx), and its phase completes once they have all landed.
__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}
// wait until the phase of the given parity has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n.reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}
// The box at coordinates (c0 innermost, c1) of the 2-d tensor map `map`
// (a __grid_constant__ kernel parameter) into shared dst, completing on
// bar; out-of-range elements are zero-filled.
__device__ __forceinline__ void tma_load_2d(void* dst, const void* map,
                                            int c0, int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
      "r"(smem_addr(bar))
      : "memory");
}

// The same for a 3-d tensor map.
__device__ __forceinline__ void tma_load_3d(void* dst, const void* map,
                                            int c0, int c1, int c2,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(smem_addr(bar))
      : "memory");
}

// The same for a 4-d tensor map.
__device__ __forceinline__ void tma_load_4d(void* dst, const void* map,
                                            int c0, int c1, int c2, int c3,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(smem_addr(bar))
      : "memory");
}
// A cluster-wide barrier of every thread of the cluster's blocks, which
// orders their shared-memory stores before the reads after it (a launch
// without clusters is a cluster of one block).
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release;\n"
      "barrier.cluster.wait.acquire;\n" ::: "memory");
}

// Four float32 values at shared address `addr` of this block, read in the
// block of rank `rank` of the cluster (after a cluster_sync that published
// them; no write follows before the next one).
__device__ __forceinline__ float4 ld_cluster4(unsigned addr, unsigned rank) {
  unsigned remote;
  asm("mapa.shared::cluster.u32 %0, %1, %2;\n"
      : "=r"(remote)
      : "r"(addr), "r"(rank));
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(remote));
  return v;
}

// A tiled tensor map on the host (rank 2 to 4): dims innermost first, the
// byte strides of the outer dims (multiples of 16), the box, unit element
// steps, zeros out of range.  cuTensorMapEncodeTiled is fetched from the
// driver through the runtime, so the library links only cudart.  Returns a
// cudaError_t.
inline int encode_map(CUtensorMap* map, CUtensorMapDataType type, int rank,
                      const void* base, std::initializer_list<cuuint64_t> dims,
                      std::initializer_list<cuuint64_t> strides,
                      std::initializer_list<cuuint32_t> box,
                      CUtensorMapSwizzle swizzle) {
  using Encode = CUresult (*)(
      CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
      const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
      CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
      CUtensorMapFloatOOBfill);
  static const Encode encode = [] {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn,
                                cudaEnableDefault, &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      fn = nullptr;
    return reinterpret_cast<Encode>(fn);
  }();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  if (rank < 1 || rank > 4 || static_cast<int>(dims.size()) != rank ||
      static_cast<int>(strides.size()) != rank - 1 ||
      static_cast<int>(box.size()) != rank)
    return static_cast<int>(cudaErrorInvalidValue);
  const cuuint32_t steps[4] = {1, 1, 1, 1};
  return encode(map, type, static_cast<cuuint32_t>(rank),
                const_cast<void*>(base), dims.begin(), strides.begin(),
                box.begin(), steps, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS
             ? static_cast<int>(cudaSuccess)
             : static_cast<int>(cudaErrorInvalidValue);
}

// The tensor map of `members` stacked bfloat16 (or, with `type` FLOAT32,
// float32) weights [members, rows, row] (row-major, 128-byte swizzle,
// zeros out of range), rank 3 with the member outermost, in boxes of box_k
// columns x box_rows rows of one member, made once per pointer, type,
// shape, member count and box and then taken from a cache.  Returns a
// cudaError_t.
inline int weight_map(const void* w, long long row, int rows, int members,
                      int box_k, int box_rows, CUtensorMap* out,
                      CUtensorMapDataType type =
                          CU_TENSOR_MAP_DATA_TYPE_BFLOAT16) {
  struct Entry {
    const void* w;
    CUtensorMapDataType type;
    long long row;
    int rows, members, box_k, box_rows;
    CUtensorMap map;
  };
  constexpr int kCache = 64;
  static std::mutex mu;
  static Entry cache[kCache];
  static int cached = 0, next = 0;
  const std::lock_guard<std::mutex> lock(mu);
  for (int i = 0; i < cached; ++i) {
    const Entry& e = cache[i];
    if (e.w == w && e.type == type && e.row == row && e.rows == rows &&
        e.members == members && e.box_k == box_k && e.box_rows == box_rows) {
      *out = e.map;
      return 0;
    }
  }
  const cuuint64_t pitch = static_cast<cuuint64_t>(row) *
                           (type == CU_TENSOR_MAP_DATA_TYPE_FLOAT32 ? 4 : 2);
  const int err = encode_map(
      out, type, 3, w,
      {static_cast<cuuint64_t>(row), static_cast<cuuint64_t>(rows),
       static_cast<cuuint64_t>(members)},
      {pitch, pitch * static_cast<cuuint64_t>(rows)},
      {static_cast<cuuint32_t>(box_k), static_cast<cuuint32_t>(box_rows), 1},
      CU_TENSOR_MAP_SWIZZLE_128B);
  if (err != 0) return err;
  cache[next] = {w, type, row, rows, members, box_k, box_rows, *out};
  next = (next + 1) % kCache;
  if (cached < kCache) ++cached;
  return 0;
}

// The most TRN scales (S - 1) whose weight maps a kernel takes by value:
// 32, 4 KB of maps.  CUDA 12.1 and later take up to 32764 bytes of kernel
// parameters on sm_70 and above; the kernels' other parameters take well
// under 1 KB.
constexpr int kMaxWeightMaps = 32;
constexpr int kParamLimit = 32764;
struct WeightMaps {
  CUtensorMap w[kMaxWeightMaps];
};
static_assert(sizeof(WeightMaps) + 1024 <= kParamLimit,
              "the weight maps fit the kernel parameters");

// Each scale's weight map: the members' weights [members, h, k_i*d] of
// scale i, whose pointer is host_ptrs at the scale's first unit (the plan
// table's scale records give k_i), in boxes of box_k columns x box_rows
// rows of one member.  Returns a cudaError_t.
inline int scale_weight_maps(const int* plan_table, int n_scales,
                             const void* const* host_ptrs, int d, int h,
                             int members, int box_k, int box_rows,
                             WeightMaps* maps) {
  if (n_scales > kMaxWeightMaps)
    return static_cast<int>(cudaErrorInvalidValue);
  const int* scales = plan_table + kPlanHeader;
  for (int i = 0, z = 0; i < n_scales; z += scales[kScaleInts * i], ++i) {
    const int err = weight_map(
        host_ptrs[z], static_cast<long long>(scales[kScaleInts * i]) * d, h,
        members, box_k, box_rows, &maps->w[i]);
    if (err != 0) return err;
  }
  return 0;
}

// 16 bytes from src into shared dst, of which the first `valid` elements
// of T exist (none when valid <= 0: src is then not read), by plain byte
// loads and shared stores, which a ring's barrier publishes; the rest
// zero-filled.  For widths whose rows are not 16-byte aligned.
template <class T>
__device__ __forceinline__ void copy_bytes16(void* dst, const T* src,
                                             int valid) {
  const int bytes = valid * static_cast<int>(sizeof(T));
  const unsigned char* s = reinterpret_cast<const unsigned char*>(src);
  unsigned char* d = static_cast<unsigned char*>(dst);
#pragma unroll
  for (int b = 0; b < 16; ++b) d[b] = b < bytes ? s[b] : 0;
}

// Keeps the compiler from moving accesses of the accumulators across the
// asynchronous products that write them.
template <int N>
__device__ __forceinline__ void fence_operands(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D[64 x N] += A[64 x 16] B[16 x N], A and B from the descriptors a and b,
// kTransA / kTransB 1 for an MN-major operand.
template <int kTransA, int kTransB>
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32],
                                              uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(1), "n"(kTransA), "n"(kTransB));
}

template <int kTransA, int kTransB>
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64],
                                              uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, %67, %68;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(1), "n"(kTransA), "n"(kTransB));
}

template <int kTransA, int kTransB>
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128],
                                              uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, %131, %132;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(a), "l"(b), "r"(1), "n"(kTransA), "n"(kTransB));
}

// The product of the width of d: m64n{2 * size of d}k16.
template <int kTransA, int kTransB, int N>
__device__ __forceinline__ void wgmma(float (&d)[N], uint64_t a, uint64_t b) {
  if constexpr (N == 32)
    wgmma_m64n64k16<kTransA, kTransB>(d, a, b);
  else if constexpr (N == 64)
    wgmma_m64n128k16<kTransA, kTransB>(d, a, b);
  else {
    static_assert(N == 128, "m64n64, m64n128 or m64n256");
    wgmma_m64n256k16<kTransA, kTransB>(d, a, b);
  }
}

// The consumer warpgroups of a block: threads [0, kConsumers).
constexpr int kConsumers = 256;

// A ring of kStages shared-memory stages over n chunks, for the consumer
// warpgroups' products into acc: issue(c, s) starts the asynchronous
// copies of chunk c into stage s; land(c, s) waits until they are in
// place for this thread, and after a barrier, convert(c, s) rewrites what
// the products read (plain shared stores) and mma(c, s) issues the
// chunk's products into acc, committed as one batch.  The next chunk's
// copies are issued once both warpgroups' previous batches have finished
// reading its stage, so one batch runs while the next chunk lands and is
// converted.  Three barriers a chunk.  Ends with no product in flight and
// every stage free.
template <int kStages, int N, class Issue, class Land, class Convert,
          class Mma>
__device__ __forceinline__ void wgmma_pipeline(int n, float (&acc)[N],
                                               Issue&& issue, Land&& land,
                                               Convert&& convert, Mma&& mma) {
  static_assert(kStages >= 2, "a ring of at least two stages");
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s)
    if (s < n) issue(s, s);
  for (int c = 0; c < n; ++c) {
    const int s = c % kStages;
    land(c, s);
    named_sync(kConsumers);
    convert(c, s);
    fence_proxy_async();
    named_sync(kConsumers);
    fence_operands(acc);
    wgmma_fence();
    mma(c, s);
    wgmma_commit();
    wgmma_wait<1>();  // this warpgroup's chunk c - 1 products are done
    fence_operands(acc);
    const int next = c + kStages - 1;
    if (next < n) {
      named_sync(kConsumers);  // and the other's: their stage is free
      issue(next, next % kStages);
    }
  }
  wgmma_wait<0>();
  fence_operands(acc);
  named_sync(kConsumers);
}

// The consumers' release of chunk c's stage to the producer (one arrival
// a warpgroup, by its thread 0).
template <int kStages>
__device__ __forceinline__ void release_stage(uint64_t* empty, int c) {
  mbar_arrive(&empty[c % kStages]);
}

// The same ring with a producer warp (threads kConsumers.. of the block,
// beside the consumer warpgroups), which runs up to kStages chunks ahead:
// produce(c, s, full), called by all its threads, fills stage s with
// chunk c by asynchronous copies that complete on full, once both consumer
// warpgroups have released the stage (empty, two arrivals a use).  The
// consumers wait for full, convert (each thread only what it reads; with
// kConvert false there is nothing to convert, and each warpgroup runs on
// without waiting for the other), and release the stage of chunk c - 1
// once their products of it are done.  The producer warp returns from
// here; the consumers end with no product in flight.  The chunks are
// numbered first.. first + n - 1, so a ring can be run over in parts, one
// call a part; the consumers release the stage of a part's last chunk
// themselves (release_stage) before the next part.
template <int kStages, bool kConvert = true, int N, class Produce,
          class Convert, class Mma>
__device__ __forceinline__ void wgmma_pipeline_ws(
    int n, float (&acc)[N], uint64_t* full, uint64_t* empty, int tid,
    Produce&& produce, Convert&& convert, Mma&& mma, int first = 0) {
  if (tid >= kConsumers) {
    for (int c = first; c < first + n; ++c) {
      const int s = c % kStages;
      if (c >= kStages) mbar_wait(&empty[s], (c / kStages - 1) & 1);
      produce(c, s, &full[s]);
    }
    return;
  }
  for (int c = first; c < first + n; ++c) {
    const int s = c % kStages;
    mbar_wait(&full[s], (c / kStages) & 1);
    if constexpr (kConvert) {
      convert(c, s);
      fence_proxy_async();
      named_sync(kConsumers);
    }
    fence_operands(acc);
    wgmma_fence();
    mma(c, s);
    wgmma_commit();
    wgmma_wait<1>();
    fence_operands(acc);
    if (c > first && tid % 128 == 0) release_stage<kStages>(empty, c - 1);
  }
  wgmma_wait<0>();
  fence_operands(acc);
  named_sync(kConsumers);
}

// land() of a ring filled by cp.async, one commit group a chunk: chunk c
// is complete once at most min(kStages - 2, n - 1 - c) later groups are
// pending.
template <int kStages>
__device__ __forceinline__ void cp_async_land(int c, int n) {
  static_assert(kStages == 3, "one later group in flight");
  if (c + 1 < n)
    cp_async_wait<1>();
  else
    cp_async_wait<0>();
}

}  // namespace ta3n
