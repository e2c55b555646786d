// The multi-scale TRN's relation plan as the TRN kernels read it
// (trn_fused_fwd.cu, trn_fused_bwd.cu): one int32 table, built on the host
// by ops/trn_fused.py::_plan_table and uploaded to the device once per
// (num_frames, subsample_num, device).  Its size follows the plan, so any
// number of frames S is taken; only the subsets of a scale are at most 3
// (the reference's subsample_num).
//
//   header   n_scales (S-1), n_units (sum of k), n_sub_total, n_slots
//            (sum of k*n_sub)
//   scales   per scale i (k = S - i):  {k, n_sub, sub0, slot0}
//   units    per (scale i, frame position p), scales in order, p
//            ascending, three int4:
//              {i, p, n_sub, slot = slot0 + p*n_sub}
//              {c1, c2, c3, sub0}: the units before it with 1, 2, 3 subsets
//              {f0, f1, f2, k}: the frame of each subset at position p (-1
//              past n_sub)
//   trip0    per frame f, its first triple, then the count (S + 1 ints)
//   trips    per frame, (unit << 2 | j) of every subset j and position
//            that read the frame, in the order scale, subset, position
//
// sub0 is the scale's first subset over all scales (the masks' column
// blocks), slot0 its first (position, subset) slot of K1's scratch.  The
// device reads the table through `Plan`; the host entry points check the
// host copy with check_plan before a launch and size the grids from it.

#pragma once

#include <cuda_runtime.h>

#include <vector>

namespace ta3n {

constexpr int kMaxSubsets = 3;
constexpr int kPlanHeader = 4;
constexpr int kScaleInts = 4;
constexpr int kUnitInts = 12;

// The device copy of the table, by its sections.
struct Plan {
  const int4* scales;  // n_scales x {k, n_sub, sub0, slot0}
  const int4* units;   // n_units x 3 int4
  const int* trip0;    // S + 1
  const int* trips;
  int n_scales, n_units, n_sub_total, n_slots;
};

// What the host learns from a table that check_plan accepts.
struct PlanInfo {
  bool ok = false;
  Plan plan{};
  int units_with[kMaxSubsets + 1] = {};  // units of 1, 2, 3 subsets
  int max_trip = 0;                      // most triples of one frame
  int max_k = 0;
};

// Check the host table `t` of `len` ints for num_frames frames against the
// layout above, every derived field recomputed from the scales' k and
// n_sub and the units' frames; and point `plan` at the device copy `dev`
// (the same ints).  info.ok is false for a malformed table.
inline PlanInfo check_plan(const int* t, int len, const int* dev,
                           int num_frames) {
  PlanInfo info;
  if (t == nullptr || dev == nullptr || num_frames < 2 || len < kPlanHeader)
    return info;
  const int ns = t[0], nu = t[1];
  if (ns != num_frames - 1 || nu < 1 || nu > (1 << 28)) return info;
  const long long fixed = kPlanHeader + static_cast<long long>(kScaleInts) * ns +
                          static_cast<long long>(kUnitInts) * nu +
                          num_frames + 1;
  if (len < fixed) return info;
  const int* sc = t + kPlanHeader;
  const int* un = sc + kScaleInts * ns;
  const int* t0 = un + kUnitInts * nu;
  const int* tr = t0 + num_frames + 1;
  if (t0[0] != 0 || t0[num_frames] < 0 || len - fixed < t0[num_frames])
    return info;
  int sub0 = 0, slot0 = 0, z = 0;
  int count[kMaxSubsets + 1] = {};
  for (int i = 0; i < ns; ++i) {
    const int k = sc[kScaleInts * i], n = sc[kScaleInts * i + 1];
    if (k < 1 || k > num_frames || n < 1 || n > kMaxSubsets ||
        sc[kScaleInts * i + 2] != sub0 || sc[kScaleInts * i + 3] != slot0)
      return info;
    for (int p = 0; p < k; ++p, ++z) {
      if (z >= nu) return info;
      const int* u = un + kUnitInts * z;
      if (u[0] != i || u[1] != p || u[2] != n || u[3] != slot0 + p * n ||
          u[4] != count[1] || u[5] != count[2] || u[6] != count[3] ||
          u[7] != sub0 || u[11] != k)
        return info;
      for (int j = 0; j < kMaxSubsets; ++j) {
        const int f = u[8 + j];
        if (j < n ? f < 0 || f >= num_frames : f != -1) return info;
      }
      ++count[n];
    }
    sub0 += n;
    slot0 += k * n;
    if (k > info.max_k) info.max_k = k;
  }
  if (z != nu || t[2] != sub0 || t[3] != slot0) return info;
  // each frame's triples, in the order scale, subset, position
  std::vector<int> at(t0, t0 + num_frames);
  for (int f = 0; f < num_frames; ++f) {
    if (t0[f + 1] < t0[f]) return info;
    if (t0[f + 1] - t0[f] > info.max_trip) info.max_trip = t0[f + 1] - t0[f];
  }
  for (int i = 0, z0 = 0; i < ns; z0 += sc[kScaleInts * i], ++i) {
    const int k = sc[kScaleInts * i], n = sc[kScaleInts * i + 1];
    for (int j = 0; j < n; ++j)
      for (int p = 0; p < k; ++p) {
        const int unit = z0 + p;
        const int f = un[kUnitInts * unit + 8 + j];
        if (at[f] >= t0[f + 1] || tr[at[f]++] != (unit << 2 | j)) return info;
      }
  }
  for (int f = 0; f < num_frames; ++f)
    if (at[f] != t0[f + 1]) return info;
  const int* d_sc = dev + kPlanHeader;
  const int* d_un = d_sc + kScaleInts * ns;
  const int* d_t0 = d_un + kUnitInts * nu;
  info.plan = {reinterpret_cast<const int4*>(d_sc),
               reinterpret_cast<const int4*>(d_un), d_t0,
               d_t0 + num_frames + 1, ns, nu, sub0, slot0};
  for (int n = 1; n <= kMaxSubsets; ++n) info.units_with[n] = count[n];
  info.ok = reinterpret_cast<unsigned long long>(dev) % 16 == 0;
  return info;
}

// A device pointer from an array of them in device memory.
template <class T>
__device__ __forceinline__ T* ptr_at(const long long* ptrs, int i) {
  return reinterpret_cast<T*>(__ldg(ptrs + i));
}

}  // namespace ta3n
