// Native batch gather for the packed feature store.
//
// The training hot loop's host-side work is one batched gather:
//   out[b, t, :] = features[offsets[video_idx[b]] + frame_idx[b, t], :]
// numpy fancy indexing does this single-threaded with index checking per
// element group; this library does bounds-checked row memcpy, fanned out
// over num_threads threads when the caller asks for more than one.
//
// Built at first use by ta3n_tpu_torch/data/native_gather.py with the host
// C++ compiler ($CXX, default g++) into build/ta3n_tpu_torch/.

#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

extern "C" {

// Generic row gather (any dtype; row_bytes = D * itemsize).
// Returns 0 on success, -1 on an out-of-range index.
int gather_rows(const char* features, const int64_t* offsets,
                const int64_t* video_idx, const int64_t* frame_idx,
                char* out, int64_t num_videos, int64_t total_rows,
                int64_t batch, int64_t frames_per_video, int64_t row_bytes,
                int num_threads) {
  if (num_threads < 1) num_threads = 1;
  std::vector<std::thread> workers;
  std::vector<int> status(num_threads, 0);

  auto work = [&](int tid) {
    int64_t lo = batch * tid / num_threads;
    int64_t hi = batch * (tid + 1) / num_threads;
    for (int64_t b = lo; b < hi; ++b) {
      int64_t v = video_idx[b];
      if (v < 0 || v >= num_videos) { status[tid] = -1; return; }
      int64_t base = offsets[v];
      int64_t vend = offsets[v + 1];
      char* dst = out + b * frames_per_video * row_bytes;
      const int64_t* fidx = frame_idx + b * frames_per_video;
      for (int64_t t = 0; t < frames_per_video; ++t) {
        int64_t row = base + fidx[t];
        if (fidx[t] < 0 || row >= vend || row >= total_rows) {
          status[tid] = -1;
          return;
        }
        std::memcpy(dst + t * row_bytes, features + row * row_bytes,
                    row_bytes);
      }
    }
  };

  if (num_threads == 1) {
    work(0);
  } else {
    workers.reserve(num_threads);
    for (int t = 0; t < num_threads; ++t) workers.emplace_back(work, t);
    for (auto& w : workers) w.join();
  }
  for (int s : status)
    if (s != 0) return -1;
  return 0;
}

}  // extern "C"
