// Native data-layer kernels for dldkd_tpu.
//
// The reference assembles every training item in Python inside DataLoader
// worker processes: per-frame BigFile seeks, numpy mean-pool resampling and
// L2 normalization (reference method/data_provider.py:212-263,
// utils/basic_utils.py:38-58). Here the whole corpus is packed by one C++
// call: a thread pool walks videos, preads their frame rows from
// feature.bin, applies the reference's uniform mean-pool resampling
// (data_provider.py:52-68) — optionally twice, to align the student frame
// grid with the teacher's before capping at max_ctx_l
// (data_provider.py:231-237) — L2-normalizes rows (eps ADDED to the norm,
// data_provider.py:71-73) and writes the padded (N, L, D) block + mask.
//
// Exposed as a C ABI consumed via ctypes (no pybind11 in this toolchain).

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <unistd.h>

namespace {

// Reference uniform_feature_sampling (data_provider.py:52-68): partition
// n_in frames into n_out contiguous bins via rounded fractional indices;
// each output frame is the mean of its bin (or frame[s] for empty bins).
// Double accumulation matches the float64 cumsum the Python packer uses.
void resample_into(const float* in, int64_t n_in, int64_t dim, int64_t n_out,
                   float* out) {
  if (n_in <= n_out) {
    std::memcpy(out, in, sizeof(float) * n_in * dim);
    return;
  }
  for (int64_t i = 0; i < n_out; ++i) {
    // np.round semantics: round-half-to-EVEN (the Python packer's bin
    // edges come from np.round; llround's half-away-from-zero differs on
    // exact .5 fractions and would shift bin boundaries)
    auto edge = [&](int64_t k) {
      double x = (double)k / (double)n_out * n_in;
      double fl = std::floor(x);
      double frac = x - fl;
      int64_t v;
      if (frac > 0.5) {
        v = (int64_t)fl + 1;
      } else if (frac < 0.5) {
        v = (int64_t)fl;
      } else {
        v = (int64_t)fl;
        if (v % 2 != 0) v += 1;
      }
      return std::min(v, n_in - 1);
    };
    int64_t s = edge(i), e = edge(i + 1);
    float* dst = out + i * dim;
    if (e <= s) {
      std::memcpy(dst, in + s * dim, sizeof(float) * dim);
      continue;
    }
    double inv = 1.0 / (double)(e - s);
    for (int64_t d = 0; d < dim; ++d) {
      double acc = 0.0;
      for (int64_t r = s; r < e; ++r) acc += (double)in[r * dim + d];
      dst[d] = (float)(acc * inv);
    }
  }
}

void l2_normalize_rows(float* x, int64_t n, int64_t dim, float eps) {
  for (int64_t i = 0; i < n; ++i) {
    float* row = x + i * dim;
    double ss = 0.0;
    for (int64_t d = 0; d < dim; ++d) ss += (double)row[d] * (double)row[d];
    float inv = 1.0f / ((float)std::sqrt(ss) + eps);
    for (int64_t d = 0; d < dim; ++d) row[d] *= inv;
  }
}

}  // namespace

extern "C" {

// Gather rows by index from a row-major float32 matrix file (BigFile
// feature.bin). Returns 0 on success, -1 on IO error.
int bigfile_gather(const char* bin_path, int64_t dim, const int64_t* indices,
                   int64_t n_idx, float* out) {
  int fd = open(bin_path, O_RDONLY);
  if (fd < 0) return -1;
  const size_t row_bytes = sizeof(float) * (size_t)dim;
  int rc = 0;
  for (int64_t i = 0; i < n_idx; ++i) {
    ssize_t got = pread(fd, out + i * dim, row_bytes,
                        (off_t)indices[i] * (off_t)row_bytes);
    if (got != (ssize_t)row_bytes) {
      rc = -1;
      break;
    }
  }
  close(fd);
  return rc;
}

// Pack a whole corpus of videos in parallel.
//   bin_path      feature.bin of the student BigFile (float32 rows)
//   dim           feature dimension
//   row_indices   concatenated frame row indices for all videos
//   vid_offsets   (n_videos+1) offsets into row_indices
//   align_len     per-video target length for the first resample (teacher
//                 frame count; <=0 to skip — the eval-corpus path)
//   max_ctx_l     final frame cap (second resample)
//   l2norm        nonzero -> L2-normalize output rows (eps added to norm)
//   out_feats     (n_videos, max_ctx_l, dim) float32, zero-initialized
//   out_mask      (n_videos, max_ctx_l) float32, zero-initialized
//   n_threads     worker count (<=0 -> hardware concurrency)
// Returns 0 on success, -1 on IO error.
int pack_corpus(const char* bin_path, int64_t dim, const int64_t* row_indices,
                const int64_t* vid_offsets, int64_t n_videos,
                const int64_t* align_len, int64_t max_ctx_l, int l2norm,
                float eps, float* out_feats, float* out_mask,
                int n_threads) {
  if (n_threads <= 0) {
    n_threads = (int)std::thread::hardware_concurrency();
    if (n_threads <= 0) n_threads = 1;
  }
  n_threads = std::min<int64_t>(n_threads, std::max<int64_t>(n_videos, 1));

  std::atomic<int64_t> next(0);
  std::atomic<int> rc(0);

  auto worker = [&]() {
    int fd = open(bin_path, O_RDONLY);
    if (fd < 0) {
      rc.store(-1);
      return;
    }
    const size_t row_bytes = sizeof(float) * (size_t)dim;
    std::vector<float> raw, stage;
    for (;;) {
      int64_t v = next.fetch_add(1);
      if (v >= n_videos || rc.load() != 0) break;
      int64_t s = vid_offsets[v], e = vid_offsets[v + 1];
      int64_t n_in = e - s;
      if (n_in <= 0) continue;
      raw.resize((size_t)n_in * dim);
      for (int64_t i = 0; i < n_in; ++i) {
        ssize_t got = pread(fd, raw.data() + i * dim, row_bytes,
                            (off_t)row_indices[s + i] * (off_t)row_bytes);
        if (got != (ssize_t)row_bytes) {
          rc.store(-1);
          break;
        }
      }
      if (rc.load() != 0) break;

      const float* cur = raw.data();
      int64_t n = n_in;
      int64_t al = align_len ? align_len[v] : 0;
      if (al > 0 && n > al) {
        stage.resize((size_t)al * dim);
        resample_into(cur, n, dim, al, stage.data());
        std::swap(raw, stage);
        cur = raw.data();
        n = al;
      }
      float* dst = out_feats + v * max_ctx_l * dim;
      if (n > max_ctx_l) {
        resample_into(cur, n, dim, max_ctx_l, dst);
        n = max_ctx_l;
      } else {
        std::memcpy(dst, cur, sizeof(float) * (size_t)n * dim);
      }
      if (l2norm) l2_normalize_rows(dst, n, dim, eps);
      float* m = out_mask + v * max_ctx_l;
      for (int64_t i = 0; i < n; ++i) m[i] = 1.0f;
    }
    close(fd);
  };

  std::vector<std::thread> pool;
  for (int t = 0; t < n_threads; ++t) pool.emplace_back(worker);
  for (auto& th : pool) th.join();
  return rc.load();
}

// Standalone resample (for tests / the HDF5 teacher path, where rows come
// from memory, not a BigFile).
void resample_mean_pool(const float* in, int64_t n_in, int64_t dim,
                        int64_t n_out, float* out) {
  resample_into(in, n_in, dim, n_out, out);
}

void l2norm_rows(float* x, int64_t n, int64_t dim, float eps) {
  l2_normalize_rows(x, n, dim, eps);
}

}  // extern "C"
