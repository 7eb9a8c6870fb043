// Native PQ training / encoding library — the offline-stage replacement for
// the reference's faiss dependency (pq_utils.py:586-609 trains via
// faiss.IndexPQ on CPU). The online path is JAX/Pallas; this library serves
// the host-side pipeline: multithreaded k-means++ codebook training and
// batch encoding over .fvecs sample files, so the training stage scales
// with host cores instead of occupying the accelerator.
//
// Semantics match million_tpu.pq.kmeans: k-means++ (D^2-sampling) init,
// Lloyd iterations, empty clusters re-seeded at the worst-served points.
// Exposed as a C ABI for ctypes (no pybind11 dependency).

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <numeric>
#include <random>
#include <thread>
#include <vector>

namespace {

struct SplitMix {
  uint64_t s;
  explicit SplitMix(uint64_t seed) : s(seed) {}
  uint64_t next() {
    uint64_t z = (s += 0x9e3779b97f4a7c15ULL);
    z = (z ^ (z >> 30)) * 0xbf58476d1ce4e5b9ULL;
    z = (z ^ (z >> 27)) * 0x94d049bb133111ebULL;
    return z ^ (z >> 31);
  }
  double uniform() { return (next() >> 11) * (1.0 / 9007199254740992.0); }
};

int hardware_threads() {
  unsigned t = std::thread::hardware_concurrency();
  return t == 0 ? 1 : static_cast<int>(t);
}

// parallel for over [0, n)
template <typename F>
void pfor(int64_t n, F&& f) {
  int nt = std::min<int64_t>(hardware_threads(), n);
  if (nt <= 1) {
    for (int64_t i = 0; i < n; ++i) f(i);
    return;
  }
  std::vector<std::thread> ts;
  std::atomic<int64_t> next(0);
  for (int t = 0; t < nt; ++t) {
    ts.emplace_back([&] {
      int64_t i;
      constexpr int64_t CHUNK = 256;
      while ((i = next.fetch_add(CHUNK)) < n) {
        int64_t end = std::min(i + CHUNK, n);
        for (int64_t j = i; j < end; ++j) f(j);
      }
    });
  }
  for (auto& t : ts) t.join();
}

float dist2(const float* a, const float* b, int k) {
  float d = 0.f;
  for (int i = 0; i < k; ++i) {
    float t = a[i] - b[i];
    d += t * t;
  }
  return d;
}

// k-means for one subspace: x (n, k) -> cents (C, k)
void kmeans_one(const float* x, int64_t n, int k, int C, int iters,
                uint64_t seed, float* cents) {
  SplitMix rng(seed);
  std::vector<float> min_d2(n);
  // k-means++ init
  int64_t first = static_cast<int64_t>(rng.uniform() * n);
  std::memcpy(cents, x + first * k, sizeof(float) * k);
  pfor(n, [&](int64_t i) { min_d2[i] = dist2(x + i * k, cents, k); });
  for (int c = 1; c < C; ++c) {
    double total = 0;
    for (int64_t i = 0; i < n; ++i) total += min_d2[i];
    double target = rng.uniform() * total, acc = 0;
    int64_t pick = n - 1;
    for (int64_t i = 0; i < n; ++i) {
      acc += min_d2[i];
      if (acc >= target) { pick = i; break; }
    }
    float* cc = cents + c * k;
    std::memcpy(cc, x + pick * k, sizeof(float) * k);
    pfor(n, [&](int64_t i) {
      float d = dist2(x + i * k, cc, k);
      if (d < min_d2[i]) min_d2[i] = d;
    });
  }

  std::vector<int32_t> assign(n);
  std::vector<double> sums(static_cast<size_t>(C) * k);
  std::vector<int64_t> counts(C);
  for (int it = 0; it < iters; ++it) {
    pfor(n, [&](int64_t i) {
      const float* xi = x + i * k;
      float best = dist2(xi, cents, k);
      int bj = 0;
      for (int j = 1; j < C; ++j) {
        float d = dist2(xi, cents + j * k, k);
        if (d < best) { best = d; bj = j; }
      }
      assign[i] = bj;
      min_d2[i] = best;
    });
    std::fill(sums.begin(), sums.end(), 0.0);
    std::fill(counts.begin(), counts.end(), 0);
    for (int64_t i = 0; i < n; ++i) {
      int a = assign[i];
      counts[a]++;
      const float* xi = x + i * k;
      double* s = sums.data() + static_cast<size_t>(a) * k;
      for (int j = 0; j < k; ++j) s[j] += xi[j];
    }
    // order of worst-served points for empty-cluster reseeding
    std::vector<int64_t> order;
    for (int c = 0; c < C; ++c) {
      if (counts[c] > 0) {
        double* s = sums.data() + static_cast<size_t>(c) * k;
        float* cc = cents + static_cast<size_t>(c) * k;
        for (int j = 0; j < k; ++j) cc[j] = static_cast<float>(s[j] / counts[c]);
      } else {
        if (order.empty()) {
          order.resize(n);
          std::iota(order.begin(), order.end(), 0);
          std::partial_sort(
              order.begin(), order.begin() + std::min<int64_t>(C, n), order.end(),
              [&](int64_t a, int64_t b) { return min_d2[a] > min_d2[b]; });
        }
        static thread_local int64_t donor_rank = 0;
        int64_t idx = order[donor_rank++ % std::min<int64_t>(C, n)];
        std::memcpy(cents + static_cast<size_t>(c) * k, x + idx * k,
                    sizeof(float) * k);
      }
    }
  }
}

}  // namespace

extern "C" {

// samples (n, d) f32 row-major; layout 0=contiguous 1=strided;
// out_cents (M, C, d_m) f32. Returns 0 on success.
int pq_train(const float* samples, int64_t n, int d, int M, int C, int iters,
             uint64_t seed, int layout, float* out_cents) {
  if (d % M != 0 || n < C) return -1;
  int d_m = d / M;
  // gather per-subspace views
  std::vector<std::vector<float>> sub(M);
  for (int m = 0; m < M; ++m) sub[m].resize(static_cast<size_t>(n) * d_m);
  pfor(n, [&](int64_t i) {
    const float* row = samples + i * d;
    for (int m = 0; m < M; ++m) {
      float* dst = sub[m].data() + i * d_m;
      for (int j = 0; j < d_m; ++j) {
        int src = (layout == 0) ? m * d_m + j : j * M + m;
        dst[j] = row[src];
      }
    }
  });
  // subspaces train in parallel at the outer level when M >= cores
  std::atomic<int> next(0);
  int nt = std::min(hardware_threads(), M);
  std::vector<std::thread> ts;
  for (int t = 0; t < nt; ++t) {
    ts.emplace_back([&] {
      int m;
      while ((m = next.fetch_add(1)) < M) {
        kmeans_one(sub[m].data(), n, d_m, C, iters, seed + m,
                   out_cents + static_cast<size_t>(m) * C * d_m);
      }
    });
  }
  for (auto& t : ts) t.join();
  return 0;
}

// x (n, d) f32 -> codes (n, M) u8; cents (M, C, d_m).
int pq_encode(const float* x, int64_t n, int d, const float* cents, int M,
              int C, int layout, uint8_t* out_codes) {
  if (d % M != 0 || C > 256) return -1;
  int d_m = d / M;
  pfor(n, [&](int64_t i) {
    const float* row = x + i * d;
    for (int m = 0; m < M; ++m) {
      float sub[16];
      for (int j = 0; j < d_m && j < 16; ++j) {
        int src = (layout == 0) ? m * d_m + j : j * M + m;
        sub[j] = row[src];
      }
      const float* cm = cents + static_cast<size_t>(m) * C * d_m;
      float best = dist2(sub, cm, d_m);
      int bj = 0;
      for (int c = 1; c < C; ++c) {
        float dd = dist2(sub, cm + static_cast<size_t>(c) * d_m, d_m);
        if (dd < best) { best = dd; bj = c; }
      }
      out_codes[i * M + m] = static_cast<uint8_t>(bj);
    }
  });
  return 0;
}

}  // extern "C"
