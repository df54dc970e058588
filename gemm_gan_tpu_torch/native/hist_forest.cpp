// Histogram-based random-forest classifier (native C++ core).
//
// The port's copy of `gemm_gan_tpu/native/hist_forest.cpp`, unchanged below
// this comment: the "RF" of the detection and utility suites, in place of
// LightGBM's tree learner in rf-boosting mode
// (`LGBMClassifier(boosting_type='rf')` in the original GeMM-GAN code).
// Histogram-binned split finding (quantile bins, uint8 bin codes), per-node
// feature subsampling, bootstrap bagging, Gini gain, and thread-parallel
// tree construction. Exposed through a plain C API and loaded with ctypes
// (gemm_gan_tpu_torch/native/forest.py).
//
// Single translation unit, no dependencies beyond the C++17 standard library.

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

// ----------------------------------------------------------------- RNG
// splitmix64: tiny, seedable, state-per-thread. Quality is ample for
// bagging / feature subsampling.
struct Rng {
  uint64_t s;
  explicit Rng(uint64_t seed) : s(seed) {}
  uint64_t next() {
    uint64_t z = (s += 0x9e3779b97f4a7c15ULL);
    z = (z ^ (z >> 30)) * 0xbf58476d1ce4e5b9ULL;
    z = (z ^ (z >> 27)) * 0x94d049bb133111ebULL;
    return z ^ (z >> 31);
  }
  // unbiased-enough bounded draw for n far below 2^64
  uint64_t bounded(uint64_t n) { return next() % n; }
};

// ----------------------------------------------------------------- model
struct Node {
  int32_t feat = -1;    // -1 => leaf
  int32_t thr = 0;      // go left if bin <= thr
  int32_t left = -1;
  int32_t right = -1;
  int32_t leaf = -1;    // index into leaf_probs / n_classes
};

struct Tree {
  std::vector<Node> nodes;
  std::vector<float> leaf_probs;  // n_leaves * n_classes
};

struct Model {
  int64_t d = 0;
  int32_t n_classes = 0;
  int32_t n_bins = 0;
  std::vector<float> cuts;  // d * (n_bins - 1) upper edges, row-major per feature
  std::vector<Tree> trees;
};

// --------------------------------------------------------------- binning
// Quantile cut points per feature; parallel over features.
void compute_cuts(const float* X, int64_t n, int64_t d, int n_bins,
                  std::vector<float>& cuts, int n_threads) {
  const int n_cuts = n_bins - 1;
  cuts.assign(static_cast<size_t>(d) * n_cuts, 0.f);
  std::atomic<int64_t> next_feat{0};
  auto worker = [&]() {
    std::vector<float> col(n);
    for (;;) {
      int64_t f = next_feat.fetch_add(1);
      if (f >= d) return;
      for (int64_t i = 0; i < n; ++i) col[i] = X[i * d + f];
      std::sort(col.begin(), col.end());
      float* out = cuts.data() + f * n_cuts;
      for (int c = 0; c < n_cuts; ++c) {
        // upper edge of bin c at quantile (c+1)/n_bins
        int64_t idx = static_cast<int64_t>(
            (static_cast<double>(c + 1) / n_bins) * (n - 1));
        out[c] = col[idx];
      }
    }
  };
  std::vector<std::thread> threads;
  for (int t = 0; t < n_threads; ++t) threads.emplace_back(worker);
  for (auto& t : threads) t.join();
}

inline uint8_t bin_of(const float* cut, int n_cuts, float v) {
  // first cut with v <= cut  (cuts ascending); bin = index
  int lo = 0, hi = n_cuts;  // answer in [0, n_cuts]
  while (lo < hi) {
    int mid = (lo + hi) / 2;
    if (v <= cut[mid]) hi = mid; else lo = mid + 1;
  }
  return static_cast<uint8_t>(lo);
}

void bin_matrix(const float* X, int64_t n, int64_t d,
                const std::vector<float>& cuts, int n_bins,
                std::vector<uint8_t>& B, int n_threads) {
  const int n_cuts = n_bins - 1;
  B.resize(static_cast<size_t>(n) * d);
  std::atomic<int64_t> next_row{0};
  auto worker = [&]() {
    for (;;) {
      int64_t i = next_row.fetch_add(64);
      if (i >= n) return;
      int64_t end = std::min<int64_t>(i + 64, n);
      for (int64_t r = i; r < end; ++r)
        for (int64_t f = 0; f < d; ++f)
          B[r * d + f] = bin_of(cuts.data() + f * n_cuts, n_cuts, X[r * d + f]);
    }
  };
  std::vector<std::thread> threads;
  for (int t = 0; t < n_threads; ++t) threads.emplace_back(worker);
  for (auto& t : threads) t.join();
}

// ------------------------------------------------------------ tree build
struct BuildCtx {
  const uint8_t* B;          // n x d bin codes
  const int32_t* y;
  int64_t d;
  int n_classes, n_bins, max_depth, min_leaf, max_feats;
};

double gini_from_counts(const std::vector<double>& cnt, double total) {
  if (total <= 0) return 0.0;
  double s = 0.0;
  for (double c : cnt) s += c * c;
  return 1.0 - s / (total * total);
}

// Build one tree over rows[lo:hi) (indices into B/y); recursion by explicit
// work stack. `feat_pool` is a reusable identity permutation for partial
// Fisher-Yates feature draws.
void build_tree(const BuildCtx& c, std::vector<int32_t>& rows, Rng& rng,
                std::vector<int32_t>& feat_pool, Tree& tree) {
  struct Item { int32_t node, lo, hi, depth; };
  tree.nodes.clear();
  tree.leaf_probs.clear();
  tree.nodes.emplace_back();
  std::vector<Item> stack{{0, 0, static_cast<int32_t>(rows.size()), 0}};
  std::vector<double> parent_cnt(c.n_classes);
  std::vector<double> hist;           // n_bins * n_classes for one feature
  std::vector<double> left_cnt(c.n_classes);

  while (!stack.empty()) {
    Item it = stack.back();
    stack.pop_back();
    const int32_t n_node = it.hi - it.lo;

    std::fill(parent_cnt.begin(), parent_cnt.end(), 0.0);
    for (int32_t i = it.lo; i < it.hi; ++i) parent_cnt[c.y[rows[i]]] += 1.0;
    const double parent_gini = gini_from_counts(parent_cnt, n_node);

    auto make_leaf = [&](int32_t node) {
      int32_t leaf_id = static_cast<int32_t>(tree.leaf_probs.size())
                        / c.n_classes;
      for (int k = 0; k < c.n_classes; ++k)
        tree.leaf_probs.push_back(static_cast<float>(parent_cnt[k] / n_node));
      tree.nodes[node].feat = -1;
      tree.nodes[node].leaf = leaf_id;
    };

    if (it.depth >= c.max_depth || n_node < 2 * c.min_leaf ||
        parent_gini <= 0.0) {
      make_leaf(it.node);
      continue;
    }

    // per-node feature subsample: partial Fisher-Yates over feat_pool
    int best_feat = -1, best_thr = -1;
    double best_gain = 1e-12;
    for (int fi = 0; fi < c.max_feats; ++fi) {
      int64_t j = fi + static_cast<int64_t>(rng.bounded(c.d - fi));
      std::swap(feat_pool[fi], feat_pool[j]);
      const int32_t f = feat_pool[fi];

      hist.assign(static_cast<size_t>(c.n_bins) * c.n_classes, 0.0);
      for (int32_t i = it.lo; i < it.hi; ++i) {
        const int32_t r = rows[i];
        hist[static_cast<size_t>(c.B[static_cast<int64_t>(r) * c.d + f])
             * c.n_classes + c.y[r]] += 1.0;
      }
      // scan split points left->right
      std::fill(left_cnt.begin(), left_cnt.end(), 0.0);
      double n_left = 0.0;
      for (int b = 0; b < c.n_bins - 1; ++b) {
        for (int k = 0; k < c.n_classes; ++k) {
          left_cnt[k] += hist[static_cast<size_t>(b) * c.n_classes + k];
        }
        n_left = 0.0;
        for (int k = 0; k < c.n_classes; ++k) n_left += left_cnt[k];
        const double n_right = n_node - n_left;
        if (n_left < c.min_leaf || n_right < c.min_leaf) continue;
        double sl = 0.0, sr = 0.0;
        for (int k = 0; k < c.n_classes; ++k) {
          const double l = left_cnt[k], r = parent_cnt[k] - l;
          sl += l * l;
          sr += r * r;
        }
        const double gini_l = 1.0 - sl / (n_left * n_left);
        const double gini_r = 1.0 - sr / (n_right * n_right);
        const double gain =
            parent_gini - (n_left * gini_l + n_right * gini_r) / n_node;
        if (gain > best_gain) {
          best_gain = gain;
          best_feat = f;
          best_thr = b;
        }
      }
    }

    if (best_feat < 0) {
      make_leaf(it.node);
      continue;
    }

    // partition rows[lo:hi) by bin <= thr (stable not required)
    int32_t mid = it.lo;
    for (int32_t i = it.lo; i < it.hi; ++i) {
      if (c.B[static_cast<int64_t>(rows[i]) * c.d + best_feat] <= best_thr) {
        std::swap(rows[i], rows[mid]);
        ++mid;
      }
    }

    const int32_t li = static_cast<int32_t>(tree.nodes.size());
    tree.nodes.emplace_back();
    const int32_t ri = static_cast<int32_t>(tree.nodes.size());
    tree.nodes.emplace_back();
    tree.nodes[it.node].feat = best_feat;
    tree.nodes[it.node].thr = best_thr;
    tree.nodes[it.node].left = li;
    tree.nodes[it.node].right = ri;
    stack.push_back({ri, mid, it.hi, it.depth + 1});
    stack.push_back({li, it.lo, mid, it.depth + 1});
  }
}

}  // namespace

extern "C" {

// Train a forest. X row-major [n, d] float32, y int32 in [0, n_classes).
// feature_fraction: per-node share of features scanned (<=0 => sqrt(d)).
// bagging_fraction: rows per tree (bootstrap draws round(frac*n) samples
// WITH replacement). Returns an opaque model pointer (hf_free to release).
void* hf_train(const float* X, const int32_t* y, int64_t n, int64_t d,
               int32_t n_classes, int32_t n_trees, int32_t max_depth,
               int32_t n_bins, double feature_fraction,
               double bagging_fraction, int32_t min_leaf, uint64_t seed,
               int32_t n_threads) {
  if (n <= 0 || d <= 0 || n_classes < 2 || n_trees <= 0) return nullptr;
  if (n_bins < 2) n_bins = 2;
  if (n_bins > 256) n_bins = 256;
  if (min_leaf < 1) min_leaf = 1;
  if (n_threads <= 0)
    n_threads = std::max(1u, std::thread::hardware_concurrency());

  auto* m = new Model();
  m->d = d;
  m->n_classes = n_classes;
  m->n_bins = n_bins;
  compute_cuts(X, n, d, n_bins, m->cuts, n_threads);
  std::vector<uint8_t> B;
  bin_matrix(X, n, d, m->cuts, n_bins, B, n_threads);

  int max_feats = feature_fraction > 0
      ? static_cast<int>(feature_fraction * d + 0.5)
      : static_cast<int>(std::max(1.0, std::sqrt(static_cast<double>(d))));
  max_feats = std::max(1, std::min<int>(max_feats, static_cast<int>(d)));
  const int64_t n_bag = std::max<int64_t>(
      1, static_cast<int64_t>(bagging_fraction * n + 0.5));

  BuildCtx ctx{B.data(), y, d, n_classes, n_bins, max_depth, min_leaf,
               max_feats};
  m->trees.resize(n_trees);

  std::atomic<int32_t> next_tree{0};
  auto worker = [&]() {
    std::vector<int32_t> rows(n_bag);
    std::vector<int32_t> feat_pool(d);
    for (int64_t f = 0; f < d; ++f) feat_pool[f] = static_cast<int32_t>(f);
    for (;;) {
      int32_t t = next_tree.fetch_add(1);
      if (t >= n_trees) return;
      Rng rng(seed * 0x9e3779b97f4a7c15ULL + 0x100 + t);
      for (int64_t i = 0; i < n_bag; ++i)
        rows[i] = static_cast<int32_t>(rng.bounded(n));
      build_tree(ctx, rows, rng, feat_pool, m->trees[t]);
    }
  };
  std::vector<std::thread> threads;
  for (int t = 0; t < n_threads; ++t) threads.emplace_back(worker);
  for (auto& t : threads) t.join();
  return m;
}

// out: row-major [n, n_classes] mean leaf distribution over trees.
void hf_predict_proba(const void* model, const float* X, int64_t n,
                      float* out, int32_t n_threads) {
  const auto* m = static_cast<const Model*>(model);
  const int n_cuts = m->n_bins - 1;
  const int K = m->n_classes;
  if (n_threads <= 0)
    n_threads = std::max(1u, std::thread::hardware_concurrency());
  std::memset(out, 0, sizeof(float) * static_cast<size_t>(n) * K);
  std::atomic<int64_t> next_row{0};
  auto worker = [&]() {
    std::vector<uint8_t> bins(m->d);
    for (;;) {
      int64_t i = next_row.fetch_add(16);
      if (i >= n) return;
      int64_t end = std::min<int64_t>(i + 16, n);
      for (int64_t r = i; r < end; ++r) {
        const float* x = X + r * m->d;
        for (int64_t f = 0; f < m->d; ++f)
          bins[f] = bin_of(m->cuts.data() + f * n_cuts, n_cuts, x[f]);
        float* o = out + r * K;
        for (const Tree& tr : m->trees) {
          int32_t node = 0;
          while (tr.nodes[node].feat >= 0) {
            const Node& nd = tr.nodes[node];
            node = bins[nd.feat] <= nd.thr ? nd.left : nd.right;
          }
          const float* p = tr.leaf_probs.data()
                           + static_cast<size_t>(tr.nodes[node].leaf) * K;
          for (int k = 0; k < K; ++k) o[k] += p[k];
        }
        const float inv = 1.0f / static_cast<float>(m->trees.size());
        for (int k = 0; k < K; ++k) o[k] *= inv;
      }
    }
  };
  std::vector<std::thread> threads;
  for (int t = 0; t < n_threads; ++t) threads.emplace_back(worker);
  for (auto& t : threads) t.join();
}

int32_t hf_n_classes(const void* model) {
  return static_cast<const Model*>(model)->n_classes;
}

void hf_free(void* model) { delete static_cast<Model*>(model); }

}  // extern "C"
