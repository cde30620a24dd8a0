// High-dimensional Gaussian filtering on the permutohedral lattice.
//
// Native CPU backend mirroring the ROLE of the reference's C++/SWIG extension
// (SCD-AAAI2023/wrapper/bilateralfilter: 5-D (x,y,r,g,b) filtering, OpenMP-parallel
// over the batch) — written independently from the published algorithm
// (Adams, Baek, Davis: "Fast High-Dimensional Filtering Using the Permutohedral
// Lattice", EG 2010). Exposed via a plain C ABI for ctypes (no pybind11 in the image).
//
// Algorithm sketch: embed d-dim features onto the hyperplane H_d in R^{d+1} with an
// elongating basis, locate the enclosing simplex of the permutohedral lattice by
// rounding to the nearest multiple-of-(d+1) remainder-0 point plus a rank sort,
// compute barycentric weights, splat values into a hash table keyed by lattice points,
// blur along each of the d+1 lattice axes with a [1 2 1] kernel, and slice back.
//
// Build: g++ -O3 -march=native -fopenmp -shared -fPIC permutohedral.cc -o libpermutohedral.so

#include <cmath>
#include <cstdint>
#include <cstring>
#include <unordered_map>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

// Hash for short int16 keys of fixed length d.
struct KeyHash {
  size_t operator()(const std::vector<int16_t>& k) const {
    size_t h = 14695981039346656037ULL;
    for (int16_t v : k) {
      h ^= static_cast<uint16_t>(v);
      h *= 1099511628211ULL;
    }
    return h;
  }
};

class Lattice {
 public:
  Lattice(const float* features, int d, int n) : d_(d), n_(n) {
    const int dp1 = d + 1;
    offsets_.assign(static_cast<size_t>(n) * dp1, 0);
    weights_.assign(static_cast<size_t>(n) * dp1, 0.f);

    // scale so that the blur kernel variance matches exp(-|x|^2/2)
    std::vector<float> scale(d);
    const float inv_std = std::sqrt(2.0f / 3.0f) * static_cast<float>(dp1);
    for (int i = 0; i < d; ++i)
      scale[i] = inv_std / std::sqrt((i + 1.0f) * (i + 2.0f));

    std::vector<float> elevated(dp1);
    std::vector<int> rank(dp1);
    std::vector<int16_t> grey(dp1), key(d);
    std::vector<float> bary(dp1 + 1);

    std::unordered_map<std::vector<int16_t>, int, KeyHash> table;
    table.reserve(n * 2);

    for (int p = 0; p < n; ++p) {
      const float* f = features + static_cast<size_t>(p) * d;

      // elevate onto H_d with the E basis (upper-triangular recurrence)
      float sm = 0.f;
      for (int j = d; j > 0; --j) {
        float cf = f[j - 1] * scale[j - 1];
        elevated[j] = sm - j * cf;
        sm += cf;
      }
      elevated[0] = sm;

      // nearest remainder-0 lattice point
      float down = 1.0f / dp1;
      int sum = 0;
      for (int i = 0; i < dp1; ++i) {
        float v = elevated[i] * down;
        int up = static_cast<int>(std::ceil(v)) * dp1;
        int dn = static_cast<int>(std::floor(v)) * dp1;
        grey[i] = static_cast<int16_t>(
            (up - elevated[i] < elevated[i] - dn) ? up : dn);
        sum += grey[i];
      }
      sum /= dp1;

      // rank differential coordinates
      for (int i = 0; i < dp1; ++i) rank[i] = 0;
      for (int i = 0; i < d; ++i)
        for (int j = i + 1; j < dp1; ++j) {
          if (elevated[i] - grey[i] < elevated[j] - grey[j])
            ++rank[i];
          else
            ++rank[j];
        }
      // fix points outside the canonical simplex
      for (int i = 0; i < dp1; ++i) {
        rank[i] += sum;
        if (rank[i] < 0) {
          rank[i] += dp1;
          grey[i] = static_cast<int16_t>(grey[i] + dp1);
        } else if (rank[i] > d) {
          rank[i] -= dp1;
          grey[i] = static_cast<int16_t>(grey[i] - dp1);
        }
      }

      // barycentric coordinates
      std::fill(bary.begin(), bary.end(), 0.f);
      for (int i = 0; i < dp1; ++i) {
        float delta = (elevated[i] - grey[i]) * down;
        bary[d - rank[i]] += delta;
        bary[d + 1 - rank[i]] -= delta;
      }
      bary[0] += 1.0f + bary[dp1];

      // splat targets: the dp1 simplex vertices
      for (int rem = 0; rem < dp1; ++rem) {
        for (int i = 0; i < d; ++i) {
          int16_t ki = grey[i];
          if (rank[i] > d - rem) ki = static_cast<int16_t>(ki + rem - dp1);
          else ki = static_cast<int16_t>(ki + rem);
          key[i] = ki;
        }
        auto it = table.find(key);
        int idx;
        if (it == table.end()) {
          idx = static_cast<int>(table.size());
          table.emplace(key, idx);
          keys_.insert(keys_.end(), key.begin(), key.end());
        } else {
          idx = it->second;
        }
        offsets_[static_cast<size_t>(p) * dp1 + rem] = idx;
        weights_[static_cast<size_t>(p) * dp1 + rem] = bary[rem];
      }
    }
    m_ = static_cast<int>(table.size());

    // neighbor table for the blur: for each lattice point and axis a, the two
    // neighbors along lattice direction a
    blur_n1_.assign(static_cast<size_t>(m_) * (d_ + 1), -1);
    blur_n2_.assign(static_cast<size_t>(m_) * (d_ + 1), -1);
    std::vector<int16_t> np(d), nm(d);
    for (int a = 0; a <= d_; ++a) {
      for (int i = 0; i < m_; ++i) {
        const int16_t* k = &keys_[static_cast<size_t>(i) * d_];
        for (int j = 0; j < d_; ++j) {
          np[j] = static_cast<int16_t>(k[j] + 1);
          nm[j] = static_cast<int16_t>(k[j] - 1);
        }
        if (a < d_) {
          np[a] = static_cast<int16_t>(k[a] - d_);
          nm[a] = static_cast<int16_t>(k[a] + d_);
        }
        auto i1 = table.find(np);
        auto i2 = table.find(nm);
        blur_n1_[static_cast<size_t>(a) * m_ + i] = i1 == table.end() ? -1 : i1->second;
        blur_n2_[static_cast<size_t>(a) * m_ + i] = i2 == table.end() ? -1 : i2->second;
      }
    }
  }

  // Filter `vd`-channel values: in (n, vd) -> out (n, vd).
  void Compute(const float* in, float* out, int vd) const {
    const int dp1 = d_ + 1;
    std::vector<float> vals(static_cast<size_t>(m_ + 1) * vd, 0.f);
    std::vector<float> tmp(static_cast<size_t>(m_ + 1) * vd, 0.f);

    // splat
    for (int p = 0; p < n_; ++p)
      for (int r = 0; r < dp1; ++r) {
        int o = offsets_[static_cast<size_t>(p) * dp1 + r];
        float w = weights_[static_cast<size_t>(p) * dp1 + r];
        for (int c = 0; c < vd; ++c)
          vals[static_cast<size_t>(o) * vd + c] += w * in[static_cast<size_t>(p) * vd + c];
      }

    // blur along each lattice axis: [1 2 1] (standard lattice convention; the final
    // alpha factor matches the usual permutohedral amplitude)
    std::vector<float>* cur = &vals;
    std::vector<float>* nxt = &tmp;
    for (int a = 0; a <= d_; ++a) {
      for (int i = 0; i < m_; ++i) {
        int i1 = blur_n1_[static_cast<size_t>(a) * m_ + i];
        int i2 = blur_n2_[static_cast<size_t>(a) * m_ + i];
        const float* v0 = cur->data() + static_cast<size_t>(i) * vd;
        const float* v1 = cur->data() + static_cast<size_t>(i1 < 0 ? m_ : i1) * vd;
        const float* v2 = cur->data() + static_cast<size_t>(i2 < 0 ? m_ : i2) * vd;
        float* o = nxt->data() + static_cast<size_t>(i) * vd;
        for (int c = 0; c < vd; ++c) o[c] = v1[c] + 2.f * v0[c] + v2[c];
      }
      std::swap(cur, nxt);
    }

    // slice (alpha undoes the blur's mass loss so the response matches the
    // unnormalized Gaussian transform like the reference filter)
    const float alpha = 1.f / (1.f + std::pow(2.f, -static_cast<float>(d_)));
    for (int p = 0; p < n_; ++p) {
      for (int c = 0; c < vd; ++c) out[static_cast<size_t>(p) * vd + c] = 0.f;
      for (int r = 0; r < dp1; ++r) {
        int o = offsets_[static_cast<size_t>(p) * dp1 + r];
        float w = weights_[static_cast<size_t>(p) * dp1 + r] * alpha;
        const float* v = cur->data() + static_cast<size_t>(o) * vd;
        for (int c = 0; c < vd; ++c) out[static_cast<size_t>(p) * vd + c] += w * v[c];
      }
    }
  }

 private:
  int d_, n_, m_ = 0;
  std::vector<int> offsets_;
  std::vector<float> weights_;
  std::vector<int16_t> keys_;
  std::vector<int> blur_n1_, blur_n2_;
};

void BuildFeatures(const float* image, int H, int W, float sigma_rgb,
                   float sigma_xy, std::vector<float>* feats) {
  feats->resize(static_cast<size_t>(H) * W * 5);
  for (int y = 0; y < H; ++y)
    for (int x = 0; x < W; ++x) {
      float* f = feats->data() + (static_cast<size_t>(y) * W + x) * 5;
      f[0] = x / sigma_xy;
      f[1] = y / sigma_xy;
      const float* px = image + (static_cast<size_t>(y) * W + x) * 3;
      f[2] = px[0] / sigma_rgb;
      f[3] = px[1] / sigma_rgb;
      f[4] = px[2] / sigma_rgb;
    }
}

}  // namespace

extern "C" {

// image: (H, W, 3) RGB in [0,255]; in/out: (H, W, K) channel-last.
void bilateral_filter(const float* image, const float* in, float* out, int H,
                      int W, int K, float sigma_rgb, float sigma_xy) {
  std::vector<float> feats;
  BuildFeatures(image, H, W, sigma_rgb, sigma_xy, &feats);
  Lattice lattice(feats.data(), 5, H * W);
  lattice.Compute(in, out, K);
}

// Batched variant, OpenMP-parallel over images (the reference parallelizes the same
// way, `bilateralfilter.cpp:42-55`).
void bilateral_filter_batch(const float* images, const float* ins, float* outs,
                            int N, int K, int H, int W, float sigma_rgb,
                            float sigma_xy) {
#ifdef _OPENMP
#pragma omp parallel for schedule(dynamic)
#endif
  for (int n = 0; n < N; ++n) {
    bilateral_filter(images + static_cast<size_t>(n) * H * W * 3,
                     ins + static_cast<size_t>(n) * H * W * K,
                     outs + static_cast<size_t>(n) * H * W * K, H, W, K,
                     sigma_rgb, sigma_xy);
  }
}

}  // extern "C"
