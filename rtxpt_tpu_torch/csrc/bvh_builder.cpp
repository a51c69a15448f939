// Host BVH builder: binned-SAH binary BVH over triangle soups (the
// port's own copy of the reference package's native builder; the port
// imports nothing of that package).
//
// Output layout matches ops/bvh.py BVH2: per-node [lmin lmax rmin rmax]
// bounds (12 f32) + two child codes (>=0 internal node, <0 leaf code
// -(start*32+count)-1), plus the leaf-ordered triangle permutation and
// per-node depth.
//
// Exposed as a C ABI for ctypes. Built by rtxpt_tpu_torch/native.py with
// g++ -O3 -std=c++17 -fPIC -shared -ffp-contract=off and without
// -march=native: no fused multiply-adds and no host-specific code, so the
// SAH costs, and with them the tree, are the same on every machine.

#include <algorithm>
#include <atomic>
#include <cfloat>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct AABB {
  float lo[3] = {FLT_MAX, FLT_MAX, FLT_MAX};
  float hi[3] = {-FLT_MAX, -FLT_MAX, -FLT_MAX};
  void grow(const float* p) {
    for (int k = 0; k < 3; ++k) {
      lo[k] = std::min(lo[k], p[k]);
      hi[k] = std::max(hi[k], p[k]);
    }
  }
  void grow(const AABB& b) {
    for (int k = 0; k < 3; ++k) {
      lo[k] = std::min(lo[k], b.lo[k]);
      hi[k] = std::max(hi[k], b.hi[k]);
    }
  }
  float half_area() const {
    float dx = std::max(hi[0] - lo[0], 0.f);
    float dy = std::max(hi[1] - lo[1], 0.f);
    float dz = std::max(hi[2] - lo[2], 0.f);
    return dx * dy + dy * dz + dz * dx;
  }
};

struct Builder {
  const float* positions;  // (V,3)
  const int32_t* indices;  // (T,3)
  std::vector<AABB> tri_bounds;
  std::vector<float> centroids;  // (T,3)
  std::vector<int64_t> order;
  std::vector<float> node_bounds;   // 12 per node
  std::vector<int32_t> node_child;  // 2 per node
  std::vector<int32_t> node_depth;
  int leaf_size;
  int64_t cursor = 0;
  std::vector<int64_t> out_order;

  static constexpr int kBins = 16;

  int64_t new_node(int depth) {
    node_bounds.insert(node_bounds.end(), 12, 0.f);
    node_child.insert(node_child.end(), 2, -1);
    node_depth.push_back(depth);
    return (int64_t)node_depth.size() - 1;
  }

  static int32_t encode_leaf(int64_t start, int64_t count) {
    return (int32_t)(-((start << 5) | count) - 1);
  }

  AABB range_bounds(int64_t lo, int64_t hi) const {
    AABB b;
    for (int64_t i = lo; i < hi; ++i) b.grow(tri_bounds[order[i]]);
    return b;
  }

  // returns child code; writes [lo,hi) of `order`
  int32_t build(int64_t lo, int64_t hi, const AABB& bounds, int depth,
                AABB* out_bounds) {
    *out_bounds = bounds;
    int64_t n = hi - lo;
    if (n <= leaf_size) {
      int64_t start = cursor;
      for (int64_t i = lo; i < hi; ++i) out_order[cursor++] = order[i];
      return encode_leaf(start, n);
    }

    // centroid bounds
    AABB cb;
    for (int64_t i = lo; i < hi; ++i) cb.grow(&centroids[order[i] * 3]);
    int axis = 0;
    float ext = -1.f;
    for (int k = 0; k < 3; ++k) {
      float e = cb.hi[k] - cb.lo[k];
      if (e > ext) { ext = e; axis = k; }
    }

    int64_t mid;
    if (ext < 1e-12f) {
      mid = lo + n / 2;  // degenerate: median split
    } else {
      // binned SAH
      AABB bin_b[kBins];
      int64_t bin_n[kBins] = {0};
      float scale = kBins / ext;
      for (int64_t i = lo; i < hi; ++i) {
        float c = centroids[order[i] * 3 + axis];
        int b = std::min(kBins - 1, (int)((c - cb.lo[axis]) * scale));
        bin_b[b].grow(tri_bounds[order[i]]);
        bin_n[b]++;
      }
      // sweep for best split
      AABB right_acc[kBins];
      AABB acc;
      for (int b = kBins - 1; b > 0; --b) {
        acc.grow(bin_b[b]);
        right_acc[b] = acc;
      }
      AABB lacc;
      int64_t lcount = 0;
      float best_cost = FLT_MAX;
      int best_split = -1;
      for (int b = 0; b < kBins - 1; ++b) {
        lacc.grow(bin_b[b]);
        lcount += bin_n[b];
        int64_t rcount = n - lcount;
        if (lcount == 0 || rcount == 0) continue;
        float cost = lacc.half_area() * lcount +
                     right_acc[b + 1].half_area() * rcount;
        if (cost < best_cost) { best_cost = cost; best_split = b; }
      }
      if (best_split < 0) {
        mid = lo + n / 2;
        std::nth_element(order.begin() + lo, order.begin() + mid,
                         order.begin() + hi, [&](int64_t a, int64_t b2) {
                           return centroids[a * 3 + axis] <
                                  centroids[b2 * 3 + axis];
                         });
      } else {
        float split_pos = cb.lo[axis] + (best_split + 1) / scale;
        auto it = std::partition(order.begin() + lo, order.begin() + hi,
                                 [&](int64_t a) {
                                   return centroids[a * 3 + axis] <
                                          split_pos;
                                 });
        mid = it - order.begin();
        if (mid == lo || mid == hi) mid = lo + n / 2;
      }
    }
    if (ext < 1e-12f || mid == lo || mid == hi) {
      mid = lo + n / 2;
      std::nth_element(order.begin() + lo, order.begin() + mid,
                       order.begin() + hi, [&](int64_t a, int64_t b2) {
                         return centroids[a * 3 + axis] <
                                centroids[b2 * 3 + axis];
                       });
    }

    int64_t node = new_node(depth);
    AABB lb, rb;
    AABB lguess = range_bounds(lo, mid);
    AABB rguess = range_bounds(mid, hi);
    int32_t lc = build(lo, mid, lguess, depth + 1, &lb);
    int32_t rc = build(mid, hi, rguess, depth + 1, &rb);
    float* nb = &node_bounds[node * 12];
    std::memcpy(nb + 0, lb.lo, 12);
    std::memcpy(nb + 3, lb.hi, 12);
    std::memcpy(nb + 6, rb.lo, 12);
    std::memcpy(nb + 9, rb.hi, 12);
    node_child[node * 2 + 0] = lc;
    node_child[node * 2 + 1] = rc;
    return (int32_t)node;
  }
};

Builder* g_last = nullptr;

}  // namespace

extern "C" {

// Builds the BVH; returns number of nodes (<0 on error). Results are
// fetched with bvh_get_* and released with bvh_free.
int64_t bvh_build(const float* positions, int64_t num_vertices,
                  const int32_t* indices, int64_t num_tris,
                  int32_t leaf_size) {
  (void)num_vertices;
  if (num_tris <= 0) return -1;
  delete g_last;
  auto* b = new Builder();
  g_last = b;
  b->positions = positions;
  b->indices = indices;
  b->leaf_size = leaf_size;
  b->tri_bounds.resize(num_tris);
  b->centroids.resize(num_tris * 3);
  b->order.resize(num_tris);
  b->out_order.resize(num_tris);
  AABB root_b;
  for (int64_t t = 0; t < num_tris; ++t) {
    AABB& tb = b->tri_bounds[t];
    for (int k = 0; k < 3; ++k) {
      tb.grow(&positions[(int64_t)indices[t * 3 + k] * 3]);
    }
    for (int j = 0; j < 3; ++j)
      b->centroids[t * 3 + j] = 0.5f * (tb.lo[j] + tb.hi[j]);
    b->order[t] = t;
    root_b.grow(tb);
  }
  if (num_tris <= leaf_size) {
    int64_t node = b->new_node(0);
    for (int64_t i = 0; i < num_tris; ++i) b->out_order[i] = i;
    float* nb = &b->node_bounds[0];
    std::memcpy(nb + 0, root_b.lo, 12);
    std::memcpy(nb + 3, root_b.hi, 12);
    std::memcpy(nb + 6, root_b.lo, 12);
    std::memcpy(nb + 9, root_b.hi, 12);
    b->node_child[0] = Builder::encode_leaf(0, num_tris);
    b->node_child[1] = -1;  // empty
    return 1;
  }
  AABB out;
  b->build(0, num_tris, root_b, 0, &out);
  return (int64_t)b->node_depth.size();
}

void bvh_get_nodes(float* bounds_out, int32_t* child_out,
                   int32_t* depth_out) {
  if (!g_last) return;
  std::memcpy(bounds_out, g_last->node_bounds.data(),
              g_last->node_bounds.size() * sizeof(float));
  std::memcpy(child_out, g_last->node_child.data(),
              g_last->node_child.size() * sizeof(int32_t));
  std::memcpy(depth_out, g_last->node_depth.data(),
              g_last->node_depth.size() * sizeof(int32_t));
}

void bvh_get_order(int64_t* order_out) {
  if (!g_last) return;
  std::memcpy(order_out, g_last->out_order.data(),
              g_last->out_order.size() * sizeof(int64_t));
}

void bvh_free() {
  delete g_last;
  g_last = nullptr;
}

}  // extern "C"
