// Native binned-SAH BVH builder.
//
// Same construction as the numpy fallback in ops/bvh.py (16-bin SAH per
// axis, leaf when n <= leaf_size or the trivial cost area*n beats the best
// split -- the reference's leaf criterion, src/bvh.rs:88-90,127-129), built
// iteratively over an explicit work stack. The reference's full-sweep build
// re-sorts the slice per axis with an AABB-recomputing comparator
// (src/bvh.rs:87-144); this is the O(n log n) binned formulation instead.
//
// A copy of the JAX package's native/bvh_builder.cpp for the PyTorch port.
// C ABI, loaded via ctypes (native/__init__.py). All geometry comes
// in as f64 AABBs (the host pipeline computes them in double); node bounds
// go out as f32 for the device.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <vector>

namespace {

constexpr double kInf = std::numeric_limits<double>::infinity();

struct Bounds {
  double mn[3] = {kInf, kInf, kInf};
  double mx[3] = {-kInf, -kInf, -kInf};

  void extend(const double* lo, const double* hi) {
    for (int a = 0; a < 3; ++a) {
      mn[a] = std::min(mn[a], lo[a]);
      mx[a] = std::max(mx[a], hi[a]);
    }
  }
  void extend(const Bounds& o) { extend(o.mn, o.mx); }
  double area() const {
    double dx = std::max(0.0, mx[0] - mn[0]);
    double dy = std::max(0.0, mx[1] - mn[1]);
    double dz = std::max(0.0, mx[2] - mn[2]);
    return dx * dy + dy * dz + dz * dx;  // half-area SAH (src/aabb.rs:32-38)
  }
};

struct WorkItem {
  int64_t start, length;
  int32_t node;
};

}  // namespace

extern "C" int64_t rt_build_bvh(
    const double* amin,   // (n, 3)
    const double* amax,   // (n, 3)
    int64_t n,
    int32_t leaf_size,
    int32_t num_bins,
    int32_t* prim_order,  // out (n): sorted position -> original row
    float* node_min,      // out (max_nodes, 3)
    float* node_max,      // out (max_nodes, 3)
    int32_t* node_left,   // out (max_nodes): child id | leaf start
    int32_t* node_right,  // out (max_nodes): child id | leaf count
    uint8_t* node_is_leaf,  // out (max_nodes)
    int64_t max_nodes) {
  if (n <= 0) return 0;

  std::vector<int64_t> order(n);
  for (int64_t i = 0; i < n; ++i) order[i] = i;
  std::vector<double> centroid(n * 3);
  for (int64_t i = 0; i < n; ++i)
    for (int a = 0; a < 3; ++a)
      centroid[i * 3 + a] = 0.5 * (amin[i * 3 + a] + amax[i * 3 + a]);

  int64_t node_count = 1;  // root = 0
  std::vector<WorkItem> stack;
  stack.push_back({0, n, 0});

  std::vector<int64_t> bin_count(num_bins);
  std::vector<Bounds> bin_bounds(num_bins);
  std::vector<Bounds> suffix(num_bins);

  while (!stack.empty()) {
    WorkItem item = stack.back();
    stack.pop_back();
    const int64_t start = item.start, length = item.length;
    const int32_t nid = item.node;

    Bounds bb;
    Bounds cb;  // centroid bounds
    for (int64_t i = start; i < start + length; ++i) {
      const int64_t p = order[i];
      bb.extend(&amin[p * 3], &amax[p * 3]);
      cb.extend(&centroid[p * 3], &centroid[p * 3]);
    }
    for (int a = 0; a < 3; ++a) {
      node_min[nid * 3 + a] = static_cast<float>(bb.mn[a]);
      node_max[nid * 3 + a] = static_cast<float>(bb.mx[a]);
    }

    // --- find the best binned split ---
    double best_cost = kInf;
    int best_axis = -1;
    double best_thresh = 0.0;
    if (length > leaf_size) {
      for (int axis = 0; axis < 3; ++axis) {
        const double lo = cb.mn[axis], hi = cb.mx[axis];
        if (hi - lo < 1e-12) continue;
        const double scale = num_bins * (1.0 - 1e-7) / (hi - lo);
        std::fill(bin_count.begin(), bin_count.end(), 0);
        std::fill(bin_bounds.begin(), bin_bounds.end(), Bounds{});
        for (int64_t i = start; i < start + length; ++i) {
          const int64_t p = order[i];
          int b = static_cast<int>((centroid[p * 3 + axis] - lo) * scale);
          b = std::min(std::max(b, 0), num_bins - 1);
          ++bin_count[b];
          bin_bounds[b].extend(&amin[p * 3], &amax[p * 3]);
        }
        suffix[num_bins - 1] = bin_bounds[num_bins - 1];
        for (int b = num_bins - 2; b >= 0; --b) {
          suffix[b] = suffix[b + 1];
          suffix[b].extend(bin_bounds[b]);
        }
        Bounds prefix;
        int64_t lcount = 0;
        for (int b = 0; b < num_bins - 1; ++b) {
          prefix.extend(bin_bounds[b]);
          lcount += bin_count[b];
          if (lcount == 0 || lcount == length) continue;
          const double cost = static_cast<double>(lcount) * prefix.area() +
                              static_cast<double>(length - lcount) *
                                  suffix[b + 1].area();
          if (cost < best_cost) {
            best_cost = cost;
            best_axis = axis;
            best_thresh = lo + (b + 1) / scale;
          }
        }
      }
    }

    const double trivial = bb.area() * static_cast<double>(length);
    if (best_axis < 0 || trivial < best_cost) {
      node_is_leaf[nid] = 1;
      node_left[nid] = static_cast<int32_t>(start);
      node_right[nid] = static_cast<int32_t>(length);
      continue;
    }

    // partition by centroid threshold (stable not required)
    int64_t* first = order.data() + start;
    int64_t* last = first + length;
    const double* cen = centroid.data();
    const int axis = best_axis;
    const double thresh = best_thresh;
    int64_t* mid = std::partition(first, last, [cen, axis, thresh](int64_t p) {
      return cen[p * 3 + axis] < thresh;
    });
    int64_t nl = mid - first;
    if (nl == 0 || nl == length) {  // degenerate: median split
      nl = length / 2;
      std::nth_element(first, first + nl, last,
                       [cen, axis](int64_t a, int64_t b) {
                         return cen[a * 3 + axis] < cen[b * 3 + axis];
                       });
    }

    if (node_count + 2 > max_nodes) return -1;
    const int32_t lid = static_cast<int32_t>(node_count++);
    const int32_t rid = static_cast<int32_t>(node_count++);
    node_is_leaf[nid] = 0;
    node_left[nid] = lid;
    node_right[nid] = rid;
    stack.push_back({start, nl, lid});
    stack.push_back({start + nl, length - nl, rid});
  }

  for (int64_t i = 0; i < n; ++i)
    prim_order[i] = static_cast<int32_t>(order[i]);
  return node_count;
}
