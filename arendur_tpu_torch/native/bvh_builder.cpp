// Binned-SAH BVH build on the host (the native twin of the NumPy build
// accel/bvh.py build_bvh_plain; ref: src/component/bvh.rs:246-415).
//
// 32 centroid buckets on the max-extent axis, prefix / suffix area
// accumulation, traversal cost 0.125, a leaf at <= max_leaf primitives,
// depth-first layout with the first child at i + 1 and the second
// child's index stored on an interior node (bvh.rs:137-146, 219-243).
//
// It computes what the NumPy build computes, array for array:
//   * the bucket of a centroid is the int64 truncation of
//     (c - cmin) * scale in float32, clipped to 31;
//   * the split axis is the first largest extent, the split the first
//     cheapest bucket boundary;
//   * a surface area is float32; the SAH cost is float64 (NumPy promotes
//     int64 count * float32 area to float64), rounded to float32 once,
//     as the NumPy build stores it in its float32 cost array;
//   * the partition is stable;
//   * identical centroids, or every centroid in one bucket, split the
//     range at (lo + hi) / 2.
// Built with -ffp-contract=off: a contracted multiply-add rounds once
// where NumPy rounds twice, and one such rounding can pick another
// bucket or split.
//
// One stateless call: the caller allocates the node arrays (a tree of T
// triangles has at most 2T - 1 nodes) and the order.  The nodes are
// made in pre-order from an explicit stack, so no mesh can run the
// host's stack out.  C ABI only (loaded through ctypes).

#include <cmath>
#include <cstdint>
#include <limits>
#include <vector>

namespace {

constexpr int kBuckets = 32;
constexpr double kTraversalCost = 0.125;

struct Vec3 {
  float v[3];
  float operator[](int a) const { return v[a]; }
};

inline Vec3 vmin(const Vec3& a, const Vec3& b) {
  return {{a[0] < b[0] ? a[0] : b[0], a[1] < b[1] ? a[1] : b[1],
           a[2] < b[2] ? a[2] : b[2]}};
}
inline Vec3 vmax(const Vec3& a, const Vec3& b) {
  return {{a[0] > b[0] ? a[0] : b[0], a[1] > b[1] ? a[1] : b[1],
           a[2] > b[2] ? a[2] : b[2]}};
}

// float32, in NumPy's order: 2 * ((dx * dy + dy * dz) + dz * dx)
inline float surface_area(const Vec3& mn, const Vec3& mx) {
  float d[3];
  for (int a = 0; a < 3; ++a) {
    float e = mx[a] - mn[a];
    d[a] = e > 0.0f ? e : 0.0f;
  }
  return 2.0f * (d[0] * d[1] + d[1] * d[2] + d[2] * d[0]);
}

struct Out {
  float* bmin;
  float* bmax;
  int32_t* second;
  int32_t* start;
  int32_t* count;
  int32_t* axis;

  void put(int i, const Vec3& mn, const Vec3& mx, int32_t st, int32_t ct,
           int32_t ax) {
    for (int a = 0; a < 3; ++a) {
      bmin[3 * i + a] = mn[a];
      bmax[3 * i + a] = mx[a];
    }
    second[i] = 0;
    start[i] = st;
    count[i] = ct;
    axis[i] = ax;
  }
};

struct Range {
  int32_t lo, hi;
  int32_t parent;  // the node whose second child this is, or -1
};

// The split of order[lo:hi] (n > max_leaf): partitions the range and
// returns its middle; *axis receives the split axis.
int32_t split(const std::vector<Vec3>& pmin, const std::vector<Vec3>& pmax,
              const std::vector<Vec3>& centroid, int32_t* order,
              std::vector<int8_t>& bucket_of, std::vector<int32_t>& scratch,
              int32_t lo, int32_t hi, const Vec3& bmin, const Vec3& bmax,
              int32_t* axis) {
  const int32_t n = hi - lo;
  const int32_t even = (lo + hi) / 2;
  Vec3 cmin = centroid[order[lo]], cmax = cmin;
  for (int32_t i = lo + 1; i < hi; ++i) {
    cmin = vmin(cmin, centroid[order[i]]);
    cmax = vmax(cmax, centroid[order[i]]);
  }
  const float extent[3] = {cmax[0] - cmin[0], cmax[1] - cmin[1],
                           cmax[2] - cmin[2]};
  int ax = 0;  // the first largest, as np.argmax
  if (extent[1] > extent[ax]) ax = 1;
  if (extent[2] > extent[ax]) ax = 2;
  *axis = ax;
  if (extent[ax] < 1e-12f) return even;

  const float scale = static_cast<float>(kBuckets) / extent[ax];
  const float inf = std::numeric_limits<float>::infinity();
  int64_t counts[kBuckets] = {0};
  Vec3 bucket_min[kBuckets], bucket_max[kBuckets];
  for (int k = 0; k < kBuckets; ++k) {
    bucket_min[k] = {{inf, inf, inf}};
    bucket_max[k] = {{-inf, -inf, -inf}};
  }
  for (int32_t i = 0; i < n; ++i) {
    const int32_t id = order[lo + i];
    int64_t b = static_cast<int64_t>((centroid[id][ax] - cmin[ax]) * scale);
    if (b > kBuckets - 1) b = kBuckets - 1;
    if (b < 0) b = 0;
    bucket_of[i] = static_cast<int8_t>(b);
    counts[b]++;
    bucket_min[b] = vmin(bucket_min[b], pmin[id]);
    bucket_max[b] = vmax(bucket_max[b], pmax[id]);
  }
  Vec3 left_min[kBuckets], left_max[kBuckets];
  Vec3 right_min[kBuckets], right_max[kBuckets];
  int64_t left_count[kBuckets], right_count[kBuckets];
  left_min[0] = bucket_min[0];
  left_max[0] = bucket_max[0];
  left_count[0] = counts[0];
  for (int k = 1; k < kBuckets; ++k) {
    left_min[k] = vmin(left_min[k - 1], bucket_min[k]);
    left_max[k] = vmax(left_max[k - 1], bucket_max[k]);
    left_count[k] = left_count[k - 1] + counts[k];
  }
  right_min[kBuckets - 1] = bucket_min[kBuckets - 1];
  right_max[kBuckets - 1] = bucket_max[kBuckets - 1];
  right_count[kBuckets - 1] = counts[kBuckets - 1];
  for (int k = kBuckets - 2; k >= 0; --k) {
    right_min[k] = vmin(right_min[k + 1], bucket_min[k]);
    right_max[k] = vmax(right_max[k + 1], bucket_max[k]);
    right_count[k] = right_count[k + 1] + counts[k];
  }
  // max(area, 1e-20): Python's max keeps the float32 area unless it lies
  // below 1e-20 (compared in float32), and then divides by the double
  const float area = surface_area(bmin, bmax);
  const double total_area = area < 1e-20f ? 1e-20 : static_cast<double>(area);
  float best_cost = inf;
  int best = 0;  // the first smallest, as np.argmin (0 where all are inf)
  for (int k = 0; k < kBuckets - 1; ++k) {
    if (left_count[k] == 0 || right_count[k + 1] == 0) continue;
    const double cost =
        kTraversalCost +
        (static_cast<double>(left_count[k]) *
             static_cast<double>(surface_area(left_min[k], left_max[k])) +
         static_cast<double>(right_count[k + 1]) *
             static_cast<double>(
                 surface_area(right_min[k + 1], right_max[k + 1]))) /
            total_area;
    const float c = static_cast<float>(cost);
    if (c < best_cost) {
      best_cost = c;
      best = k;
    }
  }
  if (!std::isfinite(best_cost)) return even;

  // stable partition by bucket <= best
  int32_t nl = 0, nr = 0;
  for (int32_t i = 0; i < n; ++i) {
    if (bucket_of[i] <= best)
      order[lo + nl++] = order[lo + i];
    else
      scratch[nr++] = order[lo + i];
  }
  for (int32_t i = 0; i < nr; ++i) order[lo + nl + i] = scratch[i];
  return lo + nl;
}

}  // namespace

extern "C" {

// Builds the BVH of n_tris triangles v0, v1, v2 [n_tris, 3] (float32,
// row-major) into order [n_tris] and the node arrays bmin, bmax
// [capacity, 3], second, start, count, axis [capacity].  Returns the node
// count, -1 for bad arguments (n_tris < 1, max_leaf < 1) and -2 where the
// tree would pass capacity (2 * n_tris - 1 always suffices).
int32_t arendur_bvh_build(const float* v0, const float* v1, const float* v2,
                          int32_t n_tris, int32_t max_leaf, int32_t capacity,
                          int32_t* order, float* bmin, float* bmax,
                          int32_t* second, int32_t* start, int32_t* count,
                          int32_t* axis) {
  if (n_tris < 1 || max_leaf < 1) return -1;
  std::vector<Vec3> pmin(n_tris), pmax(n_tris), centroid(n_tris);
  for (int32_t i = 0; i < n_tris; ++i) {
    const Vec3 a = {{v0[3 * i], v0[3 * i + 1], v0[3 * i + 2]}};
    const Vec3 b = {{v1[3 * i], v1[3 * i + 1], v1[3 * i + 2]}};
    const Vec3 c = {{v2[3 * i], v2[3 * i + 1], v2[3 * i + 2]}};
    pmin[i] = vmin(vmin(a, b), c);
    pmax[i] = vmax(vmax(a, b), c);
    for (int k = 0; k < 3; ++k)
      centroid[i].v[k] = 0.5f * (pmin[i][k] + pmax[i][k]);
    order[i] = i;
  }
  std::vector<int8_t> bucket_of(n_tris);
  std::vector<int32_t> scratch(n_tris);
  Out out = {bmin, bmax, second, start, count, axis};
  // pre-order: a range's first child is popped (and numbered) next, its
  // second after the whole first subtree, as the recursion numbers them
  std::vector<Range> stack = {{0, n_tris, -1}};
  int32_t m = 0;
  while (!stack.empty()) {
    const Range r = stack.back();
    stack.pop_back();
    if (m >= capacity) return -2;
    const int32_t id = m++;
    if (r.parent >= 0) second[r.parent] = id;
    Vec3 mn = pmin[order[r.lo]], mx = pmax[order[r.lo]];
    for (int32_t i = r.lo + 1; i < r.hi; ++i) {
      mn = vmin(mn, pmin[order[i]]);
      mx = vmax(mx, pmax[order[i]]);
    }
    if (r.hi - r.lo <= max_leaf) {
      out.put(id, mn, mx, r.lo, r.hi - r.lo, 0);
      continue;
    }
    int32_t ax = 0;
    const int32_t mid = split(pmin, pmax, centroid, order, bucket_of,
                              scratch, r.lo, r.hi, mn, mx, &ax);
    out.put(id, mn, mx, 0, 0, ax);
    stack.push_back({mid, r.hi, id});
    stack.push_back({r.lo, mid, -1});
  }
  return m;
}

}  // extern "C"
