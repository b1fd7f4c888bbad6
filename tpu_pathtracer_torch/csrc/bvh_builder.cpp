// Native sweep-SAH BVH builder.
//
// Same contract as the numpy builder (tpu_pathtracer/accel/bvh.py), which in
// turn reproduces the reference's builder decisions
// (reference: src/passes/raytrace.ts:540-694):
//   * one leaf per triangle,
//   * 2-element fast path keeps incoming order,
//   * split axis = longest axis, tie-break `x>y ? (x>z ? x : z) : y`,
//   * stable sort by AABB centroid on that axis,
//   * full-sweep SAH cost leftArea*nLeft + rightArea*nRight, first minimum,
//   * flatten breadth-first, root at index 0.
//
// All box math in double, exactly like the numpy oracle, so the two builders
// produce bit-identical trees (verified by tests/test_native_bvh.py).
//
// Exposed via ctypes (tpu_pathtracer/accel/native.py).  Build:
//   g++ -O3 -fPIC -shared -o libtpu_pt.so bvh_builder.cpp

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <deque>
#include <vector>

namespace {

struct Vec3 {
  double x, y, z;
};

static inline Vec3 vmin(const Vec3 &a, const Vec3 &b) {
  return {std::min(a.x, b.x), std::min(a.y, b.y), std::min(a.z, b.z)};
}
static inline Vec3 vmax(const Vec3 &a, const Vec3 &b) {
  return {std::max(a.x, b.x), std::max(a.y, b.y), std::max(a.z, b.z)};
}
static inline double surface_area(const Vec3 &mn, const Vec3 &mx) {
  double x = mx.x - mn.x, y = mx.y - mn.y, z = mx.z - mn.z;
  return 2.0 * (x * y + x * z + y * z);
}

struct Node {
  Vec3 mn, mx;
  int32_t left = -1, right = -1, tri = -1;
  int32_t leaf = 0;
};

struct Task {
  int64_t begin, end;  // range in the shared index array
  int32_t parent;      // parent node id (-1 for root)
  int32_t side;        // 0 = left child, 1 = right child
};

}  // namespace

extern "C" {

// Outputs must be sized for 2n-1 nodes.  Returns node count (2n-1), or 0 for
// an empty scene, or -1 on error.
int64_t tpu_pt_bvh_build(const float *p0, const float *p1, const float *p2,
                         int64_t n, float *out_min, float *out_max,
                         int32_t *out_left, int32_t *out_right,
                         int32_t *out_tri, int32_t *out_leaf) {
  if (n <= 0) return 0;
  const int64_t k = 2 * n - 1;

  std::vector<Vec3> tri_min(n), tri_max(n), centroid(n);
  for (int64_t i = 0; i < n; ++i) {
    Vec3 a{p0[3 * i], p0[3 * i + 1], p0[3 * i + 2]};
    Vec3 b{p1[3 * i], p1[3 * i + 1], p1[3 * i + 2]};
    Vec3 c{p2[3 * i], p2[3 * i + 1], p2[3 * i + 2]};
    tri_min[i] = vmin(vmin(a, b), c);
    tri_max[i] = vmax(vmax(a, b), c);
    centroid[i] = {(tri_min[i].x + tri_max[i].x) * 0.5,
                   (tri_min[i].y + tri_max[i].y) * 0.5,
                   (tri_min[i].z + tri_max[i].z) * 0.5};
  }

  std::vector<int64_t> idx(n);
  for (int64_t i = 0; i < n; ++i) idx[i] = i;

  std::vector<Node> nodes;
  nodes.reserve(k);
  // Scratch for the prefix/suffix bbox sweeps, sized to the largest range.
  std::vector<Vec3> lmin(n), lmax(n), rmin(n), rmax(n);

  std::vector<Task> stack;
  stack.push_back({0, n, -1, 0});
  int32_t root_id = -1;

  while (!stack.empty()) {
    Task t = stack.back();
    stack.pop_back();
    const int64_t count = t.end - t.begin;

    Vec3 bmin = tri_min[idx[t.begin]];
    Vec3 bmax = tri_max[idx[t.begin]];
    for (int64_t i = t.begin + 1; i < t.end; ++i) {
      bmin = vmin(bmin, tri_min[idx[i]]);
      bmax = vmax(bmax, tri_max[idx[i]]);
    }

    const int32_t nid = static_cast<int32_t>(nodes.size());
    Node node;
    node.mn = bmin;
    node.mx = bmax;

    if (count == 1) {
      node.leaf = 1;
      node.tri = static_cast<int32_t>(idx[t.begin]);
      nodes.push_back(node);
    } else {
      int64_t split;  // first right-side element, relative to t.begin
      if (count == 2) {
        split = 1;  // keep incoming order (raytrace.ts:587-589)
      } else {
        const double sx = bmax.x - bmin.x, sy = bmax.y - bmin.y,
                     sz = bmax.z - bmin.z;
        int axis = (sx > sy) ? ((sx > sz) ? 0 : 2) : 1;  // raytrace.ts:592

        auto key = [&](int64_t ti) -> double {
          const Vec3 &c = centroid[ti];
          return axis == 0 ? c.x : (axis == 1 ? c.y : c.z);
        };
        std::stable_sort(idx.begin() + t.begin, idx.begin() + t.end,
                         [&](int64_t a, int64_t b) { return key(a) < key(b); });

        // prefix (left) and suffix (right) bbox scans over the sorted range
        lmin[0] = tri_min[idx[t.begin]];
        lmax[0] = tri_max[idx[t.begin]];
        for (int64_t i = 1; i < count; ++i) {
          lmin[i] = vmin(lmin[i - 1], tri_min[idx[t.begin + i]]);
          lmax[i] = vmax(lmax[i - 1], tri_max[idx[t.begin + i]]);
        }
        rmin[count - 1] = tri_min[idx[t.begin + count - 1]];
        rmax[count - 1] = tri_max[idx[t.begin + count - 1]];
        for (int64_t i = count - 2; i >= 0; --i) {
          rmin[i] = vmin(rmin[i + 1], tri_min[idx[t.begin + i]]);
          rmax[i] = vmax(rmax[i + 1], tri_max[idx[t.begin + i]]);
        }

        double best_cost = 0.0;
        split = 1;
        for (int64_t s = 1; s < count; ++s) {
          const double cost =
              surface_area(lmin[s - 1], lmax[s - 1]) * static_cast<double>(s) +
              surface_area(rmin[s], rmax[s]) * static_cast<double>(count - s);
          if (s == 1 || cost < best_cost) {  // first minimum wins
            best_cost = cost;
            split = s;
          }
        }
      }
      nodes.push_back(node);
      // Push right first so left is processed first (matches the numpy
      // builder; BFS renumbering makes the final layout identical anyway).
      stack.push_back({t.begin + split, t.end, nid, 1});
      stack.push_back({t.begin, t.begin + split, nid, 0});
    }

    if (t.parent < 0) {
      root_id = nid;
    } else if (t.side == 0) {
      nodes[t.parent].left = nid;
    } else {
      nodes[t.parent].right = nid;
    }
  }

  if (static_cast<int64_t>(nodes.size()) != k) return -1;

  // BFS renumber, root at index 0 (raytrace.ts:667-694).
  std::vector<int32_t> order(k), new_id(k);
  {
    std::deque<int32_t> q;
    q.push_back(root_id);
    int64_t pos = 0;
    while (!q.empty()) {
      int32_t nid = q.front();
      q.pop_front();
      order[pos] = nid;
      new_id[nid] = static_cast<int32_t>(pos);
      ++pos;
      if (!nodes[nid].leaf) {
        q.push_back(nodes[nid].left);
        q.push_back(nodes[nid].right);
      }
    }
  }

  for (int64_t i = 0; i < k; ++i) {
    const Node &nd = nodes[order[i]];
    out_min[3 * i] = static_cast<float>(nd.mn.x);
    out_min[3 * i + 1] = static_cast<float>(nd.mn.y);
    out_min[3 * i + 2] = static_cast<float>(nd.mn.z);
    out_max[3 * i] = static_cast<float>(nd.mx.x);
    out_max[3 * i + 1] = static_cast<float>(nd.mx.y);
    out_max[3 * i + 2] = static_cast<float>(nd.mx.z);
    out_left[i] = nd.leaf ? -1 : new_id[nd.left];
    out_right[i] = nd.leaf ? -1 : new_id[nd.right];
    out_tri[i] = nd.tri;
    out_leaf[i] = nd.leaf;
  }
  return k;
}

// DFS-preorder skip-link relayout (the device traversal layout; see
// tpu_pathtracer/accel/bvh.py flat_to_links).  Inputs are the BFS flat
// arrays from tpu_pt_bvh_build; outputs sized k.  `miss[i]` is the node to
// jump to when the subtree at i is skipped; the terminator is
// `end_sentinel`.  Returns the node count written (== k).
int64_t tpu_pt_bvh_links(const float *in_min, const float *in_max,
                         const int32_t *in_left, const int32_t *in_right,
                         const int32_t *in_tri, const int32_t *in_leaf,
                         int64_t k, int64_t end_sentinel, float *out_min,
                         float *out_max, int32_t *out_tri,
                         int32_t *out_miss) {
  if (k <= 0) return 0;
  // subtree sizes, computed in reverse BFS order (children have larger BFS
  // indices than parents, so a reverse sweep sees children first)
  std::vector<int64_t> size(k, 1);
  for (int64_t i = k - 1; i >= 0; --i) {
    if (!in_leaf[i]) size[i] = 1 + size[in_left[i]] + size[in_right[i]];
  }

  struct Item {
    int32_t node;
    int64_t miss;
  };
  std::vector<Item> stack;
  stack.push_back({0, end_sentinel});
  int64_t pos = 0;
  while (!stack.empty()) {
    Item it = stack.back();
    stack.pop_back();
    const int32_t n = it.node;
    std::memcpy(out_min + 3 * pos, in_min + 3 * n, 3 * sizeof(float));
    std::memcpy(out_max + 3 * pos, in_max + 3 * n, 3 * sizeof(float));
    out_tri[pos] = in_leaf[n] ? in_tri[n] : -1;
    out_miss[pos] = static_cast<int32_t>(it.miss);
    const int64_t here = pos;
    ++pos;
    if (!in_leaf[n]) {
      const int32_t l = in_left[n], r = in_right[n];
      const int64_t right_start = here + 1 + size[l];
      stack.push_back({r, it.miss});        // right's miss = parent's miss
      stack.push_back({l, right_start});    // left's miss = right subtree
    }
  }
  return pos;
}

}  // extern "C"
