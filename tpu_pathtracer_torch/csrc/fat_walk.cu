// The fat-leaf skip-link BVH walk ('bvh8') for Hopper (sm_90a): each ray
// walks the rows of `fat_nodes` (accel/bvh.py `links_to_fat`) to its nearest
// hit in registers, one thread a ray, all the rays of a call in one launch.
//
// It replaces no TPU kernel.  In the JAX package the fat-leaf walk is jnp
// glue under a while_loop (tpu_pathtracer/ops/intersect.py:372
// `_bvh_fat_intersect_impl`), with no Pallas kernel.  Its plain PyTorch
// version (ops/intersect.py `_bvh_fat_intersect_plain`: `_walk` over
// `_fat_step`) steps every lane in lockstep with about 110 elementwise
// launches a step, and the host reads every 8 steps how many lanes still
// walk: a 512x512 frame of the 408K-triangle mesh took ~150,000 such
// launches and ~170 host reads.  The wrapper launches this kernel for every
// walk on a CUDA tensor.
//
// What bounds it on the H100.  A ray visits a few node rows (3.1 on average
// over a frame of that mesh), each at most 36 + 36 * max_leaf bytes: box,
// links and up to max_leaf inlined triangles.  262,144 rays a walk read at
// most ~0.3 GB, under 0.1 ms at 3.35 TB/s, and most rows sit in the 50 MB
// L2; a box test costs ~18 FP32 operations, a triangle test ~51.  What
// remains is latency: each row's load waits on the last row's links.  This
// design:
//   * one thread a ray, the walk state (node pointer, best t, triangle, u,
//     v) in registers, the rays of a warp consecutive;
//   * each row read in place through read-only loads (the box, then the
//     links, then only the leaf's `count` triangles), no shared memory, no
//     repacked table; the row width is an argument, so any max_leaf works;
//   * no host reads and no compaction: a finished ray's thread idles until
//     its warp's longest walk ends.
// The arithmetic is `_fat_step` op for op (`ray_aabb_t`, `ray_triangle`):
// IEEE divisions, products and sums each rounded (-fmad=false), the vecmath
// `cross` order, `dot` summed as torch's CUDA sum over a last axis of 3
// (x0 + x2, then + x1: two threads an output, one holding x0 and x2), and
// minimum and maximum that propagate NaN as torch.minimum, maximum, amax,
// amin and clamp do (`min.NaN`, `max.NaN`), so hits equal the plain walk's
// bit for bit.  Inside a leaf the first strict minimum of t over the usable
// slots wins, as `torch.argmin` takes the first minimum.
//
// Counters, only when `stats` is given: [0] rows visited (the plain walk's
// `walk.fat.nodes`), [1] the longest walk in rows (the lockstep depth),
// [2] over each group of 32 consecutive rays, the rays in the group times
// the group's longest walk (the lanes a warp holds, summed over its steps).
// One warp reduction and one atomic a warp and counter.

#include <cuda_runtime.h>

namespace {

constexpr float kInf = 1e20f;      // the finite sentinel (ops/vecmath.py INF)
constexpr float kEpsilon = 1e-6f;  // vecmath EPSILON
constexpr int kThreads = 128;

// torch.minimum / torch.maximum: NaN if either operand is NaN.
__device__ __forceinline__ float t_min(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}
__device__ __forceinline__ float t_max(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// vecmath `dot` as torch sums the last axis of 3 on the card.
__device__ __forceinline__ float dot3(float x0, float x1, float x2, float y0, float y1,
                                      float y2) {
  return __fadd_rn(__fadd_rn(__fmul_rn(x0, y0), __fmul_rn(x2, y2)), __fmul_rn(x1, y1));
}

struct Best {
  float t, u, v;
  int tri;
};

// `ray_aabb_t` and the step's `box_tmin < best_t`: box [lo3, hi3].
__device__ __forceinline__ bool box_hit(const float* __restrict__ row, const float o[3],
                                        const float d[3], float best_t) {
  bool ok_parallel = true;
  float tmin = -kInf, tmax = kInf;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float lo = __ldg(row + a), hi = __ldg(row + 3 + a);
    const bool par = fabsf(d[a]) < kEpsilon;
    ok_parallel = ok_parallel && (!par || (o[a] >= lo && o[a] <= hi));
    const float sd = par ? 1.f : d[a];
    const float t1 = __fdiv_rn(__fsub_rn(lo, o[a]), sd);
    const float t2 = __fdiv_rn(__fsub_rn(hi, o[a]), sd);
    const float tn = par ? -kInf : t_min(t1, t2);
    const float tf = par ? kInf : t_max(t1, t2);
    tmin = a == 0 ? tn : t_max(tmin, tn);
    tmax = a == 0 ? tf : t_min(tmax, tf);
  }
  return ok_parallel && tmax >= t_max(tmin, 0.f) && tmin < best_t;
}

// `ray_triangle` on one slot [p0, p1, p2]; a usable hit nearer than the
// leaf's best so far replaces it (a strict <: the first minimum stays).
__device__ __forceinline__ void triangle(const float* __restrict__ tp, const float o[3],
                                         const float d[3], int tri, Best& leaf) {
  float p0[3], e1[3], e2[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    p0[a] = __ldg(tp + a);
    e1[a] = __fsub_rn(__ldg(tp + 3 + a), p0[a]);
    e2[a] = __fsub_rn(__ldg(tp + 6 + a), p0[a]);
  }
  // h = cross(rd, edge2)
  const float h0 = __fsub_rn(__fmul_rn(d[1], e2[2]), __fmul_rn(d[2], e2[1]));
  const float h1 = __fsub_rn(__fmul_rn(d[2], e2[0]), __fmul_rn(d[0], e2[2]));
  const float h2 = __fsub_rn(__fmul_rn(d[0], e2[1]), __fmul_rn(d[1], e2[0]));
  const float det = dot3(e1[0], e1[1], e1[2], h0, h1, h2);
  const float f = __fdiv_rn(1.f, det);
  const float s0 = __fsub_rn(o[0], p0[0]), s1 = __fsub_rn(o[1], p0[1]),
              s2 = __fsub_rn(o[2], p0[2]);
  const float u = __fmul_rn(f, dot3(s0, s1, s2, h0, h1, h2));
  // q = cross(s, edge1)
  const float q0 = __fsub_rn(__fmul_rn(s1, e1[2]), __fmul_rn(s2, e1[1]));
  const float q1 = __fsub_rn(__fmul_rn(s2, e1[0]), __fmul_rn(s0, e1[2]));
  const float q2 = __fsub_rn(__fmul_rn(s0, e1[1]), __fmul_rn(s1, e1[0]));
  const float v = __fmul_rn(f, dot3(d[0], d[1], d[2], q0, q1, q2));
  const float t = __fmul_rn(f, dot3(e2[0], e2[1], e2[2], q0, q1, q2));
  const bool valid = fabsf(det) >= kEpsilon && u >= 0.f && u <= 1.f && v >= 0.f &&
                     __fadd_rn(u, v) <= 1.f && t > kEpsilon;
  if (valid && t < leaf.t) leaf = Best{t, u, v, tri};
}

__global__ void __launch_bounds__(kThreads)
    fat_walk_kernel(const float* __restrict__ fat, const float* __restrict__ ro,
                    const float* __restrict__ rd, int k, int width, int max_leaf, int n,
                    float* __restrict__ t_out, int* __restrict__ tri_out,
                    float* __restrict__ u_out, float* __restrict__ v_out,
                    bool* __restrict__ hit_out, int* __restrict__ stats) {
  const int ray = blockIdx.x * kThreads + threadIdx.x;
  int visits = 0;
  if (ray < n) {
    float o[3], d[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      o[a] = __ldg(ro + 3 * static_cast<size_t>(ray) + a);
      d[a] = __ldg(rd + 3 * static_cast<size_t>(ray) + a);
    }
    Best best{kInf, 0.f, 0.f, -1};
    // A link at or past k (the padded end sentinel included) ends the walk.
    for (unsigned p = 0; p < static_cast<unsigned>(k);) {
      ++visits;
      const float* __restrict__ row = fat + static_cast<size_t>(p) * width;
      const int* __restrict__ links = reinterpret_cast<const int*>(row + 6);
      const int miss = __ldg(links), count = __ldg(links + 2);
      const bool entered = box_hit(row, o, d, best.t);
      if (entered && count > 0) {
        const int start = __ldg(links + 1), slots = min(count, max_leaf);
        Best leaf{kInf, 0.f, 0.f, -1};
        for (int j = 0; j < slots; ++j) triangle(row + 9 + 9 * j, o, d, start + j, leaf);
        if (leaf.t < best.t) best = leaf;
      }
      p = entered && count <= 0 ? p + 1 : static_cast<unsigned>(miss);
    }
    t_out[ray] = best.t;
    tri_out[ray] = best.tri;
    u_out[ray] = best.u;
    v_out[ray] = best.v;
    hit_out[ray] = best.tri >= 0;
  }
  if (stats != nullptr) {  // every lane of the warp takes part; rays past n count 0
    const unsigned all = 0xffffffffu;
    const int rays = __popc(__ballot_sync(all, ray < n));
    const int nodes = __reduce_add_sync(all, visits);
    const int depth = __reduce_max_sync(all, visits);
    if ((threadIdx.x & 31) == 0 && rays > 0) {
      atomicAdd(stats, nodes);
      atomicMax(stats + 1, depth);
      atomicAdd(stats + 2, rays * depth);
    }
  }
}

}  // namespace

// fat: (k, width) f32 rows, width = 9 + 9 * max_leaf, link columns 6-8 int32
// bit patterns [miss, tri_start, count]; ro, rd: (n, 3) f32.  Writes t, tri,
// u, v (n,) and hit (n,) bool, the nearest hit of each ray (t = 1e20, tri =
// -1, u = v = 0 on a miss); with `stats` (3,) i32, adds the walk's counts to
// it.  k >= 1.  Returns a CUDA error code.
extern "C" int tpt_fat_walk(const float* fat, const float* ro, const float* rd, float* t,
                            int* tri, float* u, float* v, bool* hit, int* stats, int k,
                            int width, int max_leaf, int n, cudaStream_t stream) {
  if (k < 1 || max_leaf < 1 || width != 9 + 9 * max_leaf || n < 0)
    return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  fat_walk_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      fat, ro, rd, k, width, max_leaf, n, t, tri, u, v, hit, stats);
  return cudaGetLastError();
}
