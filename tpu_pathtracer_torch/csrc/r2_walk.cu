// Round-2 Möller–Trumbore walk with one level of chunk culling, for Hopper
// (sm_90a): the whole scene, up to 131,072 triangles.
//
// Replaces both TPU kernels of tpu_pathtracer/ops/pallas/mt_intersect.py:
// `_kernel` (behind `mt_intersect_pallas`, up to 8,192 triangles, the
// coefficients in VMEM) and `_kernel_stream` (behind `mt_intersect_stream`,
// up to 131,072, each chunk copied from HBM by async DMA).  On the H100
// that split does not exist (the 131,072-triangle table, 10.5 MB, stays in
// L2), so both wrappers (ops/kernels/mt_intersect.py) launch this one
// kernel on the same table, `_pack_walk_table`'s 20 floats a triangle in
// triangle order.  The wrapper pads triangles to a multiple of the chunk C
// (8..128 in steps of 8) and rays to a multiple of 1,024 (1e30 in all ten
// features), and builds one box per chunk; this file walks them.
//
// What it computes is the JAX kernels' walk: per 1,024-ray tile, chunk c in
// ascending order is evaluated iff some lane of the tile (padding lanes
// too; every lane starts at t = INF) enters box c before its current t,
// and then every lane evaluates the whole chunk.  The epilogue is round
// 2's (mt_common.cuh `take_pair_r2`: the divided t > EPSILON, u = ua*f +
// 0); a chunk's lowest row among its smallest t wins it, and it replaces
// the best only if strictly nearer.  The block writes its walk counts
// (chunks evaluated, chunks copied into shared memory) on request; the
// plain version reproduces both.
//
// What bounds it on the H100.  A tile's walk is a serial chain of
// decisions and the kernel ends when its heaviest tile does.  One
// 512-thread block a tile would run all of a heavy tile's chunks on one
// SM, pay a `__syncthreads_or` of a fresh slab test for every chunk, dead
// or live, and read the coefficients as 4-byte shared broadcasts.  This
// design is the cond walk (cond_walk.cu) without its sub level:
//   a. the packed table (a 128-triangle chunk is 10 KB), read as five
//      128-bit broadcasts a triangle;
//   b. double-buffered staging: the next candidate chunk is bulk-copied
//      (TMA `cp.async.bulk` on an mbarrier, walk.cuh `Stager`) into the
//      idle buffer while the current one is evaluated;
//   c. decisions by mask: chunks are taken kGroup at a time; their entries
//      do not depend on t, so each thread computes its ray's entries once
//      into shared memory, and one decision ORs a mask of "some ray enters
//      chunk k before its current t" over the group's chunks not yet
//      passed; the walk jumps to the lowest set bit.  t changes only when
//      a chunk is evaluated, and the mask is formed again after each, so
//      the walk reaches exactly the chunks the one-at-a-time tests reach,
//      and a dead chunk costs no barrier;
//   d. the tile's rays are split over a cluster of C CTAs; every decision
//      goes through distributed shared memory and one cluster barrier
//      (walk.cuh `decide`);
//   e. each ray's triangles are split over TPR lanes, combined by
//      (t, index); each mask bit's slab test and re-tests are made by one
//      lane of the ray.
// The copy rule that follows (the plain version's walk counts): an
// evaluated chunk is copied unless it was the prefetch, and after a chunk
// is taken the lowest chunk of the group still in the mask (as it stood
// before that chunk's evaluation) is prefetched.
// C and TPR were chosen by a sweep of clusters of 2-16 CTAs and 1-4 lanes
// a ray (PERF.md keeps its table).  The per-pair
// arithmetic and the slab test are the plain version's (-fmad=false,
// `_FEATS` order, __frcp_rn, `_slab_entries`' order), so hits and walk
// counts equal it.

#include "walk.cuh"

namespace {

using tpt::Best;
using namespace tpt::walk;

constexpr int kTile = 1024;     // rays a tile
constexpr int kMaxChunk = 128;  // triangles a chunk, at most
constexpr int kGroup = 32;      // chunks decided together (32 mask bits)
constexpr int kBytes = kMaxChunk * kTableFloats * 4;  // 10 KB

// The design the sweep kept (PERF.md): cluster size, lanes a ray.
constexpr int kCluster = 8;
constexpr int kTpr = 2;
constexpr int kLanes = kTile / kCluster * kTpr;  // threads: every lane a ray of the tile
static_assert(kLanes % 32 == 0 && kLanes <= kThreads, "whole warps, one CTA");
constexpr size_t kEntryBytes = sizeof(float) * kGroup * kLanes;

__global__ void __launch_bounds__(kThreads)
    r2_walk_kernel(const float* __restrict__ phi_t,  // (10, r_pad)
                   const float4* __restrict__ table,  // (n_pad, 20) as float4
                   const float4* __restrict__ boxes,  // (n_chunks, 8) as float4
                   float* __restrict__ out_t, int* __restrict__ out_idx,
                   float* __restrict__ out_u, float* __restrict__ out_v,
                   int* __restrict__ walk_stats,  // (n_tiles, 2) or null
                   int r_pad, int n_chunks, int chunk) {
  constexpr int C = kCluster, TPR = kTpr;
  __shared__ __align__(128) float4 buf[2][kBytes / 16];
  __shared__ Vote slots[2][C * kThreads / 32];
  __shared__ __align__(8) uint64_t bars[2];
  // this thread's ray's entry distances into the group's chunks,
  // [kGroup][kLanes]
  extern __shared__ float entry[];

  const int tile = blockIdx.x / C, rank = blockIdx.x % C;
  const int ray = tile * kTile + rank * (kTile / C) + static_cast<int>(threadIdx.x) / TPR;
  float phi[1][10];
  float inv[3];
  Best best[1];
  best[0] = tpt::load_ray(phi_t, r_pad, ray, 0, phi[0], false);  // every lane at INF
  tpt::slab_inv(phi[0], inv);
  // With TPR lanes a ray, the slab test and re-tests of mask bit b are made
  // by the ray's lane b % TPR alone (`own`); the decisions OR the lanes'
  // bits.
  const uint32_t own =
      TPR == 1 ? 0xffffffffu : (0xffffffffu / ((1u << TPR) - 1u)) << (threadIdx.x % TPR);
  float* mine = entry + threadIdx.x;  // row k at mine[k * kLanes]
  const float kNone = -CUDART_INF_F;  // no decision here needs the tile's max t

  int parity = 0, evaluated = 0;
  Stager<kBytes> st;
  st.init(buf[0], buf[1], bars, static_cast<uint32_t>(chunk * kTableFloats * 4));
  cluster_sync<C>();
  for (int g = 0; g < n_chunks; g += kGroup) {
    const int n_in = min(kGroup, n_chunks - g);
    uint32_t bits = 0;
    // lane p of a ray tests boxes p, p + TPR, ...: the lanes of a warp run
    // the same iterations, each on its own box
#pragma unroll 4  // the boxes' loads in flight together
    for (int j = 0; j < kGroup / TPR; ++j) {
      const int k = j * TPR + static_cast<int>(threadIdx.x % TPR);
      if (k < n_in) {
        const float4 b0 = __ldg(boxes + 2 * (g + k)), b1 = __ldg(boxes + 2 * (g + k) + 1);
        const float box[6] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y};
        const float e = tpt::slab_entry(box, phi[0], inv);
        mine[k * kLanes] = e;
        bits |= static_cast<uint32_t>(e < best[0].t) << k;
      }
    }
    uint32_t chunks = decide<C>(slots, parity, bits, kNone).bits;  // live chunks ahead
    while (chunks) {
      const int k = __ffs(chunks) - 1;
      chunks &= chunks - 1;
      const int c = g + k;
      const float4* rows = st.take(table, c);
      if (chunks) st.prefetch(table, g + __ffs(chunks) - 1);
      ++evaluated;
      eval_table<kMaxChunk, 1, TPR, tpt::PairR2>(rows, phi, c * chunk, best, chunk);
      // the chunks ahead that some ray still enters before its new t
      uint32_t live = 0;
      for (uint32_t m = chunks & own; m; m &= m - 1) {
        const int b = __ffs(m) - 1;
        live |= static_cast<uint32_t>(mine[b * kLanes] < best[0].t) << b;
      }
      chunks = decide<C>(slots, parity, live, kNone).bits;
    }
  }
  st.drain();
  cluster_sync<C>();
  if (walk_stats != nullptr && rank == 0 && threadIdx.x == 0) {
    walk_stats[tile * 2 + 0] = evaluated;
    walk_stats[tile * 2 + 1] = st.copies;
  }
  if (threadIdx.x % TPR == 0) {
    out_t[ray] = best[0].t;
    out_idx[ray] = best[0].idx;
    out_u[ray] = best[0].u;
    out_v[ray] = best[0].v;
  }
}

}  // namespace

// The walk; a CUDA error code.
extern "C" int tpt_mt_r2_walk(const float* phi_t, const float* table, const float* boxes,
                              float* t, int* idx, float* u, float* v, int* walk_stats,
                              int r_pad, int n_chunks, int chunk, cudaStream_t stream) {
  if (r_pad <= 0 || r_pad % kTile || n_chunks <= 0 || chunk <= 0 || chunk > kMaxChunk ||
      chunk % 8 || reinterpret_cast<uintptr_t>(table) % 16 ||
      reinterpret_cast<uintptr_t>(boxes) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_cluster(r2_walk_kernel, r_pad / kTile, kCluster, kCluster, kLanes, kEntryBytes,
                        stream, phi_t, reinterpret_cast<const float4*>(table),
                        reinterpret_cast<const float4*>(boxes), t, idx, u, v, walk_stats,
                        r_pad, n_chunks, chunk);
}

// The launch shape (walk.cuh `describe`: rpt, cluster, threads,
// registers, static and dynamic shared bytes, CTAs per SM, clusters
// resident at once, lanes a ray).
extern "C" int tpt_mt_r2_walk_shape(int* out) {
  return describe(reinterpret_cast<const void*>(r2_walk_kernel), Shape{1, kCluster, kTpr},
                  kLanes, kEntryBytes, out);
}
