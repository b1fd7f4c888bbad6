// Streamed two-level-culled Möller–Trumbore walk for large scenes
// (8K-256K triangles), for Hopper (sm_90a).
//
// Replaces the TPU kernel `_kernel_stream2` (tpu_pathtracer/ops/pallas/
// mt_shade.py:628).  The Python wrapper (ops/kernels/mt_stream.py) pads
// the inputs, builds the super, chunk and sub boxes and each ray tile's
// near-to-far list of live super-treelets (2,048 triangles = 16 chunks of
// 128 = 64 subs of 32), and packs the walk table (`_pack_walk_table`);
// this file walks them.  Per tile and listed super, while its entry
// distance is below the tile's largest live t (refreshed once per super):
// chunk k in index order is evaluated if some ray of the tile enters its
// box before its current t, and inside a live chunk sub s likewise,
// against t as it stands at that moment.  The block writes its walk
// counts (supers walked, chunks staged, subs evaluated) on request; they
// equal the plain version's.
//
// What bounds it on the H100.  One tile's walk is a serial chain of
// decisions, and the kernel ends when its heaviest tile does (on the
// stress scene one tile evaluates 241 subs where the mean is 4): the
// light tiles finish early and the heaviest walks alone on its SM.  One
// 512-thread block a tile, one ray a thread, would pay a
// `__syncthreads_or` for each of a walked super's 16 chunk tests and each
// sub test, stage a live chunk with a blocking 20 KB copy, and read 19
// coefficients a pair as 4-byte shared broadcasts.  This design:
//   a. one ray a thread against a packed table of 20 floats a triangle
//      (a chunk is 10 KB), read as five 128-bit broadcasts;
//   b. double-buffered staging: the next candidate chunk is bulk-copied
//      (TMA `cp.async.bulk` on an mbarrier) into the idle buffer while the
//      current one is evaluated; a prefetch a later test makes useless is
//      waited on and dropped;
//   c. decisions by mask: the 16 chunk entries of a walked super (and the
//      4 sub entries of a live chunk) do not depend on t, so each thread
//      computes its rays' entries once into shared memory; one decision
//      then ORs a 16-bit mask of "some ray enters chunk k before its
//      current t" over the chunks not yet passed (and a 4-bit one over the
//      chunk's subs), and the walk jumps to the lowest set bit.  t changes
//      only when a sub is evaluated, so re-forming both masks after each
//      evaluated sub reaches exactly the blocks the one-at-a-time tests
//      reach: a dead chunk costs no barrier;
//   d. the tile's rays are split over a cluster of C CTAs on neighbouring
//      SMs; every decision (both masks, the max of t) goes through
//      distributed shared memory and one cluster barrier (walk.cuh
//      `decide`), so the decisions stay the tile's;
//   e. each ray's triangles are split over TPR lanes, combined by
//      (t, index) with warp shuffles, and each mask bit's slab test and
//      re-tests are made by one lane of the ray: spreading rays alone
//      leaves one lane walking the 32 triangles of every sub in series.
// Measured on the H100 (PERF.md): every decision across a
// cluster costs a cluster barrier, so clusters pay only with e; more rays
// a thread does not pay.  A tile with an empty list skips the walk and its
// barriers.
// The per-pair arithmetic and the slab test are unchanged (-fmad=false,
// `_FEATS` order, __frcp_rn, `_slab_entries`' order), so hits and walk
// counts equal the plain version's.
//
// `tpt_mt_stream` runs the design the sweep kept (kRpt, kCluster, kTpr
// below); wider tiles fall back to other shapes (walk.cuh `fit_shape`).

#include "walk.cuh"

namespace {

using tpt::Best;
using tpt::kInf;
using namespace tpt::walk;

constexpr int kSub = 32;          // triangles per sub-treelet
constexpr int kSubsPerChunk = 4;  // 128-triangle chunk
constexpr int kChunksPerSuper = 16;
constexpr int kEntryRows = kChunksPerSuper + kSubsPerChunk;

// The design the sweep kept (PERF.md): rays a thread, cluster size,
// lanes a ray.
constexpr int kRpt = 1;
constexpr int kCluster = 8;
constexpr int kTpr = 2;

template <int RPT, int C, int TPR>
__global__ void __launch_bounds__(kThreads)
    stream_walk_kernel(const float* __restrict__ phi_t,        // (10, r_pad)
                       const float4* __restrict__ table,       // (n_pad, 20) as float4
                       const float* __restrict__ chunk_boxes,  // (n_chunks, 8)
                       const float* __restrict__ sub_boxes,    // (4*n_chunks, 8)
                       const int* __restrict__ counts,         // (n_tiles,)
                       const int* __restrict__ lists,          // (n_tiles, ms)
                       const float* __restrict__ emins,        // (n_tiles, ms)
                       float* __restrict__ out_t, int* __restrict__ out_idx,
                       float* __restrict__ out_u, float* __restrict__ out_v,
                       int* __restrict__ walk_stats,  // (n_tiles, 3) or null
                       int r_pad, int tile_rays, int ms) {
  constexpr int kBytes = kSubsPerChunk * kSub * kTableFloats * 4;  // 10 KB
  constexpr int kSubVecs = kSub * kTableVecs;
  __shared__ __align__(128) float4 buf[2][kBytes / 16];
  __shared__ Vote slots[2][kMaxSlots];
  __shared__ __align__(8) uint64_t bars[2];
  // this CTA's rays' entry distances, [kEntryRows][lanes]: rows 0-15 the
  // walked super's chunks, rows 16-19 the current chunk's subs
  extern __shared__ float entry[];

  const int tile = blockIdx.x / C, rank = blockIdx.x % C;
  const int per_cta = (tile_rays + C - 1) / C;
  const int ray0 = tile * tile_rays;
  const int lanes = blockDim.x * RPT;
  const int group = blockDim.x / TPR;  // rays a CTA holds in each of its RPT slots

  float phi[RPT][10];
  float inv[RPT][3];
  Best best[RPT];
  int ray[RPT];
#pragma unroll
  for (int k = 0; k < RPT; ++k) {
    const int lane = threadIdx.x / TPR + k * group;
    const int local = rank * per_cta + lane;
    ray[k] = lane < per_cta && local < tile_rays ? ray0 + local : -1;
    best[k] = tpt::load_ray(phi_t, r_pad, ray[k], ray0, phi[k]);
    tpt::slab_inv(phi[k], inv[k]);
  }
  // With TPR lanes a ray, the slab tests and re-tests of block b are made
  // by the ray's lane b % TPR alone (`own`); the decisions OR the lanes'
  // bits.
  const uint32_t own =
      TPR == 1 ? 0xffffffffu : (0xffffffffu / ((1u << TPR) - 1u)) << (threadIdx.x % TPR);
  // Entry distances of this thread's rays to `box`, stored in `row`; the
  // bit: some ray enters before its current t.
  auto enters = [&](const float* box, int row) {
    bool live = false;
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      const float e = tpt::slab_entry(box, phi[r], inv[r]);
      entry[row * lanes + threadIdx.x + r * blockDim.x] = e;
      live |= ray[r] >= 0 && e < best[r].t;
    }
    return live;
  };
  // The bits of `mask` (entry rows row0 + bit) that some ray of this
  // thread still enters before its current t.
  auto retest = [&](uint32_t mask, int row0) {
    uint32_t out = 0;
    for (uint32_t m = mask & own; m; m &= m - 1) {
      const int b = __ffs(m) - 1;
      bool live = false;
#pragma unroll
      for (int r = 0; r < RPT; ++r)
        live |= ray[r] >= 0 &&
                entry[(row0 + b) * lanes + threadIdx.x + r * blockDim.x] < best[r].t;
      out |= static_cast<uint32_t>(live) << b;
    }
    return out;
  };

  int parity = 0, walked = 0, staged = 0, evaluated = 0;
  const int count = counts[tile];  // the same in every CTA of the cluster
  const int* list = lists + static_cast<size_t>(tile) * ms;
  const float* emin = emins + static_cast<size_t>(tile) * ms;
  float tmax = kInf;
  Stager<kBytes> st;
  if (count > 0) {  // a tile with an empty list only writes its lanes
    st.init(buf[0], buf[1], bars);
    cluster_sync<C>();
  }
  for (int j = 0; j < count; ++j) {
    if (!(emin[j] < tmax)) break;
    ++walked;
    const int first = list[j] * kChunksPerSuper;  // the super's first chunk
    uint32_t bits = 0;
#pragma unroll  // the 16 boxes' loads in flight together
    for (int k = 0; k < kChunksPerSuper; ++k)
      if ((own >> k) & 1u)
        bits |= static_cast<uint32_t>(enters(chunk_boxes + (first + k) * 8, k)) << k;
    Decision d = decide<C>(slots, parity, bits, rays_max<RPT>(best, ray));
    uint32_t chunks = d.bits;  // live chunks after the current one
    while (chunks) {
      const int k = __ffs(chunks) - 1;
      chunks &= chunks - 1;
      ++staged;
      const int c = first + k;
      const float4* rows = st.take(table, c);
      if (chunks) st.prefetch(table, first + __ffs(chunks) - 1);
      uint32_t sb = 0;
#pragma unroll
      for (int s = 0; s < kSubsPerChunk; ++s)
        if ((own >> s) & 1u)
          sb |= static_cast<uint32_t>(
                    enters(sub_boxes + (c * kSubsPerChunk + s) * 8, kChunksPerSuper + s))
                << s;
      d = decide<C>(slots, parity, sb << 16 | retest(chunks, 0), rays_max<RPT>(best, ray));
      uint32_t subs = d.bits >> 16;
      chunks = d.bits & 0xffffu;
      while (subs) {
        const int s = __ffs(subs) - 1;
        subs &= subs - 1;
        ++evaluated;
        eval_table<kSub, RPT, TPR>(rows + s * kSubVecs, phi, (c * kSubsPerChunk + s) * kSub, best);
        d = decide<C>(slots, parity, retest(subs, kChunksPerSuper) << 16 | retest(chunks, 0),
                      rays_max<RPT>(best, ray));
        subs = d.bits >> 16;
        chunks = d.bits & 0xffffu;
      }
    }
    tmax = d.tmax;  // taken after the super's last evaluation
  }
  if (count > 0) {
    st.drain();
    cluster_sync<C>();
  }
  if (walk_stats != nullptr && rank == 0 && threadIdx.x == 0) {
    walk_stats[tile * 3 + 0] = walked;
    walk_stats[tile * 3 + 1] = staged;
    walk_stats[tile * 3 + 2] = evaluated;
  }

  if (threadIdx.x % TPR == 0) {
#pragma unroll
    for (int k = 0; k < RPT; ++k) {
      if (ray[k] >= 0) {
        out_t[ray[k]] = best[k].t;
        out_idx[ray[k]] = best[k].idx;
        out_u[ray[k]] = best[k].u;
        out_v[ray[k]] = best[k].v;
      }
    }
  }
}

struct Args {
  const float* phi_t;
  const float4* table;
  const float* chunk_boxes;
  const float* sub_boxes;
  const int* counts;
  const int* lists;
  const float* emins;
  float* t;
  int* idx;
  float* u;
  float* v;
  int* walk_stats;
  int r_pad, tile_rays, n_tiles, ms;
  cudaStream_t stream;
};

using Kernel = decltype(&stream_walk_kernel<1, 1, 1>);

// Dynamic shared memory of the entry distances.
size_t entry_bytes(int threads, int rpt) { return sizeof(float) * kEntryRows * threads * rpt; }

int launch(Kernel kernel, const Shape& shape, const Args& a) {
  const int threads = threads_for(a.tile_rays, shape);
  if (kernel == nullptr || threads == 0) return static_cast<int>(cudaErrorInvalidValue);
  return launch_cluster(kernel, a.n_tiles, shape.c, shape.c, threads,
                        entry_bytes(threads, shape.rpt), a.stream, a.phi_t, a.table,
                        a.chunk_boxes, a.sub_boxes, a.counts, a.lists, a.emins, a.t, a.idx, a.u,
                        a.v, a.walk_stats, a.r_pad, a.tile_rays, a.ms);
}

// The kept design at this tile width (walk.cuh `fit_shape`): its kernel
// and shape; null if the tile is too wide.
Kernel kept(int tile_rays, Shape& shape) {
  shape = Shape{kRpt, kCluster, kTpr};
  if (!fit_shape(tile_rays, shape)) return nullptr;
  if (shape == Shape{kRpt, kCluster, kTpr}) return stream_walk_kernel<kRpt, kCluster, kTpr>;
  if (shape == Shape{kRpt, kMaxCluster, kTpr}) return stream_walk_kernel<kRpt, kMaxCluster, kTpr>;
  if (shape.rpt == 1) return stream_walk_kernel<1, kMaxCluster, 1>;
  if (shape.rpt == 2) return stream_walk_kernel<2, kMaxCluster, 1>;
  return stream_walk_kernel<4, kMaxCluster, 1>;
}

bool valid(const Args& a, int sub, int chunks_per_super) {
  return sub == kSub && chunks_per_super == kChunksPerSuper && a.tile_rays > 0 &&
         a.n_tiles > 0 && a.ms > 0 && a.r_pad == a.n_tiles * a.tile_rays &&
         reinterpret_cast<uintptr_t>(a.table) % 16 == 0;
}

}  // namespace

extern "C" int tpt_mt_stream(const float* phi_t, const float* table, const float* chunk_boxes,
                             const float* sub_boxes, const int* counts, const int* lists,
                             const float* emins, float* t, int* idx, float* u, float* v,
                             int* walk_stats, int r_pad, int tile_rays, int n_tiles, int ms,
                             int sub, int chunks_per_super, cudaStream_t stream) {
  const Args a{phi_t, reinterpret_cast<const float4*>(table), chunk_boxes, sub_boxes, counts,
               lists, emins, t, idx, u, v, walk_stats, r_pad, tile_rays, n_tiles, ms, stream};
  if (!valid(a, sub, chunks_per_super)) return static_cast<int>(cudaErrorInvalidValue);
  Shape shape;
  const Kernel kernel = kept(tile_rays, shape);
  return launch(kernel, shape, a);
}

// The kept design's launch shape at this tile width (walk.cuh `describe`).
extern "C" int tpt_mt_stream_shape(int tile_rays, int* out) {
  Shape shape;
  const Kernel kernel = kept(tile_rays, shape);
  if (kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const int threads = threads_for(tile_rays, shape);
  return describe(reinterpret_cast<const void*>(kernel), shape, threads,
                  entry_bytes(threads, shape.rpt), out);
}
