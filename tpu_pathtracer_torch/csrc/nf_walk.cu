// Near-to-far Möller–Trumbore walk over per-tile live sub-treelets, for
// Hopper (sm_90a): the default ('nf') whole-scene kernel, up to 8,192
// triangles, and the same walk without its bound ('list').
//
// Replaces the TPU kernels `_kernel_nf` (tpu_pathtracer/ops/pallas/
// mt_shade.py:308) and `_kernel_list` (:255).  The Python wrapper
// (ops/kernels/mt_shade.py) pads the inputs, preculls each ray tile's live
// subs (sorted by entry distance) and packs the walk table
// (`_pack_walk_table`); this file walks the lists.  nf: per tile, entry j
// is evaluated while its entry distance is below the tile's largest live
// t, refreshed after every sub; parked, padding and past-the-tile lanes
// start at -INF.  list: every entry in list order, no bound, no break,
// every lane from t = INF.
//
// What bounds it on the H100.  The walk is one serial chain per tile
// (stage a sub, evaluate it, take the tile's max t), and the kernel ends
// when its heaviest tile does: the light tiles finish early and the
// heaviest walks alone on its SM.  One 512-thread block a tile, one ray
// a thread, reading 19 coefficients a pair as 4-byte shared broadcasts
// would be paced by shared loads, not arithmetic, and would stage each sub
// with a blocking copy between two barriers.  This design:
//   a. one ray a thread against a packed table of 20 floats a triangle,
//      read as five 128-bit broadcasts;
//   b. double-buffered staging: the next listed sub is bulk-copied (TMA,
//      `cp.async.bulk` on an mbarrier) into the idle buffer while the
//      current one is evaluated (nf: when its entry distance is still
//      below the bound; a prefetch the break makes useless is waited on
//      and dropped; list: always);
//   d. the tile's rays are split over C CTAs; nf's max of t after each sub
//      goes through distributed shared memory and one cluster barrier
//      (walk.cuh `decide`), so the walk's decisions stay the tile's and its
//      per-tile walk count equals the plain version's.  list decides
//      nothing, so its C CTAs need no cluster: each walks the whole list
//      for its slice of the rays, with one block barrier a sub before the
//      buffer just read is refilled;
//   e. each ray's triangles are split over TPR lanes, whose nearest hits
//      are combined by (t, index) with warp shuffles: spreading rays alone
//      leaves one lane walking all SUB triangles of a sub in series.
// (Step c, decisions by mask, concerns the streamed and cond walks.)
// Measured on the H100 (PERF.md): every decision across a
// cluster costs a cluster barrier, so clusters pay only with e; more rays
// a thread does not pay.  A tile with an empty list skips the walk and its
// barriers.  The per-pair arithmetic is unchanged (-fmad=false, `_FEATS`
// order, __frcp_rn), so hits are bit-equal to the plain version.
//
// `tpt_mt_nf` and `tpt_mt_list` run the designs the sweeps kept (kRpt,
// kCluster, kTpr and kList* below); wider tiles fall back to other shapes
// (walk.cuh `fit_shape`).

#include "walk.cuh"

namespace {

using tpt::Best;
using tpt::kInf;
using namespace tpt::walk;

// The designs the sweeps kept (PERF.md): rays a thread, cluster size
// (for list: CTAs a tile, a plain grid, since list decides nothing and a
// cluster does no better), lanes a ray.
constexpr int kRpt = 1;
constexpr int kCluster = 8;
constexpr int kTpr = 2;
constexpr int kListCluster = 8;
constexpr int kListTpr = 2;

// NF: the near-to-far walk; else the list walk (`emins` unused).
template <int SUB, int RPT, int C, int TPR, bool NF>
__global__ void __launch_bounds__(kThreads)
    nf_walk_kernel(const float* __restrict__ phi_t,   // (10, r_pad)
                   const float4* __restrict__ table,  // (n_pad, 20) as float4
                   const int* __restrict__ counts,    // (n_tiles,)
                   const int* __restrict__ lists,     // (n_tiles, ms)
                   const float* __restrict__ emins,   // (n_tiles, ms)
                   float* __restrict__ out_t, int* __restrict__ out_idx,
                   float* __restrict__ out_u, float* __restrict__ out_v,
                   int* __restrict__ walk_stats,  // (n_tiles,) or null
                   int r_pad, int tile_rays, int ms) {
  constexpr int kBytes = SUB * kTableFloats * 4;
  __shared__ __align__(128) float4 buf[2][kBytes / 16];
  __shared__ Vote slots[2][kMaxSlots];
  __shared__ __align__(8) uint64_t bars[2];

  const int tile = blockIdx.x / C, rank = blockIdx.x % C;
  const int per_cta = (tile_rays + C - 1) / C;
  const int ray0 = tile * tile_rays;
  const int group = blockDim.x / TPR;  // rays a CTA holds in each of its RPT slots

  float phi[RPT][10];
  Best best[RPT];
  int ray[RPT];
#pragma unroll
  for (int k = 0; k < RPT; ++k) {
    const int lane = threadIdx.x / TPR + k * group;
    const int local = rank * per_cta + lane;
    ray[k] = lane < per_cta && local < tile_rays ? ray0 + local : -1;
    best[k] = tpt::load_ray(phi_t, r_pad, ray[k], ray0, phi[k], NF);
  }
  int walked = 0;
  const int count = counts[tile];  // the same in every CTA of the cluster
  if (count > 0) {  // a tile with an empty list only writes its lanes
    Stager<kBytes> st;
    st.init(buf[0], buf[1], bars);
    if constexpr (NF) cluster_sync<C>();
    int parity = 0;
    const int* list = lists + static_cast<size_t>(tile) * ms;
    const float* emin = NF ? emins + static_cast<size_t>(tile) * ms : nullptr;
    float tmax = kInf;
    for (int j = 0; j < count; ++j) {
      if constexpr (NF)
        if (!(emin[j] < tmax)) break;
      const int s = list[j];
      const float4* rows = st.take(table, s);
      if (j + 1 < count && (!NF || emin[j + 1] < tmax)) st.prefetch(table, list[j + 1]);
      eval_table<SUB, RPT, TPR>(rows, phi, s * SUB, best);
      if constexpr (NF)
        tmax = decide<C>(slots, parity, 0u, rays_max<RPT>(best, ray)).tmax;
      else
        __syncthreads();  // every thread is done with this buffer before it is refilled
      ++walked;
    }
    st.drain();
    if constexpr (NF) cluster_sync<C>();
  }
  if (walk_stats != nullptr && rank == 0 && threadIdx.x == 0) walk_stats[tile] = walked;

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

template <int SUB>
using Kernel = decltype(&nf_walk_kernel<SUB, kRpt, kCluster, kTpr, true>);

// nf's CTAs of a tile form a cluster; list's a plain grid.
template <int SUB, bool NF>
int launch(Kernel<SUB> kernel, const Shape& shape, const Args& a) {
  const int threads = threads_for(a.tile_rays, shape);
  if (kernel == nullptr || threads == 0) return static_cast<int>(cudaErrorInvalidValue);
  return launch_cluster(kernel, a.n_tiles, shape.c, NF ? shape.c : 1, threads, 0,
                        a.stream, a.phi_t, a.table, a.counts, a.lists, a.emins, a.t, a.idx, a.u,
                        a.v, a.walk_stats, a.r_pad, a.tile_rays, a.ms);
}

// The kept design at this tile width (walk.cuh `fit_shape`): its kernel
// and shape; null if the tile is too wide.
template <int SUB, bool NF>
Kernel<SUB> kept(int tile_rays, Shape& shape) {
  const Shape k = NF ? Shape{kRpt, kCluster, kTpr} : Shape{kRpt, kListCluster, kListTpr};
  shape = k;
  if (!fit_shape(tile_rays, shape)) return nullptr;
  if (shape == k) {
    if constexpr (NF) return nf_walk_kernel<SUB, kRpt, kCluster, kTpr, true>;
    return nf_walk_kernel<SUB, kRpt, kListCluster, kListTpr, false>;
  }
  if (shape == Shape{k.rpt, kMaxCluster, k.tpr}) {
    if constexpr (NF) return nf_walk_kernel<SUB, kRpt, kMaxCluster, kTpr, true>;
    return nf_walk_kernel<SUB, kRpt, kMaxCluster, kListTpr, false>;
  }
  if (shape.rpt == 1) return nf_walk_kernel<SUB, 1, kMaxCluster, 1, NF>;
  if (shape.rpt == 2) return nf_walk_kernel<SUB, 2, kMaxCluster, 1, NF>;
  return nf_walk_kernel<SUB, 4, kMaxCluster, 1, NF>;
}

template <typename F>
int by_sub(int sub, F&& f) {
  switch (sub) {
    case 8: return f(Int<8>{});
    case 16: return f(Int<16>{});
    case 32: return f(Int<32>{});
    case 64: return f(Int<64>{});
    case 128: return f(Int<128>{});
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

bool valid(const Args& a) {
  return a.tile_rays > 0 && a.n_tiles > 0 && a.ms > 0 && a.r_pad == a.n_tiles * a.tile_rays &&
         reinterpret_cast<uintptr_t>(a.table) % 16 == 0;
}

template <bool NF>
int run(const Args& a, int sub) {
  if (!valid(a)) return static_cast<int>(cudaErrorInvalidValue);
  return by_sub(sub, [&](auto s) {
    constexpr int SUB = decltype(s)::value;
    Shape shape;
    const Kernel<SUB> kernel = kept<SUB, NF>(a.tile_rays, shape);
    return launch<SUB, NF>(kernel, shape, a);
  });
}

template <bool NF>
int shape_of(int sub, int tile_rays, int* out) {
  return by_sub(sub, [&](auto s) {
    constexpr int SUB = decltype(s)::value;
    Shape shape;
    const Kernel<SUB> kernel = kept<SUB, NF>(tile_rays, shape);
    if (kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    return describe(reinterpret_cast<const void*>(kernel), shape,
                    threads_for(tile_rays, shape), 0, out);
  });
}

}  // namespace

extern "C" int tpt_mt_nf(const float* phi_t, const float* table, const int* counts,
                         const int* lists, const float* emins, float* t, int* idx, float* u,
                         float* v, int* walk_stats, int r_pad, int tile_rays, int n_tiles,
                         int ms, int sub, cudaStream_t stream) {
  return run<true>(Args{phi_t, reinterpret_cast<const float4*>(table), counts, lists, emins, t,
                        idx, u, v, walk_stats, r_pad, tile_rays, n_tiles, ms, stream},
                   sub);
}

// The list walk: every listed sub of each tile in list order; walk_stats,
// if not null, receives each tile's count of evaluated subs (its list
// length).
extern "C" int tpt_mt_list(const float* phi_t, const float* table, const int* counts,
                           const int* lists, float* t, int* idx, float* u, float* v,
                           int* walk_stats, int r_pad, int tile_rays, int n_tiles, int ms,
                           int sub, cudaStream_t stream) {
  return run<false>(Args{phi_t, reinterpret_cast<const float4*>(table), counts, lists, nullptr,
                         t, idx, u, v, walk_stats, r_pad, tile_rays, n_tiles, ms, stream},
                    sub);
}

// The kept designs' launch shapes at this sub and tile width (walk.cuh
// `describe`: rpt, cluster, threads, registers, static and dynamic shared
// bytes, CTAs per SM, clusters resident at once, lanes a ray).
extern "C" int tpt_mt_nf_shape(int sub, int tile_rays, int* out) {
  return shape_of<true>(sub, tile_rays, out);
}

extern "C" int tpt_mt_list_shape(int sub, int tile_rays, int* out) {
  return shape_of<false>(sub, tile_rays, out);
}
