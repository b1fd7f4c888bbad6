// In-kernel two-level culling Möller–Trumbore walk ('cond'), for Hopper
// (sm_90a): whole scenes up to 8,192 triangles, no precull.
//
// Replaces the TPU kernel `_kernel` (tpu_pathtracer/ops/pallas/
// mt_shade.py:183).  The Python wrapper (ops/kernels/mt_shade.py) pads the
// inputs, builds the chunk boxes (128 triangles) and sub boxes (SUB
// triangles) and packs the walk table (`_pack_walk_table`); this file walks
// them.  Per tile: if some lane has a nonzero direction (the TPU's
// tile-alive gate; padding lanes, rd = 1e30, count as moving), chunk c =
// 0, 1, ... is evaluated if some ray of the tile enters its box before its
// current t, and inside a live chunk sub s likewise, against t as it
// stands at that moment (a 128-triangle sub is the chunk: the chunk test
// alone decides).  Every lane starts at t = INF.  The block writes its walk
// counts (chunks live, subs evaluated) on request; they equal the plain
// version's.
//
// What bounds it on the H100.  As in the streamed walk (stream_walk.cu),
// one tile's walk is a serial chain of decisions and the kernel ends when
// its heaviest tile does.  One 512-thread block a tile would pay a
// `__syncthreads_or` of a fresh slab test per ray for every chunk, live or
// dead, and another for every sub, stage a live chunk with a blocking
// 20 KB copy, and read 19 coefficients a pair as 4-byte shared broadcasts.
// This design is the streamed walk without the precull list:
//   a. one ray a thread against the packed table of 20 floats a triangle
//      (a chunk is 10 KB), read as five 128-bit broadcasts;
//   b. double-buffered staging: the next candidate chunk is bulk-copied
//      (TMA `cp.async.bulk` on an mbarrier, walk.cuh `Stager`) into the
//      idle buffer while the current one is evaluated;
//   c. decisions by mask: chunks are taken 16 at a time; their entries
//      (and a live chunk's sub entries) do not depend on t, so each thread
//      computes its rays' entries once into shared memory, and one decision
//      ORs a 16-bit mask of "some ray enters chunk k before its current t"
//      over the group's chunks not yet passed (and a mask over the chunk's
//      subs); the walk jumps to the lowest set bit.  t changes only when a
//      sub is evaluated, and both masks are formed again after each
//      evaluated sub, so the walk reaches exactly the blocks the
//      one-at-a-time tests reach, and a dead chunk costs no barrier;
//   d. the tile's rays are split over a cluster of C CTAs; every decision
//      goes through distributed shared memory and one cluster barrier
//      (walk.cuh `decide`);
//   e. each ray's triangles are split over TPR lanes, combined by
//      (t, index); each mask bit's slab test and re-tests are made by one
//      lane of the ray.
// C and TPR were chosen by a sweep of cluster sizes 1-8 and 1-4 lanes a
// ray (PERF.md): a cluster of 4 and one lane a ray, where the nf and
// streamed walks keep 8 and 2.
// The per-pair arithmetic and the slab test are unchanged (-fmad=false,
// `_FEATS` order, __frcp_rn, `_slab_entries`' order), so hits and walk
// counts equal the plain version's.

#include "walk.cuh"

namespace {

using tpt::Best;
using namespace tpt::walk;

constexpr int kChunk = 128;  // triangles a chunk
constexpr int kGroup = 16;   // chunks decided together (16 mask bits)

// The design the sweep kept (PERF.md): rays a thread, cluster size,
// lanes a ray.
constexpr int kRpt = 1;
constexpr int kCluster = 4;
constexpr int kTpr = 1;

template <int SUB>
constexpr int entry_rows() {  // the group's chunks, then a live chunk's subs
  return kGroup + (kChunk / SUB > 1 ? kChunk / SUB : 0);
}

template <int SUB, int RPT, int C, int TPR>
__global__ void __launch_bounds__(kThreads)
    cond_walk_kernel(const float* __restrict__ phi_t,        // (10, r_pad)
                     const float4* __restrict__ table,       // (n_pad, 20) as float4
                     const float* __restrict__ chunk_boxes,  // (n_chunks, 8)
                     const float* __restrict__ sub_boxes,    // (n_pad / SUB, 8)
                     float* __restrict__ out_t, int* __restrict__ out_idx,
                     float* __restrict__ out_u, float* __restrict__ out_v,
                     int* __restrict__ walk_stats,  // (n_tiles, 2) or null
                     int r_pad, int tile_rays, int n_chunks) {
  constexpr int kSubs = kChunk / SUB;  // subs a chunk
  constexpr int kBytes = kChunk * kTableFloats * 4;  // 10 KB
  constexpr int kSubVecs = SUB * kTableVecs;
  __shared__ __align__(128) float4 buf[2][kBytes / 16];
  __shared__ Vote slots[2][kMaxSlots];
  __shared__ __align__(8) uint64_t bars[2];
  // this CTA's rays' entry distances, [entry_rows][lanes]: rows 0-15 the
  // group's chunks, rows 16.. the current chunk's subs
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
  bool moving = false;
#pragma unroll
  for (int k = 0; k < RPT; ++k) {
    const int lane = threadIdx.x / TPR + k * group;
    const int local = rank * per_cta + lane;
    ray[k] = lane < per_cta && local < tile_rays ? ray0 + local : -1;
    best[k] = tpt::load_ray(phi_t, r_pad, ray[k], ray0, phi[k], false);
    tpt::slab_inv(phi[k], inv[k]);
    moving |= ray[k] >= 0 && (fabsf(phi[k][4]) > 0.f || fabsf(phi[k][5]) > 0.f ||
                              fabsf(phi[k][6]) > 0.f);
  }
  // With TPR lanes a ray, the slab tests and re-tests of mask bit b are
  // made by the ray's lane b % TPR alone (`own`); the decisions OR the
  // lanes' bits.
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
    return static_cast<uint32_t>(live);
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
  const float kNone = -CUDART_INF_F;  // no decision here needs the tile's max t

  int parity = 0, staged = 0, evaluated = 0;
  Stager<kBytes> st;
  st.init(buf[0], buf[1], bars);
  cluster_sync<C>();
  if (decide<C>(slots, parity, moving, kNone).bits) {  // the tile-alive gate
    for (int g = 0; g < n_chunks; g += kGroup) {
      const int n_in = min(kGroup, n_chunks - g);
      uint32_t bits = 0;
#pragma unroll  // the 16 boxes' loads in flight together
      for (int k = 0; k < kGroup; ++k)
        if (k < n_in && ((own >> k) & 1u)) bits |= enters(chunk_boxes + (g + k) * 8, k) << k;
      uint32_t chunks = decide<C>(slots, parity, bits, kNone).bits;  // live chunks ahead
      while (chunks) {
        const int k = __ffs(chunks) - 1;
        chunks &= chunks - 1;
        ++staged;
        const int c = g + k;
        const float4* rows = st.take(table, c);
        if (chunks) st.prefetch(table, g + __ffs(chunks) - 1);
        if constexpr (kSubs == 1) {
          ++evaluated;
          eval_table<SUB, RPT, TPR>(rows, phi, c * SUB, best);
          chunks = decide<C>(slots, parity, retest(chunks, 0), kNone).bits;
        } else {
          uint32_t sb = 0;
#pragma unroll
          for (int s = 0; s < kSubs; ++s)
            if ((own >> s) & 1u) sb |= enters(sub_boxes + (c * kSubs + s) * 8, kGroup + s) << s;
          // t has not changed since `chunks` was decided
          Decision d = decide<C>(slots, parity, sb << 16 | chunks, kNone);
          uint32_t subs = d.bits >> 16;
          chunks = d.bits & 0xffffu;
          while (subs) {
            const int s = __ffs(subs) - 1;
            subs &= subs - 1;
            ++evaluated;
            eval_table<SUB, RPT, TPR>(rows + s * kSubVecs, phi, (c * kSubs + s) * SUB, best);
            d = decide<C>(slots, parity, retest(subs, kGroup) << 16 | retest(chunks, 0), kNone);
            subs = d.bits >> 16;
            chunks = d.bits & 0xffffu;
          }
        }
      }
    }
  }
  st.drain();
  cluster_sync<C>();
  if (walk_stats != nullptr && rank == 0 && threadIdx.x == 0) {
    walk_stats[tile * 2 + 0] = staged;
    walk_stats[tile * 2 + 1] = evaluated;
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
  float* t;
  int* idx;
  float* u;
  float* v;
  int* walk_stats;
  int r_pad, tile_rays, n_tiles, n_chunks;
  cudaStream_t stream;
};

template <int SUB>
using Kernel = decltype(&cond_walk_kernel<SUB, 1, 1, 1>);

// Dynamic shared memory of the entry distances.
template <int SUB>
size_t entry_bytes(int threads, int rpt) {
  return sizeof(float) * entry_rows<SUB>() * threads * rpt;
}

// The kept design at this tile width (walk.cuh `fit_shape`): its kernel
// and shape; null if the tile is too wide.
template <int SUB>
Kernel<SUB> kept(int tile_rays, Shape& shape) {
  shape = Shape{kRpt, kCluster, kTpr};
  if (!fit_shape(tile_rays, shape)) return nullptr;
  if (shape == Shape{kRpt, kCluster, kTpr}) return cond_walk_kernel<SUB, kRpt, kCluster, kTpr>;
  if (shape.rpt == 1) return cond_walk_kernel<SUB, 1, kMaxCluster, 1>;
  if (shape.rpt == 2) return cond_walk_kernel<SUB, 2, kMaxCluster, 1>;
  return cond_walk_kernel<SUB, 4, kMaxCluster, 1>;
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

bool valid(const Args& a, int sub) {
  return a.tile_rays > 0 && a.n_tiles > 0 && a.n_chunks > 0 &&
         a.r_pad == a.n_tiles * a.tile_rays && reinterpret_cast<uintptr_t>(a.table) % 16 == 0 &&
         sub > 0 && kChunk % sub == 0;
}

}  // namespace

extern "C" int tpt_mt_cond(const float* phi_t, const float* table, const float* chunk_boxes,
                           const float* sub_boxes, float* t, int* idx, float* u, float* v,
                           int* walk_stats, int r_pad, int tile_rays, int n_tiles,
                           int n_chunks, int sub, cudaStream_t stream) {
  const Args a{phi_t, reinterpret_cast<const float4*>(table), chunk_boxes, sub_boxes, t, idx, u,
               v, walk_stats, r_pad, tile_rays, n_tiles, n_chunks, stream};
  if (!valid(a, sub)) return static_cast<int>(cudaErrorInvalidValue);
  return by_sub(sub, [&](auto s) {
    constexpr int SUB = decltype(s)::value;
    Shape shape;
    const Kernel<SUB> kernel = kept<SUB>(a.tile_rays, shape);
    const int threads = threads_for(a.tile_rays, shape);
    if (kernel == nullptr || threads == 0) return static_cast<int>(cudaErrorInvalidValue);
    return launch_cluster(kernel, a.n_tiles, shape.c, shape.c, threads,
                          entry_bytes<SUB>(threads, shape.rpt), a.stream, a.phi_t, a.table,
                          a.chunk_boxes, a.sub_boxes, a.t, a.idx, a.u, a.v, a.walk_stats,
                          a.r_pad, a.tile_rays, a.n_chunks);
  });
}

// The kept design's launch shape at this sub and tile width (walk.cuh
// `describe`: rpt, cluster, threads, registers, static and dynamic shared
// bytes, CTAs per SM, clusters resident at once, lanes a ray).
extern "C" int tpt_mt_cond_shape(int sub, int tile_rays, int* out) {
  return by_sub(sub, [&](auto s) {
    constexpr int SUB = decltype(s)::value;
    Shape shape;
    const Kernel<SUB> kernel = kept<SUB>(tile_rays, shape);
    if (kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    const int threads = threads_for(tile_rays, shape);
    return describe(reinterpret_cast<const void*>(kernel), shape, threads,
                    entry_bytes<SUB>(threads, shape.rpt), out);
  });
}
