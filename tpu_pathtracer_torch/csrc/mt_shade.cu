// Whole-scene Möller–Trumbore intersection (up to 8,192 triangles), for
// Hopper (sm_90a): the three culling variants of the JAX wrapper
// `mt_intersect_pallas2_phi`.
//
// Replaces the TPU kernels in tpu_pathtracer/ops/pallas/mt_shade.py
// (helpers `_mt_sub_block`, `_mt_epilogue`, `_parked_lanes`):
//   * `_kernel_nf` (cull='nf', the default): per ray tile, walk the tile's
//     live sub-treelets near to far and stop at the first entry distance
//     that reaches the tile's largest live t;
//   * `_kernel_list` (cull='list'): walk the same list in list order to its
//     end, with no bound and every lane from t = INF;
//   * `_kernel` (cull='cond'): no list; visit every 128-triangle chunk in
//     index order, evaluate it only if some ray enters its box before its
//     current t, and inside it each sub likewise.
// The Python wrapper (ops/kernels/mt_shade.py) pads the inputs and builds
// the lists or boxes; this file only walks them.  Every kernel is templated
// on the sub-treelet size SUB (8, 16, 32, 64 or 128 triangles).
//
// Design: one block per ray tile, each thread owning RPT rays of the tile
// (RPT = 1 at the default 512-ray tile), each ray's best (t, idx, u, v) in
// registers.  nf and list stage each listed sub's 4 x SUB x 10 coefficient
// rows in shared memory; every thread then evaluates its rays against the
// SUB triangles, reading the coefficients as warp-wide broadcasts.  nf
// refreshes the tile's bound by a block-wide max of t after each sub.
// cond first checks that some lane of the tile moves (the TPU's tile-alive
// gate; padding lanes, rd = 1e30, count as moving), then decides each chunk
// with `__syncthreads_or` of "entry < current t" over the tile, stages a
// live chunk's 20 KB of coefficients (128/SUB consecutive sub blocks of the
// sub-block-major table) and decides each of its subs the same way.  The
// TPU computes all chunk entries (and a chunk's sub entries) up front; they
// do not depend on t, so computing each just before its test gives the same
// decisions.  cond optionally writes its per-tile walk counts (chunks live,
// subs evaluated), which the plain version reproduces exactly.
//
// What bounds it on the H100: fp32 ALU work.  Per (ray, triangle) pair it is
// 19 products and 15 sums for the determinants plus the validity tests, and
// a correctly rounded reciprocal only for valid pairs; the coefficient
// traffic is 40*SUB floats per sub per tile from L2; cond adds one slab test
// per ray and chunk and per ray and sub of a live chunk, each behind a
// block barrier.  Kept exact rather than fast: the library is built with
// -fmad=false, the sums run in the feature order of `_FEATS` and the slab
// test in `_slab_entries`' order (mt_common.cuh), so results and culling
// decisions equal the plain PyTorch versions bit for bit.  Faster variants
// (more rays per thread, double-buffered staging, packed coefficients) are
// later work.

#include <type_traits>

#include "mt_common.cuh"

namespace {

using tpt::Best;
using tpt::kInf;
using tpt::kMaxThreads;

constexpr int kChunk = 128;  // the cond kernel's chunk (and padding granule)

template <int N>
using Int = std::integral_constant<int, N>;

// nf (NF = true) and list (NF = false) walks over the per-tile lists.
template <int RPT, int SUB, bool NF>
__global__ void __launch_bounds__(kMaxThreads)
    mt_list_kernel(const float* __restrict__ phi_t,      // (10, r_pad)
                   const float* __restrict__ cols_rows,  // (4*n_pad, 10)
                   const int* __restrict__ counts,       // (n_tiles,)
                   const int* __restrict__ lists,        // (n_tiles, ms)
                   const float* __restrict__ emins,      // (n_tiles, ms); nf only
                   float* __restrict__ out_t, int* __restrict__ out_idx,
                   float* __restrict__ out_u, float* __restrict__ out_v,
                   int r_pad, int tile_rays, int ms) {
  __shared__ float rows[4 * SUB * 10];
  __shared__ float warp_max[kMaxThreads / 32];
  __shared__ float tile_max;

  const int tile = blockIdx.x;
  const int tid = threadIdx.x;

  float phi[RPT][10];
  Best best[RPT];
  int ray[RPT];
#pragma unroll
  for (int k = 0; k < RPT; ++k) {
    const int lane = tid + k * blockDim.x;
    ray[k] = lane < tile_rays ? tile * tile_rays + lane : -1;
    best[k] = tpt::load_ray(phi_t, r_pad, ray[k], tile * tile_rays, phi[k], NF);
  }

  const int count = counts[tile];
  float tmax = kInf;
  for (int j = 0; j < count; ++j) {
    if constexpr (NF) {
      if (!(emins[tile * ms + j] < tmax)) break;
    }
    const int s = lists[tile * ms + j];
    const float* src = cols_rows + static_cast<size_t>(s) * (4 * SUB * 10);
    __syncthreads();  // the previous sub's rows are no longer read
    for (int i = tid; i < 4 * SUB * 10; i += blockDim.x) rows[i] = src[i];
    __syncthreads();

    float m = -CUDART_INF_F;
#pragma unroll
    for (int k = 0; k < RPT; ++k) {
      if (ray[k] >= 0) {
        tpt::eval_sub<SUB>(rows, phi[k], s * SUB, best[k]);
        m = fmaxf(m, best[k].t);
      }
    }
    // block-wide max of t: the tile's bound for the next entry
    if constexpr (NF) tmax = tpt::block_max(m, warp_max, &tile_max);
  }

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

// cond: two-level in-kernel culling over every chunk, in index order.
template <int RPT, int SUB>
__global__ void __launch_bounds__(kMaxThreads)
    mt_cond_kernel(const float* __restrict__ phi_t,        // (10, r_pad)
                   const float* __restrict__ cols_rows,    // (4*n_pad, 10)
                   const float* __restrict__ chunk_boxes,  // (n_chunks, 8)
                   const float* __restrict__ sub_boxes,    // (n_pad/SUB, 8)
                   float* __restrict__ out_t, int* __restrict__ out_idx,
                   float* __restrict__ out_u, float* __restrict__ out_v,
                   int* __restrict__ walk_stats,  // (n_tiles, 2) or null
                   int r_pad, int tile_rays, int n_chunks) {
  constexpr int kSubsPerChunk = kChunk / SUB;
  constexpr int kSubFloats = 4 * SUB * 10;
  constexpr int kChunkFloats = kSubsPerChunk * kSubFloats;  // 20 KB
  __shared__ __align__(16) float rows[kChunkFloats];

  const int tile = blockIdx.x;
  const int tid = threadIdx.x;

  float phi[RPT][10];
  float inv[RPT][3];
  Best best[RPT];
  int ray[RPT];
  bool moving = false;
#pragma unroll
  for (int k = 0; k < RPT; ++k) {
    const int lane = tid + k * blockDim.x;
    ray[k] = lane < tile_rays ? tile * tile_rays + lane : -1;
    best[k] = tpt::load_ray(phi_t, r_pad, ray[k], tile * tile_rays, phi[k], false);
    tpt::slab_inv(phi[k], inv[k]);
    moving |= ray[k] >= 0 && (fabsf(phi[k][4]) > 0.f || fabsf(phi[k][5]) > 0.f ||
                              fabsf(phi[k][6]) > 0.f);
  }

  // block-uniform walk counts: chunks live, subs evaluated
  int live_chunks = 0, evaluated = 0;
  if (__syncthreads_or(moving)) {  // the tile-alive gate
    for (int c = 0; c < n_chunks; ++c) {
      // a barrier too: the previous chunk's rows are no longer read
      if (!__syncthreads_or(tpt::any_live<RPT>(chunk_boxes + c * 8, phi, inv, best, ray)))
        continue;
      ++live_chunks;
      const float4* src = reinterpret_cast<const float4*>(
          cols_rows + static_cast<size_t>(c) * kChunkFloats);
      float4* dst = reinterpret_cast<float4*>(rows);
      for (int i = tid; i < kChunkFloats / 4; i += blockDim.x) dst[i] = src[i];
      __syncthreads();
      for (int s = 0; s < kSubsPerChunk; ++s) {
        const int sub_id = c * kSubsPerChunk + s;
        // a 128-triangle sub is the chunk: the chunk test already decided
        if (kSubsPerChunk > 1 &&
            !__syncthreads_or(tpt::any_live<RPT>(sub_boxes + sub_id * 8, phi, inv, best, ray)))
          continue;
        ++evaluated;
#pragma unroll
        for (int r = 0; r < RPT; ++r)
          if (ray[r] >= 0)
            tpt::eval_sub<SUB>(rows + s * kSubFloats, phi[r], sub_id * SUB, best[r]);
      }
    }
  }
  if (walk_stats != nullptr && tid == 0) {
    walk_stats[tile * 2 + 0] = live_chunks;
    walk_stats[tile * 2 + 1] = evaluated;
  }

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

// Calls f(Int<RPT>, Int<SUB>) with the rays per thread that fit `tile_rays`
// in one block and the given sub-treelet size; false if there are none.
template <int SUB, typename F>
bool by_rpt(int tile_rays, F&& f) {
  if (tile_rays <= kMaxThreads)
    f(Int<1>{}, Int<SUB>{});
  else if (tile_rays <= 2 * kMaxThreads)
    f(Int<2>{}, Int<SUB>{});
  else if (tile_rays <= 4 * kMaxThreads)
    f(Int<4>{}, Int<SUB>{});
  else if (tile_rays <= 8 * kMaxThreads)
    f(Int<8>{}, Int<SUB>{});
  else
    return false;
  return true;
}

template <typename F>
bool by_shape(int tile_rays, int sub, F&& f) {
  switch (sub) {
    case 8: return by_rpt<8>(tile_rays, f);
    case 16: return by_rpt<16>(tile_rays, f);
    case 32: return by_rpt<32>(tile_rays, f);
    case 64: return by_rpt<64>(tile_rays, f);
    case 128: return by_rpt<128>(tile_rays, f);
    default: return false;
  }
}

int threads_for(int tile_rays, int rpt) {
  const int threads = (tile_rays + rpt - 1) / rpt;
  return (threads + 31) / 32 * 32;
}

template <bool NF>
int launch_list(const float* phi_t, const float* cols_rows, const int* counts,
                const int* lists, const float* emins, float* t, int* idx,
                float* u, float* v, int r_pad, int tile_rays, int n_tiles,
                int ms, int sub, cudaStream_t stream) {
  if (tile_rays <= 0 || n_tiles <= 0 || ms <= 0 || r_pad != n_tiles * tile_rays)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool ok = by_shape(tile_rays, sub, [&](auto rpt, auto s) {
    constexpr int RPT = decltype(rpt)::value, SUB = decltype(s)::value;
    mt_list_kernel<RPT, SUB, NF><<<n_tiles, threads_for(tile_rays, RPT), 0, stream>>>(
        phi_t, cols_rows, counts, lists, emins, t, idx, u, v, r_pad, tile_rays, ms);
  });
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int tpt_mt_nf(const float* phi_t, const float* cols_rows,
                         const int* counts, const int* lists,
                         const float* emins, float* t, int* idx, float* u,
                         float* v, int r_pad, int tile_rays, int n_tiles,
                         int ms, int sub, cudaStream_t stream) {
  return launch_list<true>(phi_t, cols_rows, counts, lists, emins, t, idx, u,
                           v, r_pad, tile_rays, n_tiles, ms, sub, stream);
}

extern "C" int tpt_mt_list(const float* phi_t, const float* cols_rows,
                           const int* counts, const int* lists, float* t,
                           int* idx, float* u, float* v, int r_pad,
                           int tile_rays, int n_tiles, int ms, int sub,
                           cudaStream_t stream) {
  return launch_list<false>(phi_t, cols_rows, counts, lists, nullptr, t, idx,
                            u, v, r_pad, tile_rays, n_tiles, ms, sub, stream);
}

extern "C" int tpt_mt_cond(const float* phi_t, const float* cols_rows,
                           const float* chunk_boxes, const float* sub_boxes,
                           float* t, int* idx, float* u, float* v,
                           int* walk_stats, int r_pad, int tile_rays,
                           int n_tiles, int n_chunks, int sub,
                           cudaStream_t stream) {
  if (tile_rays <= 0 || n_tiles <= 0 || n_chunks <= 0 ||
      r_pad != n_tiles * tile_rays)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool ok = by_shape(tile_rays, sub, [&](auto rpt, auto s) {
    constexpr int RPT = decltype(rpt)::value, SUB = decltype(s)::value;
    mt_cond_kernel<RPT, SUB><<<n_tiles, threads_for(tile_rays, RPT), 0, stream>>>(
        phi_t, cols_rows, chunk_boxes, sub_boxes, t, idx, u, v, walk_stats,
        r_pad, tile_rays, n_chunks);
  });
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* tpt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
