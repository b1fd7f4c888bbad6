// Streamed two-level-culled Möller–Trumbore intersection for large scenes
// (8K-256K triangles), for Hopper (sm_90a): the first design, kept as
// `tpt_mt_stream_v1` for one comparison.  The walk the wrapper launches is
// its Hopper redesign in stream_walk.cu.
//
// Replaces the TPU kernel `_kernel_stream2` in
// tpu_pathtracer/ops/pallas/mt_shade.py.  The Python wrapper
// (ops/kernels/mt_stream.py) pads the inputs, builds the super, chunk and
// sub boxes and the per-tile near-to-far lists of live super-treelets
// (2,048 triangles = 16 chunks of 128 = 64 subs of 32); this file walks
// them.
//
// Design: one block per ray tile, each thread owning RPT rays (RPT = 1 at
// the default 512-ray tile), each ray's best (t, idx, u, v) in registers.
// Per listed super the block stages its 16 chunk boxes in shared memory.
// For chunk k in index order, every thread slab-tests its rays against the
// chunk box; `__syncthreads_or` of "entry < current t" decides for the
// block whether the chunk is live.  A live chunk's coefficients (4 subs x
// 4 quantities x 32 triangles x 10 features, one contiguous 20 KB block of
// the sub-block-major table) and its 4 sub boxes are staged in shared
// memory; each sub is evaluated if some ray enters its box before its
// current t.  After the super's last chunk a block-wide max of t refreshes
// the tile's bound, and the walk stops at the first super whose entry
// distance reaches it.  The TPU kernel computes the 16 chunk entries (and
// a chunk's 4 sub entries) up front; they do not depend on t, so computing
// each just before its test, as here, gives the same decisions.
// Optionally the block writes its walk counts (supers walked, chunks
// staged, subs evaluated), which the plain version reproduces exactly:
// they show that both made the same liveness decisions, which the hits
// alone cannot.
//
// What bounds it on the H100: fp32 ALU work per (ray, triangle) pair of
// the live subs (as in mt_shade.cu), plus two slab levels per ray (16
// chunk boxes per walked super, 4 sub boxes per live chunk); only live
// chunks are read, from L2 (the table is 10 KB per 512 triangles, 21 MB at
// 131,072).  Kept exact rather than fast: -fmad=false, IEEE 1/rd, and the
// slab formula of `_slab_entries` term for term (mt_common.cuh for the MT
// math), so liveness decisions and results equal the plain PyTorch
// version bit for bit.  stream_walk.cu overlaps the staging with compute,
// decides by mask and spreads a tile over a thread block cluster.

#include "mt_common.cuh"

namespace {

using tpt::Best;
using tpt::kInf;
using tpt::kMaxThreads;

constexpr int kSub = 32;           // triangles per sub-treelet
constexpr int kSubsPerChunk = 4;   // 128-triangle chunk
constexpr int kChunksPerSuper = 16;
constexpr int kSubFloats = 4 * kSub * 10;
constexpr int kChunkFloats = kSubsPerChunk * kSubFloats;  // 20 KB

template <int RPT>
__global__ void __launch_bounds__(kMaxThreads)
    mt_stream_kernel(const float* __restrict__ phi_t,        // (10, r_pad)
                     const float* __restrict__ cols_rows,    // (4*n_pad, 10)
                     const float* __restrict__ chunk_boxes,  // (n_chunks, 8)
                     const float* __restrict__ sub_boxes,    // (4*n_chunks, 8)
                     const int* __restrict__ counts,         // (n_tiles,)
                     const int* __restrict__ lists,          // (n_tiles, ms)
                     const float* __restrict__ emins,        // (n_tiles, ms)
                     float* __restrict__ out_t, int* __restrict__ out_idx,
                     float* __restrict__ out_u, float* __restrict__ out_v,
                     int* __restrict__ walk_stats,  // (n_tiles, 3) or null
                     int r_pad, int tile_rays, int ms) {
  __shared__ __align__(16) float rows[kChunkFloats];
  __shared__ float cbox[kChunksPerSuper * 8];
  __shared__ float sbox[kSubsPerChunk * 8];
  __shared__ float warp_max[kMaxThreads / 32];
  __shared__ float tile_max;

  const int tile = blockIdx.x;
  const int tid = threadIdx.x;

  float phi[RPT][10];
  float inv[RPT][3];
  Best best[RPT];
  int ray[RPT];
#pragma unroll
  for (int k = 0; k < RPT; ++k) {
    const int lane = tid + k * blockDim.x;
    ray[k] = lane < tile_rays ? tile * tile_rays + lane : -1;
    best[k] = tpt::load_ray(phi_t, r_pad, ray[k], tile * tile_rays, phi[k]);
    tpt::slab_inv(phi[k], inv[k]);
  }

  // block-uniform walk counts: supers walked, chunks staged, subs evaluated
  int walked = 0, staged = 0, evaluated = 0;
  const int count = counts[tile];
  float tmax = kInf;
  for (int j = 0; j < count; ++j) {
    if (!(emins[tile * ms + j] < tmax)) break;
    ++walked;
    const int super_id = lists[tile * ms + j];
    __syncthreads();  // the previous super's boxes are no longer read
    for (int i = tid; i < kChunksPerSuper * 8; i += blockDim.x)
      cbox[i] = chunk_boxes[super_id * kChunksPerSuper * 8 + i];
    __syncthreads();

    for (int k = 0; k < kChunksPerSuper; ++k) {
      // a barrier too: the previous chunk's rows and sub boxes are done
      if (!__syncthreads_or(tpt::any_live<RPT>(cbox + k * 8, phi, inv, best, ray)))
        continue;
      ++staged;
      const int c = super_id * kChunksPerSuper + k;
      const float4* src = reinterpret_cast<const float4*>(
          cols_rows + static_cast<size_t>(c) * kChunkFloats);
      float4* dst = reinterpret_cast<float4*>(rows);
      for (int i = tid; i < kChunkFloats / 4; i += blockDim.x) dst[i] = src[i];
      for (int i = tid; i < kSubsPerChunk * 8; i += blockDim.x)
        sbox[i] = sub_boxes[c * kSubsPerChunk * 8 + i];
      __syncthreads();
      for (int s = 0; s < kSubsPerChunk; ++s) {
        if (!__syncthreads_or(tpt::any_live<RPT>(sbox + s * 8, phi, inv, best, ray)))
          continue;
        ++evaluated;
#pragma unroll
        for (int r = 0; r < RPT; ++r)
          if (ray[r] >= 0)
            tpt::eval_sub<kSub>(rows + s * kSubFloats, phi[r],
                                (c * kSubsPerChunk + s) * kSub, best[r]);
      }
    }

    // block-wide max of t, once per super: the tile's bound for the next
    float m = -CUDART_INF_F;
#pragma unroll
    for (int r = 0; r < RPT; ++r)
      if (ray[r] >= 0) m = fmaxf(m, best[r].t);
    tmax = tpt::block_max(m, warp_max, &tile_max);
  }
  if (walk_stats != nullptr && tid == 0) {
    walk_stats[tile * 3 + 0] = walked;
    walk_stats[tile * 3 + 1] = staged;
    walk_stats[tile * 3 + 2] = evaluated;
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

template <int RPT>
void launch(const float* phi_t, const float* cols_rows,
            const float* chunk_boxes, const float* sub_boxes,
            const int* counts, const int* lists, const float* emins, float* t,
            int* idx, float* u, float* v, int* walk_stats, int r_pad,
            int tile_rays, int n_tiles, int ms, cudaStream_t stream) {
  int threads = (tile_rays + RPT - 1) / RPT;
  threads = (threads + 31) / 32 * 32;
  mt_stream_kernel<RPT><<<n_tiles, threads, 0, stream>>>(
      phi_t, cols_rows, chunk_boxes, sub_boxes, counts, lists, emins, t, idx,
      u, v, walk_stats, r_pad, tile_rays, ms);
}

}  // namespace

// The first design, kept only for comparison with its Hopper redesign
// (stream_walk.cu) in chip_smoke.py and the card tests; no render path
// calls it.
extern "C" int tpt_mt_stream_v1(const float* phi_t, const float* cols_rows,
                                const float* chunk_boxes, const float* sub_boxes,
                                const int* counts, const int* lists,
                                const float* emins, float* t, int* idx, float* u,
                                float* v, int* walk_stats, int r_pad,
                                int tile_rays, int n_tiles, int ms, int sub,
                                int chunks_per_super, cudaStream_t stream) {
  if (sub != kSub || chunks_per_super != kChunksPerSuper || tile_rays <= 0 ||
      n_tiles <= 0 || ms <= 0 || r_pad != n_tiles * tile_rays)
    return static_cast<int>(cudaErrorInvalidValue);
  if (tile_rays <= kMaxThreads)
    launch<1>(phi_t, cols_rows, chunk_boxes, sub_boxes, counts, lists, emins,
              t, idx, u, v, walk_stats, r_pad, tile_rays, n_tiles, ms, stream);
  else if (tile_rays <= 2 * kMaxThreads)
    launch<2>(phi_t, cols_rows, chunk_boxes, sub_boxes, counts, lists, emins,
              t, idx, u, v, walk_stats, r_pad, tile_rays, n_tiles, ms, stream);
  else if (tile_rays <= 4 * kMaxThreads)
    launch<4>(phi_t, cols_rows, chunk_boxes, sub_boxes, counts, lists, emins,
              t, idx, u, v, walk_stats, r_pad, tile_rays, n_tiles, ms, stream);
  else if (tile_rays <= 8 * kMaxThreads)
    launch<8>(phi_t, cols_rows, chunk_boxes, sub_boxes, counts, lists, emins,
              t, idx, u, v, walk_stats, r_pad, tile_rays, n_tiles, ms, stream);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
