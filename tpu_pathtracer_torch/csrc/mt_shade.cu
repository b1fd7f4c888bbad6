// Near-to-far Möller–Trumbore intersection over per-tile live sub-treelet
// lists, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_kernel_nf` in tpu_pathtracer/ops/pallas/mt_shade.py
// (helpers `_mt_sub_block`, `_mt_epilogue`, `_parked_lanes`).  The Python
// wrapper (ops/kernels/mt_shade.py) pads the inputs and builds the per-tile
// lists; this file only walks them.
//
// Design: one block per ray tile, each thread owning RPT rays of the tile
// (RPT = 1 at the default 512-ray tile).  For each listed sub-treelet the
// block stages its 4 x 64 x 10 coefficient rows (10 KB) in shared memory;
// every thread then evaluates its rays against the 64 triangles, reading the
// coefficients as warp-wide broadcasts.  After each sub a block-wide max of
// t refreshes the tile's bound, and the walk stops at the first entry
// distance that reaches it (the scalar early break of the TPU kernel).
//
// What bounds it on the H100: fp32 ALU work.  Per (ray, triangle) pair it is
// 19 products and 15 sums for the determinants plus the validity tests, and
// a correctly rounded reciprocal only for valid pairs; the coefficient
// traffic is 10 KB per sub per tile from L2.  Kept exact rather than fast:
// the library is built with -fmad=false and the sums run in the feature
// order of `_FEATS` (mt_common.cuh), so results equal the plain PyTorch
// version bit for bit.  Faster variants (more rays per thread,
// double-buffered staging, packed coefficients) are later work.

#include "mt_common.cuh"

namespace {

using tpt::Best;
using tpt::kMaxThreads;

constexpr int kSub = 64;  // triangles per sub-treelet

template <int RPT>
__global__ void __launch_bounds__(kMaxThreads)
    mt_nf_kernel(const float* __restrict__ phi_t,      // (10, r_pad)
                 const float* __restrict__ cols_rows,  // (4*n_pad, 10)
                 const int* __restrict__ counts,       // (n_tiles,)
                 const int* __restrict__ lists,        // (n_tiles, ms)
                 const float* __restrict__ emins,      // (n_tiles, ms)
                 float* __restrict__ out_t, int* __restrict__ out_idx,
                 float* __restrict__ out_u, float* __restrict__ out_v,
                 int r_pad, int tile_rays, int ms) {
  __shared__ float rows[4 * kSub * 10];
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
    best[k] = tpt::load_ray(phi_t, r_pad, ray[k], tile * tile_rays, phi[k]);
  }

  const int count = counts[tile];
  float tmax = tpt::kInf;
  for (int j = 0; j < count; ++j) {
    if (!(emins[tile * ms + j] < tmax)) break;
    const int s = lists[tile * ms + j];
    const float* src = cols_rows + static_cast<size_t>(s) * (4 * kSub * 10);
    __syncthreads();  // the previous sub's rows are no longer read
    for (int i = tid; i < 4 * kSub * 10; i += blockDim.x) rows[i] = src[i];
    __syncthreads();

    float m = -CUDART_INF_F;
#pragma unroll
    for (int k = 0; k < RPT; ++k) {
      if (ray[k] >= 0) {
        tpt::eval_sub<kSub>(rows, phi[k], s * kSub, best[k]);
        m = fmaxf(m, best[k].t);
      }
    }
    // block-wide max of t: the tile's bound for the next entry
    tmax = tpt::block_max(m, warp_max, &tile_max);
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
void launch(const float* phi_t, const float* cols_rows, const int* counts,
            const int* lists, const float* emins, float* t, int* idx, float* u,
            float* v, int r_pad, int tile_rays, int n_tiles, int ms,
            cudaStream_t stream) {
  int threads = (tile_rays + RPT - 1) / RPT;
  threads = (threads + 31) / 32 * 32;
  mt_nf_kernel<RPT><<<n_tiles, threads, 0, stream>>>(
      phi_t, cols_rows, counts, lists, emins, t, idx, u, v, r_pad, tile_rays,
      ms);
}

}  // namespace

extern "C" int tpt_mt_nf(const float* phi_t, const float* cols_rows,
                         const int* counts, const int* lists,
                         const float* emins, float* t, int* idx, float* u,
                         float* v, int r_pad, int tile_rays, int n_tiles,
                         int ms, int sub, cudaStream_t stream) {
  if (sub != kSub || tile_rays <= 0 || n_tiles <= 0 ||
      r_pad != n_tiles * tile_rays)
    return static_cast<int>(cudaErrorInvalidValue);
  if (tile_rays <= kMaxThreads)
    launch<1>(phi_t, cols_rows, counts, lists, emins, t, idx, u, v, r_pad,
              tile_rays, n_tiles, ms, stream);
  else if (tile_rays <= 2 * kMaxThreads)
    launch<2>(phi_t, cols_rows, counts, lists, emins, t, idx, u, v, r_pad,
              tile_rays, n_tiles, ms, stream);
  else if (tile_rays <= 4 * kMaxThreads)
    launch<4>(phi_t, cols_rows, counts, lists, emins, t, idx, u, v, r_pad,
              tile_rays, n_tiles, ms, stream);
  else if (tile_rays <= 8 * kMaxThreads)
    launch<8>(phi_t, cols_rows, counts, lists, emins, t, idx, u, v, r_pad,
              tile_rays, n_tiles, ms, stream);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* tpt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
