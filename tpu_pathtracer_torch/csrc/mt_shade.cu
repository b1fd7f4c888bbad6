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
// order of `_FEATS`, so results equal the plain PyTorch version bit for bit.
// Faster variants (more rays per thread, double-buffered staging, packed
// coefficients) are later work.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr float kInf = 1e20f;      // raytrace.wgsl:6 (finite sentinel)
constexpr float kEpsilon = 1e-6f;  // raytrace.wgsl:7
constexpr int kSub = 64;           // triangles per sub-treelet
constexpr int kMaxThreads = 512;

struct Best {
  float t;
  int idx;
  float u;
  float v;
};

// Evaluate one ray (phi[10]) against the staged sub-treelet `rows`
// ([4][kSub][10], quantity-major inside the sub) and fold the sub's
// nearest valid hit into `best` with the lowest-index tie rule.
__device__ __forceinline__ void eval_sub(const float* __restrict__ rows,
                                         const float phi[10], int s0,
                                         Best& best) {
  float st = kInf;  // nearest valid t in this sub, lowest index on ties
  int si = 0x7fffffff;
  float su = 0.f, sv = 0.f;
#pragma unroll 4
  for (int i = 0; i < kSub; ++i) {
    const float* ca = rows + (0 * kSub + i) * 10;
    const float* cu = rows + (1 * kSub + i) * 10;
    const float* cv = rows + (2 * kSub + i) * 10;
    const float* ct = rows + (3 * kSub + i) * 10;
    // determinants, summed in _FEATS order: a (4,5,6), ua/va (4..9), ta (0..3)
    float a = __fmul_rn(ca[4], phi[4]);
    a = __fadd_rn(a, __fmul_rn(ca[5], phi[5]));
    a = __fadd_rn(a, __fmul_rn(ca[6], phi[6]));
    float ua = __fmul_rn(cu[4], phi[4]);
    float va = __fmul_rn(cv[4], phi[4]);
#pragma unroll
    for (int k = 5; k < 10; ++k) {
      ua = __fadd_rn(ua, __fmul_rn(cu[k], phi[k]));
      va = __fadd_rn(va, __fmul_rn(cv[k], phi[k]));
    }
    float ta = __fmul_rn(ct[0], phi[0]);
#pragma unroll
    for (int k = 1; k < 4; ++k) ta = __fadd_rn(ta, __fmul_rn(ct[k], phi[k]));

    // validity in the multiplied-through form (ts > EPSILON*|a|)
    const float abs_a = fabsf(a);
    const float sa = a > 0.f ? 1.f : (a < 0.f ? -1.f : 0.f);
    const float us = __fmul_rn(ua, sa);
    const float vs = __fmul_rn(va, sa);
    const float ts = __fmul_rn(ta, sa);
    const bool valid = abs_a >= kEpsilon && us >= 0.f && us <= abs_a &&
                       vs >= 0.f && __fadd_rn(us, vs) <= abs_a &&
                       ts > __fmul_rn(kEpsilon, abs_a);
    if (valid) {
      const float f = __frcp_rn(a);
      const float t = __fmul_rn(ta, f);
      if (t < st) {
        st = t;
        si = s0 + i;
        su = __fmul_rn(ua, f);
        sv = __fmul_rn(va, f);
      }
    }
  }
  const bool take =
      st < best.t || (st == best.t && st < kInf && si < best.idx);
  if (take) best = Best{st, si, su, sv};
}

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
    const int r = ray[k] < 0 ? tile * tile_rays : ray[k];
#pragma unroll
    for (int f = 0; f < 10; ++f) phi[k][f] = phi_t[f * r_pad + r];
    // parked lanes (rd = 0) and padding lanes (|rd| >= 1e30) start at -INF
    const float ax = fabsf(phi[k][4]);
    const bool parked =
        ray[k] < 0 ||
        __fadd_rn(__fadd_rn(ax, fabsf(phi[k][5])), fabsf(phi[k][6])) == 0.f ||
        ax >= 1e30f;
    best[k] = Best{parked ? -kInf : kInf, -1, 0.f, 0.f};
  }

  const int count = counts[tile];
  float tmax = kInf;
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
        eval_sub(rows, phi[k], s * kSub, best[k]);
        m = fmaxf(m, best[k].t);
      }
    }
    // block-wide max of t: the tile's bound for the next entry
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    if ((tid & 31) == 0) warp_max[tid >> 5] = m;
    __syncthreads();
    if (tid < 32) {
      const int n_warps = (blockDim.x + 31) >> 5;
      float w = tid < n_warps ? warp_max[tid] : -CUDART_INF_F;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        w = fmaxf(w, __shfl_xor_sync(0xffffffffu, w, o));
      if (tid == 0) tile_max = w;
    }
    __syncthreads();
    tmax = tile_max;
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
