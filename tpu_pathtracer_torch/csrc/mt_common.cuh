// Device code shared by the port's Möller–Trumbore walks (through walk.cuh:
// nf_walk.cu, cond_walk.cu, stream_walk.cu, r2_walk.cu; and mxu_walk.cu),
// so all of them round identically.
//
// Everything here mirrors an elementwise step of the plain PyTorch versions
// (ops/mt_matmul.py `determinants`, `epilogue`, `nearest`; ops/kernels/
// mt_shade.py `_slab_entries`, `_slab_setup`, `_parked_lanes`) one rounding
// per operation: the library is built with -fmad=false, products and sums
// are __fmul_rn / __fadd_rn in the plain version's order, and reciprocals
// are correctly rounded.

#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

namespace tpt {

constexpr float kInf = 1e20f;      // raytrace.wgsl:6 (finite sentinel)
constexpr float kEpsilon = 1e-6f;  // raytrace.wgsl:7

struct Best {
  float t;
  int idx;
  float u;
  float v;
};

// The epilogue of one (ray, triangle) pair: validity in the
// multiplied-through form (ts > EPSILON*|a|), then t = ta * (1/a); a
// valid pair nearer than `near` replaces it.  Callers visit triangles in
// ascending index order, so exact-t ties keep the lowest index.
__device__ __forceinline__ void take_pair(float a, float ua, float va,
                                          float ta, int tri, Best& near) {
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
    if (t < near.t) near = Best{t, tri, __fmul_rn(ua, f), __fmul_rn(va, f)};
  }
}

// The round-2 epilogue of one pair (ops/kernels/mt_intersect.py
// `_epilogue_r2`): validity in the divided form, t = ta * (1/a) >
// EPSILON, and the winner's u = ua * f + 0, v = va * f + 0 (the TPU kernel
// sums the winner's u over the chunk's rows, all others 0.0, which turns a
// -0.0 into +0.0).  f = 1/a reaches the result only for a pair that passes
// |a| >= EPSILON and the four sign tests, so only such a pair takes the
// reciprocal.  Callers visit triangles in ascending index order.
__device__ __forceinline__ void take_pair_r2(float a, float ua, float va,
                                             float ta, int tri, Best& near) {
  const float abs_a = fabsf(a);
  const float sa = a > 0.f ? 1.f : (a < 0.f ? -1.f : 0.f);
  const float us = __fmul_rn(ua, sa);
  const float vs = __fmul_rn(va, sa);
  if (abs_a >= kEpsilon && us >= 0.f && us <= abs_a && vs >= 0.f &&
      __fadd_rn(us, vs) <= abs_a) {
    const float f = __frcp_rn(a);
    const float t = __fmul_rn(ta, f);
    if (t > kEpsilon && t < near.t)
      near = Best{t, tri, __fadd_rn(__fmul_rn(ua, f), 0.f),
                  __fadd_rn(__fmul_rn(va, f), 0.f)};
  }
}

// The epilogue a walk applies to each pair, as a template argument:
// `take_pair` (the near-to-far, list, cond and streamed walks) or
// `take_pair_r2` (the round-2 walk).
struct PairNf {
  __device__ __forceinline__ static void take(float a, float ua, float va,
                                              float ta, int tri, Best& near) {
    take_pair(a, ua, va, ta, tri, near);
  }
};

struct PairR2 {
  __device__ __forceinline__ static void take(float a, float ua, float va,
                                              float ta, int tri, Best& near) {
    take_pair_r2(a, ua, va, ta, tri, near);
  }
};

// Fold a sub-treelet's nearest hit `near` into a ray's `best`: nearer wins,
// an exact-t tie goes to the lower triangle index.
__device__ __forceinline__ void fold(const Best& near, Best& best) {
  if (near.t < best.t ||
      (near.t == best.t && near.t < kInf && near.idx < best.idx))
    best = near;
}

// Load ray `ray` (or, for a lane past the tile, any ray of the tile) from
// the (10, r_pad) feature matrix and return its initial best.  With `park`
// (the near-to-far walk) parked lanes (rd = 0), padding lanes
// (|rd| >= 1e30) and lanes past the tile start at -INF, so they never take
// a hit and never hold a walk open; without it (the list and cond walks)
// every lane starts at INF.
__device__ __forceinline__ Best load_ray(const float* __restrict__ phi_t,
                                         int r_pad, int ray, int tile_ray0,
                                         float phi[10], bool park = true) {
  const int r = ray < 0 ? tile_ray0 : ray;
#pragma unroll
  for (int f = 0; f < 10; ++f) phi[f] = phi_t[f * r_pad + r];
  const float ax = fabsf(phi[4]);
  const bool parked =
      ray < 0 || __fadd_rn(__fadd_rn(ax, fabsf(phi[5])), fabsf(phi[6])) == 0.f ||
      ax >= 1e30f;
  return Best{park && parked ? -kInf : kInf, -1, 0.f, 0.f};
}

// IEEE reciprocals of a ray's direction for the slab test (`_slab_setup`):
// axes with |rd| < EPSILON are parallel and take 1.
__device__ __forceinline__ void slab_inv(const float phi[10], float inv[3]) {
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float d = phi[4 + a];
    inv[a] = __fdiv_rn(1.f, fabsf(d) < kEpsilon ? 1.f : d);
  }
}

// Slab entry distance of one ray against box [min3, max3, 0, 0]; INF on a
// miss.  `_slab_entries` term for term: parallel axes (|rd| < EPSILON)
// require containment.
__device__ __forceinline__ float slab_entry(const float* box,
                                            const float phi[10],
                                            const float inv[3]) {
  bool hit_par = true;
  float tn_all = -kInf, tf_all = kInf;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float o = phi[1 + k];
    const bool par = fabsf(phi[4 + k]) < kEpsilon;
    const float lo = __fmul_rn(__fsub_rn(box[k], o), inv[k]);
    const float hi = __fmul_rn(__fsub_rn(box[k + 3], o), inv[k]);
    const float tn = par ? -kInf : fminf(lo, hi);
    const float tf = par ? kInf : fmaxf(lo, hi);
    hit_par = hit_par && (!par || (o >= box[k] && o <= box[k + 3]));
    tn_all = fmaxf(tn_all, tn);
    tf_all = fminf(tf_all, tf);
  }
  return hit_par && tf_all >= fmaxf(tn_all, 0.f) ? tn_all : kInf;
}

}  // namespace tpt
