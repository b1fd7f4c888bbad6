// MXU-determinant Möller–Trumbore walks (kernel #5), for Hopper (sm_90a):
// the near-to-far ('nf'), list and cond walks of nf_walk.cu and
// cond_walk.cu with each sub-treelet's four determinants formed on the
// tensor cores (TPT_MXU_DETS=1), up to 8,192 triangles.
//
// Replaces the TPU function `_mt_mxu_block` (tpu_pathtracer/ops/pallas/
// mt_shade.py:118), the body of `_kernel_nf` (:308), `_kernel_list` (:255)
// and `_kernel` (:183) under `mxu_dets=True`.  The TPU forms (4*SUB, 10) @
// (10, TR) at Precision.HIGHEST; here the counterpart is 3xTF32
// `mma.sync.m16n8k8`: each operand x is split into hi = tf32(x) and lo =
// tf32(x - hi) (round to nearest, ties away), and the products accumulate
// in f32 as lo*hi + hi*lo, then hi*hi, which keeps about float32's
// precision (one TF32 pass keeps about 3 digits and flips hit decisions).
// The walks (order, bound, decisions, staging) are those of the FP32
// Hopper walks, on walk.cuh's machinery; only the determinants, and so t,
// differ from the plain versions by rounding, so hits are held to them by
// `mt_shade.hit_agreement` and walk counts to within 1% of tiles.
//
// What bounds it on the H100, and the design.  With the triangles as the
// A operand and the rays as B, each 8-triangle group's A fragments would
// be re-read from shared memory for every 8 rays and each ray's B
// fragments re-read from global memory and re-split for every sub; a split
// into hi and lo at every staging would put arithmetic into a blocking
// copy between two barriers.  This design:
//   a. rays are the A operand, 16 an m-tile, M m-tiles a warp, split into
//      hi and lo once and held in registers for the whole walk; a group's
//      B fragments are loaded once a warp and serve its M m-tiles.  Lane
//      (g, tig) holds rays g and g+8 of each m-tile; one n-tile is one
//      quantity (a, ua, va, ta) of 8 triangles, so after the four
//      quantities its C fragments hold all four determinants of triangles
//      2*tig and 2*tig+1 against both rays: four whole pairs, evaluated
//      where they are;
//   b. K is ordered [4 5 6 7 8 9 0 1 | 2 3 0 ...]: a, ua and va use the
//      first k-step only and ta both, so a group takes 5 MMAs a pass (15
//      for the three) where K = 16 in feature order takes 8 (24), and its
//      B fragments are 9 words (18 with hi and lo, padded to 20: five
//      float4 a lane);
//   c. the wrapper splits the table once (`_pack_mxu_table`: hi and lo in
//      fragment order, 320 bytes a triangle, a sub or a chunk one
//      contiguous block), so staging is a pure bulk copy (walk.cuh
//      `Stager`, double-buffered);
//   d. each lane keeps its own best per ray over the triangles it sees,
//      taking a pair whose (t, index) is below it; a ray's 4 lanes combine
//      by (t, index) once, at the end.  A decision reads a ray's t as the
//      min over its lanes (two shuffles): nf's bound goes through `decide`
//      across a cluster, as in nf_walk.cu; list decides nothing, so its
//      CTAs need no cluster; cond decides by cond_walk.cu's masks (chunks
//      16 at a time, both masks formed again after each evaluated sub),
//      each mask bit's slab test made on one lane of each ray; its tiles
//      of 4,097-8,192 rays take a non-portable cluster of 16.
// Per 8-triangle group and 16 rays: 15 MMAs (2 x 16 x 8 x 8 flops each,
// on the 495 TFLOP/s TF32 path) against 128 epilogues (5 FP32 operations
// and the validity compares each, on the 67 TFLOP/s FP32 path): the
// epilogue and the heaviest tile's serial walk set the pace, as in the
// FP32 walks.  Padding lanes (features 1e30) and parked lanes (ro = 1e30,
// rd = 0) stay finite through the three passes: no coefficient is
// infinite, so no product is inf * 0.

#include "walk.cuh"

namespace {

using tpt::Best;
using tpt::kEpsilon;
using tpt::kInf;
using namespace tpt::walk;

constexpr int kChunk = 128;             // triangles a cond chunk
constexpr int kGroup = 16;              // cond chunks decided together (16 mask bits)
constexpr int kGroupVecs = 5 * 32;      // float4s of one 8-triangle group of the table
constexpr int kTriBytes = kGroupVecs * 16 / 8;  // 320 bytes a triangle

// The designs the sweep kept (PERF.md): m-tiles of 16 rays a warp and
// CTAs a tile of each walk (list's a plain grid: it decides nothing).
// One m-tile a warp wins for all three: with two, the registers (96-128)
// cost more residency than the shared B fragments save.
constexpr int kNfM = 1;
constexpr int kNfCluster = 4;
constexpr int kListM = 1;
constexpr int kListCluster = 8;
constexpr int kCondM = 1;
constexpr int kCondCluster = 4;

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// hi keeps TF32's 10 mantissa bits (the MMA ignores the low 13), lo the
// rest, rounded likewise.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(__fsub_rn(x, __uint_as_float(hi)));
}

// d += a * b on one m16n8k8 tile: tf32 operands, f32 accumulator.
__device__ __forceinline__ void mma(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                    uint32_t a3, uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// The A fragments of one m-tile, hi and lo: k-step 0 registers a0-a3
// (rows g, g+8 at K positions tig, tig+4), k-step 1 registers a0, a1
// (position 8+tig); a2, a3 of k-step 1 are positions 12-15, zero.
struct RayFrag {
  uint32_t h0[4], l0[4], h1[2], l1[2];
};

// Slot r = 2*m + h of a lane is ray g + 8*h of its warp's m-tile m.
// Loads the A fragments of the lane's rays (a lane past the tile reads the
// tile's first ray; its hits are never written).  K position p holds
// feature [4 5 6 7 8 9 0 1 2 3][p], zero past 9.
template <int M>
__device__ __forceinline__ void load_frags(const float* __restrict__ phi_t, int r_pad,
                                           const int (&ray)[2 * M], int ray0,
                                           RayFrag (&a)[M]) {
  const int tig = threadIdx.x & 3;
  const int f0 = 4 + tig, f1 = tig < 2 ? 8 + tig : tig - 2, f2 = 2 + tig;
#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = ray[2 * m + h] < 0 ? ray0 : ray[2 * m + h];
      split(phi_t[f0 * r_pad + r], a[m].h0[h], a[m].l0[h]);
      split(phi_t[f1 * r_pad + r], a[m].h0[2 + h], a[m].l0[2 + h]);
      split(tig < 2 ? phi_t[f2 * r_pad + r] : 0.f, a[m].h1[h], a[m].l1[h]);
    }
}

// The epilogue of one (ray, triangle) pair, as `tpt::take_pair` computes
// it: validity in the multiplied-through form (ts > EPSILON*|a|), then t =
// ta * (1/a).  A valid pair is taken when (t, index) is below the lane's
// best, so the lane's best is the nearest hit with the lowest index on
// exact-t ties, in whatever order its triangles come.
__device__ __forceinline__ void take(float a, float ua, float va, float ta, int tri,
                                     Best& best) {
  const float abs_a = fabsf(a);
  const float sa = a > 0.f ? 1.f : (a < 0.f ? -1.f : 0.f);
  const float us = __fmul_rn(ua, sa);
  const float vs = __fmul_rn(va, sa);
  const float ts = __fmul_rn(ta, sa);
  const bool valid = abs_a >= kEpsilon && us >= 0.f && us <= abs_a && vs >= 0.f &&
                     __fadd_rn(us, vs) <= abs_a && ts > __fmul_rn(kEpsilon, abs_a);
  if (valid) {
    const float f = __frcp_rn(a);
    const float t = __fmul_rn(ta, f);
    if (t < best.t || (t == best.t && tri < best.idx))
      best = Best{t, tri, __fmul_rn(ua, f), __fmul_rn(va, f)};
  }
}

// Evaluate the staged block `rows` (SUB triangles of the MXU table, the
// first one s0) against the lane's 2*M rays.  Per 8-triangle group: five
// 128-bit loads of the lane's B fragments, then per m-tile each quantity's
// three passes, small terms first, and the four pairs of the C fragments.
// `groups` is SUB / 8, passed from the host: ptxas (CUDA 12.9) crashes on
// the one-group body of SUB = 8 compiled as straight-line code, and a trip
// count it cannot see keeps that a loop.
template <int SUB, int M>
__device__ __forceinline__ void eval_mxu(const float4* __restrict__ rows, const RayFrag (&a)[M],
                                         int s0, Best (&best)[2 * M], int groups) {
  const int lane = threadIdx.x & 31, tig = lane & 3;
  const int n_groups = SUB == 8 ? groups : SUB / 8;
#pragma unroll 2
  for (int grp = 0; grp < n_groups; ++grp) {
    const float4* p = rows + grp * kGroupVecs + lane;
    const float4 vh0 = p[0], vh1 = p[32], vl0 = p[64], vl1 = p[96], vk = p[128];
    // per quantity (a, ua, va, ta): registers b0, b1 of k-step 0
    const uint32_t bh[4][2] = {{__float_as_uint(vh0.x), __float_as_uint(vh0.y)},
                               {__float_as_uint(vh0.z), __float_as_uint(vh0.w)},
                               {__float_as_uint(vh1.x), __float_as_uint(vh1.y)},
                               {__float_as_uint(vh1.z), __float_as_uint(vh1.w)}};
    const uint32_t bl[4][2] = {{__float_as_uint(vl0.x), __float_as_uint(vl0.y)},
                               {__float_as_uint(vl0.z), __float_as_uint(vl0.w)},
                               {__float_as_uint(vl1.x), __float_as_uint(vl1.y)},
                               {__float_as_uint(vl1.z), __float_as_uint(vl1.w)}};
    // ta's register b0 of k-step 1 (its b1 is position 12+tig: zero)
    const uint32_t kh = __float_as_uint(vk.x), kl = __float_as_uint(vk.y);
    const int tri = s0 + grp * 8 + 2 * tig;
#pragma unroll
    for (int m = 0; m < M; ++m) {
      const RayFrag& f = a[m];
      float d[4][4] = {};
#pragma unroll
      for (int q = 0; q < 4; ++q) mma(d[q], f.l0[0], f.l0[1], f.l0[2], f.l0[3], bh[q][0], bh[q][1]);
      mma(d[3], f.l1[0], f.l1[1], 0u, 0u, kh, 0u);
#pragma unroll
      for (int q = 0; q < 4; ++q) mma(d[q], f.h0[0], f.h0[1], f.h0[2], f.h0[3], bl[q][0], bl[q][1]);
      mma(d[3], f.h1[0], f.h1[1], 0u, 0u, kl, 0u);
#pragma unroll
      for (int q = 0; q < 4; ++q) mma(d[q], f.h0[0], f.h0[1], f.h0[2], f.h0[3], bh[q][0], bh[q][1]);
      mma(d[3], f.h1[0], f.h1[1], 0u, 0u, kh, 0u);
      // C fragment: [0] (g, 2tig), [1] (g, 2tig+1), [2] (g+8, 2tig), [3] (g+8, 2tig+1)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        take(d[0][c], d[1][c], d[2][c], d[3][c], tri + c, best[2 * m]);
        take(d[0][2 + c], d[1][2 + c], d[2][2 + c], d[3][2 + c], tri + c, best[2 * m + 1]);
      }
    }
  }
}

// A ray's t: the min of its 4 lanes' bests (every lane of the warp calls it).
__device__ __forceinline__ float ray_t(float t) {
  t = fminf(t, __shfl_xor_sync(0xffffffffu, t, 1));
  return fminf(t, __shfl_xor_sync(0xffffffffu, t, 2));
}

// The ray's best over its 4 lanes, by (t, index), in every lane.
__device__ __forceinline__ void combine(Best& b) {
#pragma unroll
  for (int o = 1; o < 4; o <<= 1) {
    const Best other{__shfl_xor_sync(0xffffffffu, b.t, o), __shfl_xor_sync(0xffffffffu, b.idx, o),
                     __shfl_xor_sync(0xffffffffu, b.u, o), __shfl_xor_sync(0xffffffffu, b.v, o)};
    if (other.t < b.t || (other.t == b.t && other.idx < b.idx)) b = other;
  }
}

// The lane's slots: slot 2*m + h is ray g + 8*h of m-tile m of its warp,
// `loc` its place among the CTA's rays, `ray` its index (-1 past the tile).
template <int M>
__device__ __forceinline__ void slots_of(int rank, int per_cta, int tile_rays, int ray0,
                                         int (&loc)[2 * M], int (&ray)[2 * M]) {
  const int warp = threadIdx.x >> 5, g = (threadIdx.x & 31) >> 2;
#pragma unroll
  for (int r = 0; r < 2 * M; ++r) {
    loc[r] = warp * 16 * M + 16 * (r / 2) + g + 8 * (r % 2);
    const int local = rank * per_cta + loc[r];
    ray[r] = loc[r] < per_cta && local < tile_rays ? ray0 + local : -1;
  }
}

// Every lane combines its rays' bests; lane tig == h writes ray slot h.
template <int M>
__device__ __forceinline__ void write_out(Best (&best)[2 * M], const int (&ray)[2 * M],
                                          float* __restrict__ out_t, int* __restrict__ out_idx,
                                          float* __restrict__ out_u, float* __restrict__ out_v) {
  const int tig = threadIdx.x & 3;
#pragma unroll
  for (int r = 0; r < 2 * M; ++r) {
    combine(best[r]);
    if (tig == r % 2 && ray[r] >= 0) {
      out_t[ray[r]] = best[r].t;
      out_idx[ray[r]] = best[r].idx;
      out_u[ray[r]] = best[r].u;
      out_v[ray[r]] = best[r].v;
    }
  }
}

// The nf (NF) and list walks over the per-tile lists, as nf_walk.cu's.
template <int SUB, int M, int C, bool NF>
__global__ void __launch_bounds__(kThreads)
    mxu_walk_kernel(const float* __restrict__ phi_t,   // (10, r_pad)
                    const float4* __restrict__ table,  // (n_pad, 80) as float4
                    const int* __restrict__ counts,    // (n_tiles,)
                    const int* __restrict__ lists,     // (n_tiles, ms)
                    const float* __restrict__ emins,   // (n_tiles, ms); nf only
                    float* __restrict__ out_t, int* __restrict__ out_idx,
                    float* __restrict__ out_u, float* __restrict__ out_v,
                    int* __restrict__ walk_stats,  // (n_tiles,) or null
                    int r_pad, int tile_rays, int ms, int groups) {
  constexpr int kBytes = SUB * kTriBytes;
  extern __shared__ __align__(128) float4 dyn[];  // the two staging buffers
  __shared__ Vote slots[2][kMaxSlots];
  __shared__ __align__(8) uint64_t bars[2];

  const int tile = blockIdx.x / C, rank = blockIdx.x % C;
  const int per_cta = (tile_rays + C - 1) / C;
  const int ray0 = tile * tile_rays;
  int loc[2 * M], ray[2 * M];
  slots_of<M>(rank, per_cta, tile_rays, ray0, loc, ray);
  Best best[2 * M];
#pragma unroll
  for (int r = 0; r < 2 * M; ++r) {
    float phi[10];
    best[r] = tpt::load_ray(phi_t, r_pad, ray[r], ray0, phi, NF);
  }
  RayFrag a[M];
  load_frags<M>(phi_t, r_pad, ray, ray0, a);

  int walked = 0;
  const int count = counts[tile];  // the same in every CTA of the tile
  if (count > 0) {  // a tile with an empty list only writes its lanes
    Stager<kBytes> st;
    st.init(dyn, dyn + kBytes / 16, bars);
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
      eval_mxu<SUB, M>(rows, a, s * SUB, best, groups);
      if constexpr (NF) {
        float m = -CUDART_INF_F;
#pragma unroll
        for (int r = 0; r < 2 * M; ++r) {
          const float t = ray_t(best[r].t);
          if (ray[r] >= 0) m = fmaxf(m, t);
        }
        tmax = decide<C>(slots, parity, 0u, m).tmax;
      } else {
        __syncthreads();  // every thread is done with this buffer before it is refilled
      }
      ++walked;
    }
    st.drain();
    if constexpr (NF) cluster_sync<C>();
  }
  if (walk_stats != nullptr && rank == 0 && threadIdx.x == 0) walk_stats[tile] = walked;
  write_out<M>(best, ray, out_t, out_idx, out_u, out_v);
}

// Entry rows: the group's chunks, then a live chunk's subs.
template <int SUB>
__host__ __device__ constexpr int entry_rows() {
  return kGroup + (kChunk / SUB > 1 ? kChunk / SUB : 0);
}

// The cond walk, as cond_walk.cu's, over chunks staged whole.
template <int SUB, int M, int C>
__global__ void __launch_bounds__(kThreads)
    mxu_cond_kernel(const float* __restrict__ phi_t,        // (10, r_pad)
                    const float4* __restrict__ table,       // (n_pad, 80) as float4
                    const float* __restrict__ chunk_boxes,  // (n_chunks, 8)
                    const float* __restrict__ sub_boxes,    // (n_pad / SUB, 8)
                    float* __restrict__ out_t, int* __restrict__ out_idx,
                    float* __restrict__ out_u, float* __restrict__ out_v,
                    int* __restrict__ walk_stats,  // (n_tiles, 2) or null
                    int r_pad, int tile_rays, int n_chunks, int groups) {
  constexpr int kSubs = kChunk / SUB;  // subs a chunk
  constexpr int kBytes = kChunk * kTriBytes;  // 40 KB a chunk
  constexpr int kSubVecs = SUB / 8 * kGroupVecs;
  // the two staging buffers, then this CTA's rays' entry distances,
  // [entry_rows][rays]: rows 0-15 the group's chunks, rows 16.. the
  // current chunk's subs; then their slab data, [9][rays]: ro, 1/rd
  // (`tpt::slab_inv`), rd, which registers cannot spare
  extern __shared__ __align__(128) float4 dyn[];
  __shared__ Vote slots[2][C * kThreads / 32];
  __shared__ __align__(8) uint64_t bars[2];
  const int rays = (blockDim.x >> 5) * 16 * M;  // the CTA's ray slots
  float* entry = reinterpret_cast<float*>(dyn + 2 * (kBytes / 16));
  float* slab = entry + entry_rows<SUB>() * rays;

  const int tile = blockIdx.x / C, rank = blockIdx.x % C;
  const int per_cta = (tile_rays + C - 1) / C;
  const int ray0 = tile * tile_rays;
  const int tig = threadIdx.x & 3;
  int loc[2 * M], ray[2 * M];
  slots_of<M>(rank, per_cta, tile_rays, ray0, loc, ray);
  float rt[2 * M];  // each ray's t, the min over its lanes
  Best best[2 * M];
  bool moving = false;
#pragma unroll
  for (int r = 0; r < 2 * M; ++r) {
    float phi[10], inv[3];
    best[r] = tpt::load_ray(phi_t, r_pad, ray[r], ray0, phi, false);
    rt[r] = best[r].t;
    moving |= ray[r] >= 0 && (fabsf(phi[4]) > 0.f || fabsf(phi[5]) > 0.f || fabsf(phi[6]) > 0.f);
    if (tig == 0) {  // the ray's 4 lanes hold the same ray
      tpt::slab_inv(phi, inv);
#pragma unroll
      for (int f = 0; f < 6; ++f) slab[f * rays + loc[r]] = phi[1 + f];
#pragma unroll
      for (int k = 0; k < 3; ++k) slab[(6 + k) * rays + loc[r]] = inv[k];
    }
  }
  __syncwarp();
  RayFrag a[M];
  load_frags<M>(phi_t, r_pad, ray, ray0, a);

  // Mask bit b's slab tests and re-tests are made by each ray's lane
  // tig == b % 4 alone (`own`); the decisions OR the lanes' bits.
  const uint32_t own = 0x11111111u << tig;
  // Entry distances of this lane's rays to `box`, stored in `row`; the
  // bit: some ray enters before its current t.
  auto enters = [&](const float* box, int row) {
    bool live = false;
#pragma unroll
    for (int r = 0; r < 2 * M; ++r) {
      float phi[10], inv[3];  // slab_entry reads ro (1-3) and rd (4-6)
#pragma unroll
      for (int f = 0; f < 6; ++f) phi[1 + f] = slab[f * rays + loc[r]];
#pragma unroll
      for (int k = 0; k < 3; ++k) inv[k] = slab[(6 + k) * rays + loc[r]];
      const float e = tpt::slab_entry(box, phi, inv);
      entry[row * rays + loc[r]] = e;
      live |= ray[r] >= 0 && e < rt[r];
    }
    return static_cast<uint32_t>(live);
  };
  // The bits of `mask` (entry rows row0 + bit) that some ray of this lane
  // still enters before its current t.
  auto retest = [&](uint32_t mask, int row0) {
    uint32_t out = 0;
    for (uint32_t m = mask & own; m; m &= m - 1) {
      const int b = __ffs(m) - 1;
      bool live = false;
#pragma unroll
      for (int r = 0; r < 2 * M; ++r)
        live |= ray[r] >= 0 && entry[(row0 + b) * rays + loc[r]] < rt[r];
      out |= static_cast<uint32_t>(live) << b;
    }
    return out;
  };
  // Evaluate sub `sub_id` staged at `rows`; the rays' t after it.
  auto evaluate = [&](const float4* rows, int sub_id) {
    eval_mxu<SUB, M>(rows, a, sub_id * SUB, best, groups);
#pragma unroll
    for (int r = 0; r < 2 * M; ++r) rt[r] = ray_t(best[r].t);
  };
  const float kNone = -CUDART_INF_F;  // no decision here needs the tile's max t

  int parity = 0, staged = 0, evaluated = 0;
  Stager<kBytes> st;
  st.init(dyn, dyn + kBytes / 16, bars);
  cluster_sync<C>();
  if (decide<C>(slots, parity, moving, kNone).bits) {  // the tile-alive gate
    for (int g = 0; g < n_chunks; g += kGroup) {
      const int n_in = min(kGroup, n_chunks - g);
      uint32_t bits = 0;
#pragma unroll
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
          evaluate(rows, c);
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
            evaluate(rows + s * kSubVecs, c * kSubs + s);
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
  write_out<M>(best, ray, out_t, out_idx, out_u, out_v);
}

// ---------------------------------------------------------------------------
// Host side.  A shape is Shape{2*M, C, 4}: each lane holds 2*M rays, each
// ray 4 lanes, so walk.cuh's `threads_for` counts the threads.

template <int SUB>
using ListKernel = decltype(&mxu_walk_kernel<SUB, kNfM, kNfCluster, true>);
template <int SUB>
using CondKernel = decltype(&mxu_cond_kernel<SUB, kCondM, kCondCluster>);

// The kept shape, or for a tile too wide for it 1, 2 or (up to `max_m`) 4
// m-tiles a warp over a cluster of 8 (up to 4,096 rays with 2, 8,192 with
// 4).  False if none fits.
inline bool fit_mxu(int tile_rays, Shape& s, int max_m) {
  const Shape tries[] = {s, {2, kMaxCluster, 4}, {4, kMaxCluster, 4}, {8, kMaxCluster, 4}};
  for (const Shape& t : tries)
    if (t.rpt <= 2 * max_m && threads_for(tile_rays, t)) {
      s = t;
      return true;
    }
  return false;
}

// The kept nf (NF) or list design at this tile width: its kernel and
// shape; null if the tile is too wide.
template <int SUB, bool NF>
ListKernel<SUB> kept_list(int tile_rays, Shape& shape) {
  const Shape k = NF ? Shape{2 * kNfM, kNfCluster, 4} : Shape{2 * kListM, kListCluster, 4};
  shape = k;
  if (!fit_mxu(tile_rays, shape, 4)) return nullptr;
  if (shape == k) {
    if constexpr (NF) return mxu_walk_kernel<SUB, kNfM, kNfCluster, true>;
    return mxu_walk_kernel<SUB, kListM, kListCluster, false>;
  }
  if (shape.rpt == 2) return mxu_walk_kernel<SUB, 1, kMaxCluster, NF>;
  if (shape.rpt == 4) return mxu_walk_kernel<SUB, 2, kMaxCluster, NF>;
  return mxu_walk_kernel<SUB, 4, kMaxCluster, NF>;
}

// cond stops at 2 m-tiles a warp (with 4, its kernel spills past the 128
// registers 512 threads leave, and it faulted on the H100; PERF.md): up to
// 4,096 rays over a cluster of 8, and up to 8,192 over a non-portable
// cluster of 16.
template <int SUB>
CondKernel<SUB> kept_cond(int tile_rays, Shape& shape) {
  const Shape k{2 * kCondM, kCondCluster, 4};
  shape = k;
  if (fit_mxu(tile_rays, shape, 2)) {
    if (shape == k) return mxu_cond_kernel<SUB, kCondM, kCondCluster>;
    if (shape.rpt == 2) return mxu_cond_kernel<SUB, 1, kMaxCluster>;
    return mxu_cond_kernel<SUB, 2, kMaxCluster>;
  }
  shape = Shape{4, kWideCluster, 4};
  return threads_for(tile_rays, shape) ? mxu_cond_kernel<SUB, 2, kWideCluster> : nullptr;
}

// Dynamic shared memory: the two staging buffers (cond: and the entry
// distances and slab data of the CTA's rays).
template <int SUB>
size_t list_smem() {
  return size_t(2) * SUB * kTriBytes;
}

template <int SUB>
size_t cond_smem(int threads, const Shape& shape) {
  return size_t(2) * kChunk * kTriBytes +
         sizeof(float) * (entry_rows<SUB>() + 9) * (threads / 32) * 8 * shape.rpt;
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

struct Args {
  const float* phi_t;
  const float4* table;
  const int* counts;       // list walks
  const int* lists;        // list walks
  const float* emins;      // nf
  const float* chunk_boxes;  // cond
  const float* sub_boxes;    // cond
  float* t;
  int* idx;
  float* u;
  float* v;
  int* walk_stats;
  int r_pad, tile_rays, n_tiles, n;  // n: list length (list walks) or chunks (cond)
  cudaStream_t stream;
};

bool valid(const Args& a) {
  return a.tile_rays > 0 && a.n_tiles > 0 && a.n > 0 && a.r_pad == a.n_tiles * a.tile_rays &&
         reinterpret_cast<uintptr_t>(a.table) % 16 == 0;
}

template <bool NF>
int run_list(const Args& a, int sub) {
  if (!valid(a)) return static_cast<int>(cudaErrorInvalidValue);
  return by_sub(sub, [&](auto s) {
    constexpr int SUB = decltype(s)::value;
    Shape shape;
    const ListKernel<SUB> kernel = kept_list<SUB, NF>(a.tile_rays, shape);
    if (kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    return launch_cluster(kernel, a.n_tiles, shape.c, NF ? shape.c : 1,
                          threads_for(a.tile_rays, shape), list_smem<SUB>(), a.stream, a.phi_t,
                          a.table, a.counts, a.lists, a.emins, a.t, a.idx, a.u, a.v,
                          a.walk_stats, a.r_pad, a.tile_rays, a.n, SUB / 8);
  });
}

int run_cond(const Args& a, int sub) {
  if (!valid(a) || sub <= 0 || kChunk % sub) return static_cast<int>(cudaErrorInvalidValue);
  return by_sub(sub, [&](auto s) {
    constexpr int SUB = decltype(s)::value;
    Shape shape;
    const CondKernel<SUB> kernel = kept_cond<SUB>(a.tile_rays, shape);
    if (kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    const int threads = threads_for(a.tile_rays, shape);
    return launch_cluster(kernel, a.n_tiles, shape.c, shape.c, threads,
                          cond_smem<SUB>(threads, shape), a.stream, a.phi_t, a.table,
                          a.chunk_boxes, a.sub_boxes, a.t, a.idx, a.u, a.v, a.walk_stats,
                          a.r_pad, a.tile_rays, a.n, SUB / 8);
  });
}

// The kept design's launch shape: `kind` 0 nf, 1 list, 2 cond.
int shape_of(int kind, int sub, int tile_rays, int* out) {
  return by_sub(sub, [&](auto s) {
    constexpr int SUB = decltype(s)::value;
    Shape shape;
    const void* kernel = nullptr;
    size_t smem = list_smem<SUB>();
    if (kind == 0) kernel = reinterpret_cast<const void*>(kept_list<SUB, true>(tile_rays, shape));
    if (kind == 1) kernel = reinterpret_cast<const void*>(kept_list<SUB, false>(tile_rays, shape));
    if (kind == 2) {
      kernel = reinterpret_cast<const void*>(kept_cond<SUB>(tile_rays, shape));
      smem = cond_smem<SUB>(threads_for(tile_rays, shape), shape);
    }
    if (kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    return describe(kernel, shape, threads_for(tile_rays, shape), smem, out);
  });
}

}  // namespace

// The MXU walks over `_pack_mxu_table`'s table (80 floats a triangle).
// walk_stats, if not null, receives each tile's walk counts: nf and list,
// subs evaluated (T,); cond, chunks staged and subs evaluated (T, 2).
extern "C" int tpt_mt_nf_mxu(const float* phi_t, const float* table, const int* counts,
                             const int* lists, const float* emins, float* t, int* idx,
                             float* u, float* v, int* walk_stats, int r_pad, int tile_rays,
                             int n_tiles, int ms, int sub, cudaStream_t stream) {
  return run_list<true>(Args{phi_t, reinterpret_cast<const float4*>(table), counts, lists, emins,
                             nullptr, nullptr, t, idx, u, v, walk_stats, r_pad, tile_rays,
                             n_tiles, ms, stream},
                        sub);
}

extern "C" int tpt_mt_list_mxu(const float* phi_t, const float* table, const int* counts,
                               const int* lists, float* t, int* idx, float* u, float* v,
                               int* walk_stats, int r_pad, int tile_rays, int n_tiles, int ms,
                               int sub, cudaStream_t stream) {
  return run_list<false>(Args{phi_t, reinterpret_cast<const float4*>(table), counts, lists,
                              nullptr, nullptr, nullptr, t, idx, u, v, walk_stats, r_pad,
                              tile_rays, n_tiles, ms, stream},
                         sub);
}

extern "C" int tpt_mt_cond_mxu(const float* phi_t, const float* table, const float* chunk_boxes,
                               const float* sub_boxes, float* t, int* idx, float* u, float* v,
                               int* walk_stats, int r_pad, int tile_rays, int n_tiles,
                               int n_chunks, int sub, cudaStream_t stream) {
  return run_cond(Args{phi_t, reinterpret_cast<const float4*>(table), nullptr, nullptr, nullptr,
                       chunk_boxes, sub_boxes, t, idx, u, v, walk_stats, r_pad, tile_rays,
                       n_tiles, n_chunks, stream},
                  sub);
}

// The kept designs' launch shapes at this sub and tile width (walk.cuh
// `describe`: rpt (2 x m-tiles a warp), cluster, threads, registers,
// static and dynamic shared bytes, CTAs per SM, clusters resident at
// once, lanes a ray); an error for a tile no shape fits.
extern "C" int tpt_mt_nf_mxu_shape(int sub, int tile_rays, int* out) {
  return shape_of(0, sub, tile_rays, out);
}

extern "C" int tpt_mt_list_mxu_shape(int sub, int tile_rays, int* out) {
  return shape_of(1, sub, tile_rays, out);
}

extern "C" int tpt_mt_cond_mxu_shape(int sub, int tile_rays, int* out) {
  return shape_of(2, sub, tile_rays, out);
}
