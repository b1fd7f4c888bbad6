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
// Everything here is a first design kept for comparison only, launched by
// chip_smoke.py and the card tests beside its Hopper redesign and by no
// render path: the FP32 list walk (`tpt_mt_list_v1`; redesigned in
// nf_walk.cu), the FP32 cond walk (`tpt_mt_cond_v1`; cond_walk.cu), and
// the MXU variants of all three below (`tpt_mt_{nf,list,cond}_mxu_v1`;
// mxu_walk.cu).
//
// Design: one block per ray tile, each thread owning RPT rays of the tile
// (RPT = 1 at the default 512-ray tile), each ray's best (t, idx, u, v) in
// registers.  list stages each listed sub's 4 x SUB x 10 coefficient rows
// in shared memory; every thread then evaluates its rays against the SUB
// triangles, reading the coefficients as warp-wide broadcasts.
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
// decisions equal the plain PyTorch versions bit for bit.

#include <cstdint>
#include <type_traits>

#include "mt_common.cuh"

namespace {

using tpt::Best;
using tpt::kInf;
using tpt::kMaxThreads;

constexpr int kChunk = 128;  // the cond kernel's chunk (and padding granule)

template <int N>
using Int = std::integral_constant<int, N>;

// The list walk over the per-tile lists: every entry, in list order.
template <int RPT, int SUB>
__global__ void __launch_bounds__(kMaxThreads)
    mt_list_kernel(const float* __restrict__ phi_t,      // (10, r_pad)
                   const float* __restrict__ cols_rows,  // (4*n_pad, 10)
                   const int* __restrict__ counts,       // (n_tiles,)
                   const int* __restrict__ lists,        // (n_tiles, ms)
                   float* __restrict__ out_t, int* __restrict__ out_idx,
                   float* __restrict__ out_u, float* __restrict__ out_v,
                   int r_pad, int tile_rays, int ms) {
  __shared__ float rows[4 * SUB * 10];

  const int tile = blockIdx.x;
  const int tid = threadIdx.x;

  float phi[RPT][10];
  Best best[RPT];
  int ray[RPT];
#pragma unroll
  for (int k = 0; k < RPT; ++k) {
    const int lane = tid + k * blockDim.x;
    ray[k] = lane < tile_rays ? tile * tile_rays + lane : -1;
    best[k] = tpt::load_ray(phi_t, r_pad, ray[k], tile * tile_rays, phi[k], false);
  }

  const int count = counts[tile];
  for (int j = 0; j < count; ++j) {
    const int s = lists[tile * ms + j];
    const float* src = cols_rows + static_cast<size_t>(s) * (4 * SUB * 10);
    __syncthreads();  // the previous sub's rows are no longer read
    for (int i = tid; i < 4 * SUB * 10; i += blockDim.x) rows[i] = src[i];
    __syncthreads();

#pragma unroll
    for (int k = 0; k < RPT; ++k)
      if (ray[k] >= 0) tpt::eval_sub<SUB>(rows, phi[k], s * SUB, best[k]);
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

int launch_list(const float* phi_t, const float* cols_rows, const int* counts,
                const int* lists, float* t, int* idx, float* u, float* v, int r_pad,
                int tile_rays, int n_tiles, int ms, int sub, cudaStream_t stream) {
  if (tile_rays <= 0 || n_tiles <= 0 || ms <= 0 || r_pad != n_tiles * tile_rays)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool ok = by_shape(tile_rays, sub, [&](auto rpt, auto s) {
    constexpr int RPT = decltype(rpt)::value, SUB = decltype(s)::value;
    mt_list_kernel<RPT, SUB><<<n_tiles, threads_for(tile_rays, RPT), 0, stream>>>(
        phi_t, cols_rows, counts, lists, t, idx, u, v, r_pad, tile_rays, ms);
  });
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// MXU variants of the three walks (kernel #5, `_mt_mxu_block`): each
// sub-treelet's four determinants are one matrix product on the tensor
// cores instead of the per-thread term loops.
//
// The TPU takes (4*SUB, 10) @ (10, TR) at Precision.HIGHEST; here the
// counterpart is 3xTF32 `mma.sync.m16n8k8`: each operand x splits into
// hi = tf32(x) and lo = tf32(x - hi) (round to nearest, ties away), and the
// products accumulate in f32 as lo*hi + hi*lo, then hi*hi, which keeps
// about float32's precision (one TF32 pass keeps about 3 digits and would
// flip hit decisions).  K = 10 features pads to 16 with zero columns.
//
// Layout: the wrapper (`_pack_mma`) repacks the coefficient table so that,
// per 8-triangle group, the first m16 tile holds a and ua of the 8
// triangles and the second va and ta, already in A-fragment order (16
// registers x 32 lanes).  Rays are the N dimension, 8 per n-tile.  Lane l
// of a warp then holds, in its two C fragments, all four determinants of
// triangle l/4 of the group for rays 2*(l%4) and 2*(l%4)+1, runs the FP32
// kernels' epilogue (`tpt::take_pair`) on them in registers, and the
// lowest-index nearest hit over the 8 lanes holding the same rays is
// reduced with __shfl_xor (4, 8, 16).
//
// One block of 512 threads per ray tile, for any tile width: the tile's
// best (t, idx, u, v) lives in shared memory, each warp walks n-tiles
// w, w + 16, ... of the tile, and the staged sub-treelet's hi and lo
// fragments (512 bytes a triangle) sit beside it.  The walk order,
// near-to-far break, tile-alive gate, cond's __syncthreads_or culling and
// the take rule are those of the FP32 kernels above.  What bounds it on the
// H100: the tensor-core products are 3 x 2 x 16 x 16 x 8 flops per 8x8
// pairs (the 495 TFLOP/s TF32 rate); the epilogue (5 FP32 operations a
// pair on the 67 TFLOP/s FP32 path) and the fragment loads from shared
// memory cost more.  Kept simple: no wgmma, no TMA, fragments re-read
// for each n-tile.

namespace mxu {

constexpr int kThreads = kMaxThreads;
constexpr int kGroupWords = 16 * 32;  // one 8-triangle group of the table

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(__fsub_rn(x, __uint_as_float(hi)));
}

// d += a * b on one m16n8k8 tile: tf32 operands, f32 accumulator.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The block's dynamic shared memory: the staged sub-treelet's fragments
// (hi, lo: [SUB/8][16][32]) and the tile's best state ([tile_rays] each).
struct Smem {
  uint32_t* hi;
  uint32_t* lo;
  float* t;
  int* idx;
  float* u;
  float* v;
};

__device__ __forceinline__ Smem carve(unsigned char* base, int sub,
                                      int tile_rays) {
  Smem s;
  const int words = sub / 8 * kGroupWords;
  s.hi = reinterpret_cast<uint32_t*>(base);
  s.lo = s.hi + words;
  s.t = reinterpret_cast<float*>(s.lo + words);
  s.idx = reinterpret_cast<int*>(s.t + tile_rays);
  s.u = reinterpret_cast<float*>(s.idx + tile_rays);
  s.v = s.u + tile_rays;
  return s;
}

size_t smem_bytes(int sub, int tile_rays) {
  return size_t(2) * sub / 8 * kGroupWords * 4 + size_t(16) * tile_rays;
}

// Every ray of the tile starts as `tpt::load_ray` starts it.
__device__ void init_best(const float* __restrict__ phi_t, int r_pad,
                          int ray0, int tile_rays, const Smem& s, bool park) {
  for (int i = threadIdx.x; i < tile_rays; i += blockDim.x) {
    float phi[10];
    const Best b = tpt::load_ray(phi_t, r_pad, ray0 + i, ray0, phi, park);
    s.t[i] = b.t;
    s.idx[i] = b.idx;
    s.u[i] = b.u;
    s.v[i] = b.v;
  }
}

__device__ void write_out(const Smem& s, int ray0, int tile_rays,
                          float* __restrict__ out_t, int* __restrict__ out_idx,
                          float* __restrict__ out_u, float* __restrict__ out_v) {
  for (int i = threadIdx.x; i < tile_rays; i += blockDim.x) {
    out_t[ray0 + i] = s.t[i];
    out_idx[ray0 + i] = s.idx[i];
    out_u[ray0 + i] = s.u[i];
    out_v[ray0 + i] = s.v[i];
  }
}

// Copy sub-treelet `sub_id`'s fragments to shared memory, split in hi, lo.
template <int SUB>
__device__ void stage(const float* __restrict__ table, int sub_id,
                      const Smem& s) {
  constexpr int kVec = SUB / 8 * kGroupWords / 4;
  const float4* src = reinterpret_cast<const float4*>(table) +
                      static_cast<size_t>(sub_id) * kVec;
  for (int i = threadIdx.x; i < kVec; i += blockDim.x) {
    const float4 x = src[i];
    uint4 hi, lo;
    split(x.x, hi.x, lo.x);
    split(x.y, hi.y, lo.y);
    split(x.z, hi.z, lo.z);
    split(x.w, hi.w, lo.w);
    reinterpret_cast<uint4*>(s.hi)[i] = hi;
    reinterpret_cast<uint4*>(s.lo)[i] = lo;
  }
}

// Evaluate the staged sub-treelet (first triangle s0) against every ray of
// the tile and fold each ray's nearest hit into the tile's best state.
// Returns the largest best t of the rays this thread folded (-inf if none),
// for nf's tile bound.
template <int SUB>
__device__ float eval_staged(const Smem& s, const float* __restrict__ phi_t,
                             int r_pad, int ray0, int tile_rays, int s0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, tig = lane & 3;
  float m = -CUDART_INF_F;
  for (int nt = threadIdx.x >> 5; nt < tile_rays / 8; nt += blockDim.x >> 5) {
    // B fragments: features tig, tig+4 (k-step 0), 8+tig, 12+tig (k-step
    // 1) of ray nt*8 + g; features 10-15 are zero
    const float* p = phi_t + ray0 + nt * 8 + g;
    uint32_t bh[2][2], bl[2][2];
    split(p[tig * r_pad], bh[0][0], bl[0][0]);
    split(p[(tig + 4) * r_pad], bh[0][1], bl[0][1]);
    split(tig < 2 ? p[(tig + 8) * r_pad] : 0.f, bh[1][0], bl[1][0]);
    bh[1][1] = bl[1][1] = 0u;

    Best near[2] = {{kInf, 0x7fffffff, 0.f, 0.f}, {kInf, 0x7fffffff, 0.f, 0.f}};
    for (int grp = 0; grp < SUB / 8; ++grp) {
      const uint32_t* hi = s.hi + grp * kGroupWords + lane;
      const uint32_t* lo = s.lo + grp * kGroupWords + lane;
      float d[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        uint32_t ah[2][4], al[2][4];
#pragma unroll
        for (int k = 0; k < 2; ++k)
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            ah[k][r] = hi[(mt * 8 + k * 4 + r) * 32];
            al[k][r] = lo[(mt * 8 + k * 4 + r) * 32];
          }
#pragma unroll
        for (int i = 0; i < 4; ++i) d[mt][i] = 0.f;
#pragma unroll
        for (int k = 0; k < 2; ++k) mma(d[mt], al[k], bh[k]);
#pragma unroll
        for (int k = 0; k < 2; ++k) mma(d[mt], ah[k], bl[k]);
#pragma unroll
        for (int k = 0; k < 2; ++k) mma(d[mt], ah[k], bh[k]);
      }
      // rows g / g+8 of tile 0: a / ua, of tile 1: va / ta; columns 2*tig+c
#pragma unroll
      for (int c = 0; c < 2; ++c)
        tpt::take_pair(d[0][c], d[0][2 + c], d[1][c], d[1][2 + c],
                       s0 + grp * 8 + g, near[c]);
    }
#pragma unroll
    for (int c = 0; c < 2; ++c) {
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) {
        const Best other{__shfl_xor_sync(0xffffffffu, near[c].t, o),
                         __shfl_xor_sync(0xffffffffu, near[c].idx, o),
                         __shfl_xor_sync(0xffffffffu, near[c].u, o),
                         __shfl_xor_sync(0xffffffffu, near[c].v, o)};
        if (other.t < near[c].t ||
            (other.t == near[c].t && other.idx < near[c].idx))
          near[c] = other;
      }
      if (g == 0) {
        const int i = nt * 8 + 2 * tig + c;
        Best best{s.t[i], s.idx[i], s.u[i], s.v[i]};
        tpt::fold(near[c], best);
        s.t[i] = best.t;
        s.idx[i] = best.idx;
        s.u[i] = best.u;
        s.v[i] = best.v;
        m = fmaxf(m, best.t);
      }
    }
  }
  return m;
}

// Whether any ray of the tile enters `box` before its current t.
__device__ bool any_live(const float* box, const float* __restrict__ phi_t,
                         int r_pad, int ray0, int tile_rays, const Smem& s) {
  bool live = false;
  for (int i = threadIdx.x; i < tile_rays; i += blockDim.x) {
    float phi[10], inv[3];
#pragma unroll
    for (int f = 1; f < 7; ++f) phi[f] = phi_t[f * r_pad + ray0 + i];
    tpt::slab_inv(phi, inv);
    live |= tpt::slab_entry(box, phi, inv) < s.t[i];
  }
  return live;
}

// nf (NF = true) and list (NF = false) walks.
template <int SUB, bool NF>
__global__ void __launch_bounds__(kThreads)
    mt_list_kernel(const float* __restrict__ phi_t,  // (10, r_pad)
                   const float* __restrict__ table,  // (4*n_pad, 16)
                   const int* __restrict__ counts, const int* __restrict__ lists,
                   const float* __restrict__ emins,
                   float* __restrict__ out_t, int* __restrict__ out_idx,
                   float* __restrict__ out_u, float* __restrict__ out_v,
                   int r_pad, int tile_rays, int ms) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float warp_max[kMaxThreads / 32];
  __shared__ float tile_max;
  const Smem s = carve(smem, SUB, tile_rays);
  const int tile = blockIdx.x, ray0 = tile * tile_rays;
  init_best(phi_t, r_pad, ray0, tile_rays, s, NF);

  const int count = counts[tile];
  float tmax = kInf;
  for (int j = 0; j < count; ++j) {
    if constexpr (NF) {
      if (!(emins[tile * ms + j] < tmax)) break;
    }
    const int sub_id = lists[tile * ms + j];
    __syncthreads();  // best initialised; the previous fragments no longer read
    stage<SUB>(table, sub_id, s);
    __syncthreads();
    const float m = eval_staged<SUB>(s, phi_t, r_pad, ray0, tile_rays, sub_id * SUB);
    if constexpr (NF) tmax = tpt::block_max(m, warp_max, &tile_max);
  }
  __syncthreads();
  write_out(s, ray0, tile_rays, out_t, out_idx, out_u, out_v);
}

// cond: two-level culling over every chunk, in index order.
template <int SUB>
__global__ void __launch_bounds__(kThreads)
    mt_cond_kernel(const float* __restrict__ phi_t,  // (10, r_pad)
                   const float* __restrict__ table,  // (4*n_pad, 16)
                   const float* __restrict__ chunk_boxes,
                   const float* __restrict__ sub_boxes,
                   float* __restrict__ out_t, int* __restrict__ out_idx,
                   float* __restrict__ out_u, float* __restrict__ out_v,
                   int* __restrict__ walk_stats, int r_pad, int tile_rays,
                   int n_chunks) {
  constexpr int kSubsPerChunk = kChunk / SUB;
  extern __shared__ __align__(16) unsigned char smem[];
  const Smem s = carve(smem, SUB, tile_rays);
  const int tile = blockIdx.x, ray0 = tile * tile_rays;
  init_best(phi_t, r_pad, ray0, tile_rays, s, false);
  bool moving = false;
  for (int i = threadIdx.x; i < tile_rays; i += blockDim.x)
    moving |= fabsf(phi_t[4 * r_pad + ray0 + i]) > 0.f ||
              fabsf(phi_t[5 * r_pad + ray0 + i]) > 0.f ||
              fabsf(phi_t[6 * r_pad + ray0 + i]) > 0.f;

  int live_chunks = 0, evaluated = 0;
  if (__syncthreads_or(moving)) {  // the tile-alive gate
    for (int c = 0; c < n_chunks; ++c) {
      if (!__syncthreads_or(any_live(chunk_boxes + c * 8, phi_t, r_pad, ray0, tile_rays, s)))
        continue;
      ++live_chunks;
      for (int k = 0; k < kSubsPerChunk; ++k) {
        const int sub_id = c * kSubsPerChunk + k;
        // a 128-triangle sub is the chunk: the chunk test already decided
        if (kSubsPerChunk > 1 &&
            !__syncthreads_or(any_live(sub_boxes + sub_id * 8, phi_t, r_pad, ray0, tile_rays, s)))
          continue;
        ++evaluated;
        stage<SUB>(table, sub_id, s);
        __syncthreads();
        eval_staged<SUB>(s, phi_t, r_pad, ray0, tile_rays, sub_id * SUB);
        __syncthreads();  // best t settled for the next test; fragments free
      }
    }
  }
  if (walk_stats != nullptr && threadIdx.x == 0) {
    walk_stats[tile * 2 + 0] = live_chunks;
    walk_stats[tile * 2 + 1] = evaluated;
  }
  __syncthreads();
  write_out(s, ray0, tile_rays, out_t, out_idx, out_u, out_v);
}

// Calls f(Int<SUB>) for a supported sub-treelet size; false if none.
template <typename F>
bool by_sub(int sub, F&& f) {
  switch (sub) {
    case 8: f(Int<8>{}); return true;
    case 16: f(Int<16>{}); return true;
    case 32: f(Int<32>{}); return true;
    case 64: f(Int<64>{}); return true;
    case 128: f(Int<128>{}); return true;
    default: return false;
  }
}

// Launch `kernel` with the dynamic shared memory this shape needs.
template <typename K, typename... Args>
int launch(K kernel, int n_tiles, int sub, int tile_rays, cudaStream_t stream,
           Args... args) {
  const size_t smem = smem_bytes(sub, tile_rays);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<n_tiles, kThreads, smem, stream>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

template <bool NF>
int launch_list(const float* phi_t, const float* table, const int* counts,
                const int* lists, const float* emins, float* t, int* idx,
                float* u, float* v, int r_pad, int tile_rays, int n_tiles,
                int ms, int sub, cudaStream_t stream) {
  if (tile_rays <= 0 || tile_rays % 8 || n_tiles <= 0 || ms <= 0 ||
      r_pad != n_tiles * tile_rays)
    return static_cast<int>(cudaErrorInvalidValue);
  int err = static_cast<int>(cudaErrorInvalidValue);
  by_sub(sub, [&](auto s) {
    constexpr int SUB = decltype(s)::value;
    err = launch(mt_list_kernel<SUB, NF>, n_tiles, sub, tile_rays, stream, phi_t,
                 table, counts, lists, emins, t, idx, u, v, r_pad, tile_rays, ms);
  });
  return err;
}

// The most dynamic shared memory one block of the MXU kernels may take on
// `device`: the card's opt-in limit less the largest static shared memory
// of the three kernels (which does not depend on SUB).
int smem_limit(int device, size_t* limit) {
  int optin = 0;
  cudaError_t err =
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  size_t static_bytes = 0;
  const void* kernels[] = {reinterpret_cast<const void*>(mt_list_kernel<8, true>),
                           reinterpret_cast<const void*>(mt_list_kernel<8, false>),
                           reinterpret_cast<const void*>(mt_cond_kernel<8>)};
  for (const void* k : kernels) {
    cudaFuncAttributes attr;
    if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, k);
    if (err == cudaSuccess && attr.sharedSizeBytes > static_bytes)
      static_bytes = attr.sharedSizeBytes;
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  *limit = static_cast<size_t>(optin) - static_bytes;
  return 0;
}

}  // namespace mxu

}  // namespace

extern "C" int tpt_mt_list_v1(const float* phi_t, const float* cols_rows,
                              const int* counts, const int* lists, float* t,
                              int* idx, float* u, float* v, int r_pad,
                              int tile_rays, int n_tiles, int ms, int sub,
                              cudaStream_t stream) {
  return launch_list(phi_t, cols_rows, counts, lists, t, idx, u, v, r_pad,
                     tile_rays, n_tiles, ms, sub, stream);
}

extern "C" int tpt_mt_cond_v1(const float* phi_t, const float* cols_rows,
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

extern "C" int tpt_mt_nf_mxu_v1(const float* phi_t, const float* table,
                                const int* counts, const int* lists,
                                const float* emins, float* t, int* idx, float* u,
                                float* v, int r_pad, int tile_rays, int n_tiles,
                                int ms, int sub, cudaStream_t stream) {
  return mxu::launch_list<true>(phi_t, table, counts, lists, emins, t, idx, u,
                                v, r_pad, tile_rays, n_tiles, ms, sub, stream);
}

extern "C" int tpt_mt_list_mxu_v1(const float* phi_t, const float* table,
                                  const int* counts, const int* lists, float* t,
                                  int* idx, float* u, float* v, int r_pad,
                                  int tile_rays, int n_tiles, int ms, int sub,
                                  cudaStream_t stream) {
  return mxu::launch_list<false>(phi_t, table, counts, lists, nullptr, t, idx,
                                 u, v, r_pad, tile_rays, n_tiles, ms, sub,
                                 stream);
}

extern "C" int tpt_mt_cond_mxu_v1(const float* phi_t, const float* table,
                                  const float* chunk_boxes, const float* sub_boxes,
                                  float* t, int* idx, float* u, float* v,
                                  int* walk_stats, int r_pad, int tile_rays,
                                  int n_tiles, int n_chunks, int sub,
                                  cudaStream_t stream) {
  if (tile_rays <= 0 || tile_rays % 8 || n_tiles <= 0 || n_chunks <= 0 ||
      r_pad != n_tiles * tile_rays)
    return static_cast<int>(cudaErrorInvalidValue);
  int err = static_cast<int>(cudaErrorInvalidValue);
  mxu::by_sub(sub, [&](auto s) {
    constexpr int SUB = decltype(s)::value;
    err = mxu::launch(mxu::mt_cond_kernel<SUB>, n_tiles, sub, tile_rays,
                      stream, phi_t, table, chunk_boxes, sub_boxes, t, idx, u,
                      v, walk_stats, r_pad, tile_rays, n_chunks);
  });
  return err;
}

// Dynamic shared memory of one first-design MXU block at this shape, and
// the most the card allows (the wrappers check the one against the other).
extern "C" size_t tpt_mxu_smem_bytes(int sub, int tile_rays) {
  return mxu::smem_bytes(sub, tile_rays);
}

extern "C" int tpt_mxu_smem_limit(int device, size_t* limit) {
  return mxu::smem_limit(device, limit);
}

extern "C" const char* tpt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
