// Round-2 Möller–Trumbore intersection with one level of chunk culling, for
// Hopper (sm_90a): the first design, `tpt_mt_r2_v1`, kept only to compare
// its redesign (r2_walk.cu, which both wrappers launch) with; the
// wrapper's `_walk_cuda_v1` alone launches it.
//
// It computes what the TPU kernels in tpu_pathtracer/ops/pallas/
// mt_intersect.py compute:
//   * `_kernel` (behind `mt_intersect_pallas`, up to 8,192 triangles): per
//     1,024-ray tile, slab-test every chunk box and evaluate a chunk only if
//     some lane enters its box before its running best t; the coefficient
//     table is quantity-major, (4 * n_pad, 10);
//   * `_kernel_stream` (behind `mt_intersect_stream`, up to 131,072): the
//     same walk over a chunk-major table, (n_chunks, 4 * C, 10), where the
//     TPU double-buffers every chunk into VMEM by async DMA.
// The Python wrapper (ops/kernels/mt_intersect.py) pads triangles to a
// multiple of the chunk C (8..128), rays to a multiple of 1,024 (with 1e30
// in all ten features) and builds one box per chunk; this file walks them.
//
// What it computes is not the near-to-far kernels' epilogue (`eval_sub` in
// mt_common.cuh): f = 1/a where |a| >= EPSILON (else 1), t = ta * f, and the
// validity test is the divided t > EPSILON, where nf tests ts > EPSILON*|a|;
// the winner's u = ua * f, v = va * f.  Chunks go in ascending order, a
// chunk's lowest row among its smallest t wins it, and it replaces the best
// only if strictly nearer, so the lowest triangle index wins exact-t ties.
// Every lane (padding lanes too) starts at t = INF and takes part in the
// votes, as on the TPU.
//
// Design: one block of 512 threads per tile, two rays a thread, each ray's
// best (t, idx, u, v) in registers.  Entry distances do not depend on t, so
// each chunk's is computed just before it is needed (the TPU keeps an (M,
// 1024) scratch of them) and kept one chunk ahead.  The liveness vote is
// `__syncthreads_or(entry < best t)`.  A live chunk's 4 x C x 10 rows (20 KB
// at C = 128) are staged in shared memory and every thread evaluates its
// rays against them, reading the rows as warp-wide broadcasts.
//   * pallas: the live chunk is loaded with 16-byte loads after its vote;
//     the whole table (at most 1.3 MB) stays in L2.
//   * stream: a two-slot shared-memory ring filled by `cp.async`.  While
//     chunk c is evaluated, chunk c+1 is in flight, but only if some lane
//     enters box c+1 before its t as it stands before chunk c: t only falls,
//     so a chunk that is dead then stays dead, and its copy is skipped
//     (the TPU copies every chunk).
// Both write per-tile walk counts (chunks evaluated, chunks copied), which
// the plain version reproduces: culling that is wrong does not show in the
// hits on random soups.
//
// What bounds it on the H100: fp32 ALU work per (ray, triangle) pair of the
// evaluated chunks (19 products and 15 sums for the determinants, 2 sign
// products, a correctly rounded reciprocal, 1 product for t and 1 sum for
// u + v: 40 operations, plus 6 compares), and one barrier per chunk and tile
// (two for stream).  The table is read from L2.  Kept exact rather than
// fast: built with -fmad=false, determinants summed in `_FEATS` order with
// __fmul_rn / __fadd_rn, slab math as `_slab_entries` (mt_common.cuh), so
// results and walk counts equal the plain PyTorch version bit for bit.

#include "mt_common.cuh"

namespace {

using tpt::Best;
using tpt::kEpsilon;
using tpt::kInf;

constexpr int kTile = 1024;      // rays per tile
constexpr int kThreads = 512;    // threads per block
constexpr int kRpt = kTile / kThreads;
constexpr int kMaxChunk = 128;   // triangles per chunk, at most
constexpr int kChunkFloats = 4 * kMaxChunk * 10;  // 20 KB

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// One ray against a staged chunk (`rows`: [4][chunk][10], quantity-major
// inside the chunk, first triangle c0), round-2 epilogue; the chunk's
// nearest valid pair replaces `best` only if strictly nearer.
__device__ __forceinline__ void eval_chunk(const float* __restrict__ rows,
                                           int chunk, const float phi[10],
                                           int c0, Best& best) {
  float st = kInf;  // the chunk's smallest t, lowest row on ties
  int si = 0;
  float su = 0.f, sv = 0.f;
  for (int i = 0; i < chunk; ++i) {
    const float* ca = rows + (0 * chunk + i) * 10;
    const float* cu = rows + (1 * chunk + i) * 10;
    const float* cv = rows + (2 * chunk + i) * 10;
    const float* ct = rows + (3 * chunk + i) * 10;
    // determinants, summed in FEATS order: a (4,5,6), ua/va (4..9), ta (0..3)
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

    // validity in the divided form (t > EPSILON)
    const float abs_a = fabsf(a);
    const float sa = a > 0.f ? 1.f : (a < 0.f ? -1.f : 0.f);
    const float us = __fmul_rn(ua, sa);
    const float vs = __fmul_rn(va, sa);
    const bool ok = abs_a >= kEpsilon;
    const float f = ok ? __frcp_rn(a) : 1.f;
    const float t_raw = __fmul_rn(ta, f);
    const bool valid = ok && us >= 0.f && us <= abs_a && vs >= 0.f &&
                       __fadd_rn(us, vs) <= abs_a && t_raw > kEpsilon;
    const float t = valid ? t_raw : kInf;
    if (t < st) {
      st = t;
      si = i;
      // + 0: the TPU kernel sums the winner's u over the chunk's rows, all
      // others 0.0, which turns a -0.0 into +0.0
      su = __fadd_rn(__fmul_rn(ua, f), 0.f);
      sv = __fadd_rn(__fmul_rn(va, f), 0.f);
    }
  }
  if (st < best.t) best = Best{st, c0 + si, su, sv};
}

// Whether any of this thread's rays has `entry` below its current t.
__device__ __forceinline__ bool any_below(const float (&entry)[kRpt],
                                          const Best (&best)[kRpt]) {
  bool live = false;
#pragma unroll
  for (int k = 0; k < kRpt; ++k) live |= entry[k] < best[k].t;
  return live;
}

template <bool STREAM>
__global__ void __launch_bounds__(kThreads)
    mt_r2_kernel(const float* __restrict__ phi_t,  // (10, r_pad)
                 const float* __restrict__ rows,   // see the file comment
                 const float* __restrict__ boxes,  // (n_chunks, 8)
                 float* __restrict__ out_t, int* __restrict__ out_idx,
                 float* __restrict__ out_u, float* __restrict__ out_v,
                 int* __restrict__ walk_stats,  // (n_tiles, 2) or null
                 int r_pad, int n_chunks, int chunk) {
  __shared__ __align__(16) float smem[(STREAM ? 2 : 1) * kChunkFloats];
  const int tile = blockIdx.x;
  const int tid = threadIdx.x;
  const int chunk_floats = 40 * chunk;
  const int n_pad = n_chunks * chunk;

  float phi[kRpt][10];
  float inv[kRpt][3];
  Best best[kRpt];
  float entry[kRpt];
#pragma unroll
  for (int k = 0; k < kRpt; ++k) {
    best[k] = tpt::load_ray(phi_t, r_pad, tile * kTile + tid + k * kThreads, 0,
                            phi[k], false);
    tpt::slab_inv(phi[k], inv[k]);
    entry[k] = tpt::slab_entry(boxes, phi[k], inv[k]);
  }

  // Issue the copies of chunk c into ring slot c & 1 (stream only).
  auto prefetch = [&](int c) {
    const float4* src = reinterpret_cast<const float4*>(
        rows + static_cast<size_t>(c) * chunk_floats);
    float4* dst = reinterpret_cast<float4*>(smem + (c & 1) * kChunkFloats);
    for (int i = tid; i < chunk_floats / 4; i += kThreads) cp_async16(dst + i, src + i);
  };

  int evaluated = 0, copied = 0;  // block-uniform walk counts
  if constexpr (STREAM) {
    if (__syncthreads_or(any_below(entry, best))) {
      prefetch(0);
      ++copied;
    }
    cp_async_commit();
  }
  for (int c = 0; c < n_chunks; ++c) {
    // a barrier too: every thread is done with chunk c-1's rows
    const bool live = __syncthreads_or(any_below(entry, best));
    if (c + 1 < n_chunks) {
#pragma unroll
      for (int k = 0; k < kRpt; ++k)
        entry[k] = tpt::slab_entry(boxes + (c + 1) * 8, phi[k], inv[k]);
    }
    if constexpr (STREAM) {
      // slot (c+1) & 1 held chunk c-1: the vote above retired its readers,
      // and each thread waits for its own copies into it (chunk c-1 may
      // have been copied and then found dead) before writing it again
      if (c + 1 < n_chunks && __syncthreads_or(any_below(entry, best))) {
        cp_async_wait<1>();
        prefetch(c + 1);
        ++copied;
      }
      cp_async_commit();  // one group per chunk, empty when skipped
    }
    if (!live) continue;
    ++evaluated;
    const float* staged = smem;
    if constexpr (STREAM) {
      cp_async_wait<1>();  // all but the newest group (chunk c+1) landed
      __syncthreads();
      staged = smem + (c & 1) * kChunkFloats;
    } else {
      // quantity q of chunk c: rows q * n_pad + c * chunk .. + chunk - 1
      const int q_floats4 = chunk_floats / 16;
      float4* dst = reinterpret_cast<float4*>(smem);
      for (int i = tid; i < 4 * q_floats4; i += kThreads) {
        const int q = i / q_floats4;
        const float4* src = reinterpret_cast<const float4*>(
            rows + (static_cast<size_t>(q) * n_pad + static_cast<size_t>(c) * chunk) * 10);
        dst[i] = src[i - q * q_floats4];
      }
      __syncthreads();
    }
#pragma unroll
    for (int k = 0; k < kRpt; ++k) eval_chunk(staged, chunk, phi[k], c * chunk, best[k]);
  }
  if constexpr (STREAM) cp_async_wait<0>();  // no copy outlives the block

  if (walk_stats != nullptr && tid == 0) {
    walk_stats[tile * 2 + 0] = evaluated;
    walk_stats[tile * 2 + 1] = STREAM ? copied : evaluated;
  }
#pragma unroll
  for (int k = 0; k < kRpt; ++k) {
    const int ray = tile * kTile + tid + k * kThreads;
    out_t[ray] = best[k].t;
    out_idx[ray] = best[k].idx;
    out_u[ray] = best[k].u;
    out_v[ray] = best[k].v;
  }
}

}  // namespace

extern "C" int tpt_mt_r2_v1(const float* phi_t, const float* rows,
                         const float* boxes, float* t, int* idx, float* u,
                         float* v, int* walk_stats, int r_pad, int n_chunks,
                         int chunk, int stream, cudaStream_t s) {
  if (r_pad <= 0 || r_pad % kTile || n_chunks <= 0 || chunk <= 0 ||
      chunk > kMaxChunk || chunk % 8)
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_tiles = r_pad / kTile;
  if (stream)
    mt_r2_kernel<true><<<n_tiles, kThreads, 0, s>>>(
        phi_t, rows, boxes, t, idx, u, v, walk_stats, r_pad, n_chunks, chunk);
  else
    mt_r2_kernel<false><<<n_tiles, kThreads, 0, s>>>(
        phi_t, rows, boxes, t, idx, u, v, walk_stats, r_pad, n_chunks, chunk);
  return static_cast<int>(cudaGetLastError());
}
