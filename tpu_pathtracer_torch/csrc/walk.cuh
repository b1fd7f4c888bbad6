// Device code shared by the Hopper walks of the near-to-far and list
// (nf_walk.cu), streamed (stream_walk.cu), in-kernel culling (cond_walk.cu),
// MXU-determinant (mxu_walk.cu) and round-2 (r2_walk.cu) Möller–Trumbore
// kernels: the packed coefficient table, the tile-wide decisions across a
// thread block cluster, and the bulk-copy staging.
//
// The FP32 walks' arithmetic is mt_common.cuh's: one rounding per
// operation, sums in `_FEATS` order, `take_pair`'s epilogue (round 2:
// `take_pair_r2`'s), so they stay bit-equal to their plain PyTorch
// versions.

#pragma once

#include <cooperative_groups.h>

#include <climits>
#include <cstdint>
#include <type_traits>

#include "mt_common.cuh"

namespace tpt {
namespace walk {

namespace cg = cooperative_groups;

// The walk table (ops/kernels/mt_shade.py `_pack_walk_table`): per
// triangle, the 19 coefficients a pair uses, in `_FEATS` order, padded to
// 20 floats (5 x float4):
//   [a4 a5 a6 ua4 | ua5 ua6 ua7 ua8 | ua9 va4 va5 va6 | va7 va8 va9 ta0 | ta1 ta2 ta3 0]
// Rows are in triangle order, so a sub-treelet (or a 128-triangle chunk)
// is one contiguous block.
constexpr int kTableFloats = 20;
constexpr int kTableVecs = kTableFloats / 4;
constexpr int kThreads = 512;    // most threads of one CTA
constexpr int kMaxCluster = 8;   // the portable cluster size
constexpr int kMaxSlots = kMaxCluster * kThreads / 32;
constexpr int kWideCluster = 16;  // the largest cluster, non-portable (Hopper)

// Evaluate the staged block `tris` (n triangles of the walk table, SUB
// unless given, in shared memory; the first is triangle s0) against a
// thread's RPT rays under the epilogue `Pair` (mt_common.cuh `PairNf` or
// `PairR2`) and fold each ray's nearest valid hit into its best.  One
// 128-bit broadcast load of the table serves RPT pairs.  With TPR > 1,
// each ray is held by TPR consecutive lanes, lane p taking triangles p,
// p + TPR, ... (n a multiple of TPR); the lanes' nearest hits are then
// combined by (t, index), which is the nearest hit with the lowest index
// on exact-t ties, as the sequential walk finds it.  Lanes that start at
// -INF (parked, padding, past the tile) never take a hit.
template <int SUB, int RPT, int TPR = 1, typename Pair = PairNf>
__device__ __forceinline__ void eval_table(const float4* __restrict__ tris,
                                           const float (&phi)[RPT][10], int s0,
                                           Best (&best)[RPT], int n = SUB) {
  static_assert(TPR >= 1 && TPR <= 32 && (TPR & (TPR - 1)) == 0 && SUB % TPR == 0,
                "a ray's lanes are a power-of-two group of one warp");
  Best near[RPT];
#pragma unroll
  for (int r = 0; r < RPT; ++r) near[r] = Best{kInf, 0x7fffffff, 0.f, 0.f};
  const int first = TPR > 1 ? static_cast<int>(threadIdx.x % TPR) : 0;
#pragma unroll 2
  for (int i = first; i < n; i += TPR) {
    const float4 q0 = tris[kTableVecs * i + 0];
    const float4 q1 = tris[kTableVecs * i + 1];
    const float4 q2 = tris[kTableVecs * i + 2];
    const float4 q3 = tris[kTableVecs * i + 3];
    const float4 q4 = tris[kTableVecs * i + 4];
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      const float* p = phi[r];
      float a = __fmul_rn(q0.x, p[4]);
      a = __fadd_rn(a, __fmul_rn(q0.y, p[5]));
      a = __fadd_rn(a, __fmul_rn(q0.z, p[6]));
      float ua = __fmul_rn(q0.w, p[4]);
      ua = __fadd_rn(ua, __fmul_rn(q1.x, p[5]));
      ua = __fadd_rn(ua, __fmul_rn(q1.y, p[6]));
      ua = __fadd_rn(ua, __fmul_rn(q1.z, p[7]));
      ua = __fadd_rn(ua, __fmul_rn(q1.w, p[8]));
      ua = __fadd_rn(ua, __fmul_rn(q2.x, p[9]));
      float va = __fmul_rn(q2.y, p[4]);
      va = __fadd_rn(va, __fmul_rn(q2.z, p[5]));
      va = __fadd_rn(va, __fmul_rn(q2.w, p[6]));
      va = __fadd_rn(va, __fmul_rn(q3.x, p[7]));
      va = __fadd_rn(va, __fmul_rn(q3.y, p[8]));
      va = __fadd_rn(va, __fmul_rn(q3.z, p[9]));
      float ta = __fmul_rn(q3.w, p[0]);
      ta = __fadd_rn(ta, __fmul_rn(q4.x, p[1]));
      ta = __fadd_rn(ta, __fmul_rn(q4.y, p[2]));
      ta = __fadd_rn(ta, __fmul_rn(q4.z, p[3]));
      Pair::take(a, ua, va, ta, s0 + i, near[r]);
    }
  }
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
#pragma unroll
    for (int o = 1; o < TPR; o <<= 1) {
      const Best other{__shfl_xor_sync(0xffffffffu, near[r].t, o),
                       __shfl_xor_sync(0xffffffffu, near[r].idx, o),
                       __shfl_xor_sync(0xffffffffu, near[r].u, o),
                       __shfl_xor_sync(0xffffffffu, near[r].v, o)};
      if (other.t < near[r].t || (other.t == near[r].t && other.idx < near[r].idx))
        near[r] = other;
    }
    fold(near[r], best[r]);
  }
}

// ---------------------------------------------------------------------------
// Tile-wide decisions.  A tile's rays are split over the C CTAs of a
// cluster; every decision of the walk (which block is live, the tile's
// largest t) is the OR of a bit mask and the max of t over all of them.
// Each warp reduces its lanes, writes one slot into every CTA of the
// cluster (distributed shared memory), and one cluster barrier (C = 1: the
// block barrier) publishes all slots; every warp then reduces the slots
// itself.  Two slot sets alternate, so a CTA that runs ahead to the next
// decision never overwrites slots still being read.  A set holds N slots,
// at least one a warp of the cluster.

struct Vote {
  uint32_t bits;
  int key;  // order-preserving integer key of a float (`float_key`)
};

// An integer whose signed order is the float order (no NaN).
__device__ __forceinline__ int float_key(float f) {
  const int i = __float_as_int(f);
  return i >= 0 ? i : i ^ 0x7fffffff;
}

__device__ __forceinline__ float key_float(int k) {
  return __int_as_float(k >= 0 ? k : k ^ 0x7fffffff);
}

struct Decision {
  uint32_t bits;  // OR over the tile
  float tmax;     // max over the tile
};

template <int C, int N>
__device__ __forceinline__ Decision decide(Vote (&slots)[2][N], int& parity, uint32_t bits,
                                           float m) {
  static_assert(N >= C * kThreads / 32, "a slot for each warp of the cluster");
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  const Vote v{__reduce_or_sync(0xffffffffu, bits),
               __reduce_max_sync(0xffffffffu, float_key(m))};
  Vote* mine = slots[parity];
  if constexpr (C == 1) {
    if (lane == 0) mine[warp] = v;
    __syncthreads();
  } else {
    cg::cluster_group cluster = cg::this_cluster();
    const int rank = static_cast<int>(cluster.block_rank());
    if (lane < C) cluster.map_shared_rank(mine, lane)[rank * n_warps + warp] = v;
    cluster.sync();
  }
  uint32_t b = 0;
  int k = INT_MIN;
  for (int i = lane; i < C * n_warps; i += 32) {
    b |= mine[i].bits;
    k = max(k, mine[i].key);
  }
  parity ^= 1;
  return Decision{__reduce_or_sync(0xffffffffu, b),
                  key_float(__reduce_max_sync(0xffffffffu, k))};
}

// The largest best t of a thread's rays inside the tile (-inf if none).
template <int RPT>
__device__ __forceinline__ float rays_max(const Best (&best)[RPT],
                                          const int (&ray)[RPT]) {
  float m = -CUDART_INF_F;
#pragma unroll
  for (int r = 0; r < RPT; ++r)
    if (ray[r] >= 0) m = fmaxf(m, best[r].t);
  return m;
}

// A barrier over the cluster (C = 1: nothing to wait for).  Taken once
// before the first decision, so that no CTA writes into the shared memory
// of one that has not started, and once at the end, so that none exits
// while another may still read its slots.
template <int C>
__device__ __forceinline__ void cluster_sync() {
  if constexpr (C > 1) cg::this_cluster().sync();
}

// ---------------------------------------------------------------------------
// Staging: two shared-memory buffers of BYTES each, a block `bytes` long
// (BYTES unless `init` is given fewer).  Thread 0 fills a buffer with the
// 1-D bulk copy of the Tensor Memory Accelerator (`cp.async.bulk`, a
// contiguous block, so no tensor map), which completes on the buffer's
// mbarrier; the walk prefetches its next candidate block into the idle
// buffer while it evaluates the current one.  Every thread tracks the same
// state (the walk's decisions are tile-uniform) and waits on every copy
// that was issued, so a prefetch the walk drops is waited on before its
// buffer is reused and the mbarrier phases stay in step.  `copies` counts
// the copies issued.

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// (Per-buffer state is kept in scalars and bit masks, not arrays: a
// register array indexed at run time would live in local memory.)
template <int BYTES>
struct Stager {
  static_assert(BYTES % 16 == 0, "bulk copies move multiples of 16 bytes");
  float4* buf0;
  float4* buf1;
  uint64_t* bar;     // two mbarriers
  int id0, id1;      // block held or in flight in each buffer, -1 none
  uint32_t pending;  // bit b: a copy into buffer b not yet waited on
  uint32_t phase;    // bit b: parity of buffer b's next mbarrier phase
  int cur;           // the buffer of the block being evaluated
  uint32_t bytes;    // bytes a block
  int copies;        // copies issued so far

  __device__ float4* buffer(int b) const { return b ? buf1 : buf0; }
  __device__ int held(int b) const { return b ? id1 : id0; }

  __device__ void init(float4* b0, float4* b1, uint64_t* bars, uint32_t block_bytes = BYTES) {
    buf0 = b0;
    buf1 = b1;
    bar = bars;
    id0 = id1 = -1;
    pending = phase = 0u;
    cur = 1;
    bytes = block_bytes;
    copies = 0;
    if (threadIdx.x == 0) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(&bar[0])) : "memory");
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(&bar[1])) : "memory");
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();
  }

  __device__ void wait(int b) {
    if (!((pending >> b) & 1u)) return;
    const uint32_t addr = smem_addr(&bar[b]), parity = (phase >> b) & 1u;
    uint32_t done = 0;
    do {
      asm volatile(
          "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
          "selp.u32 %0, 1, 0, p;\n}\n"
          : "=r"(done)
          : "r"(addr), "r"(parity)
          : "memory");
    } while (!done);
    phase ^= 1u << b;
    pending &= ~(1u << b);
  }

  // Start copying block `block` of `table` into buffer b.
  __device__ void issue(int b, const float4* table, int block) {
    if ((pending >> b) & 1u) {
      // A dropped prefetch lands before its buffer is reused, and every
      // thread has seen it land before the next copy starts: a thread still
      // polling the old phase's parity after the next phase completed would
      // read it as the current, incomplete phase and wait forever.
      wait(b);
      __syncthreads();
    }
    if (threadIdx.x == 0) {
      const float4* src = table + static_cast<size_t>(block) * (bytes / 16);
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                       smem_addr(&bar[b])),
                   "r"(bytes)
                   : "memory");
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
          "[%3];" ::"r"(smem_addr(buffer(b))),
          "l"(src), "r"(bytes), "r"(smem_addr(&bar[b]))
          : "memory");
    }
    if (b) id1 = block; else id0 = block;
    pending |= 1u << b;
    ++copies;
  }

  // Make `block` the current block: take it from the idle buffer if it
  // was prefetched there, else load it into the idle buffer.  Returns it
  // in shared memory, ready to read.  The idle buffer's last reader
  // finished before the walk's latest decision.
  __device__ const float4* take(const float4* table, int block) {
    const int b = cur ^ 1;
    cur = b;
    if (held(b) != block) issue(b, table, block);
    wait(b);
    return buffer(b);
  }

  // Prefetch a candidate block into the idle buffer.
  __device__ void prefetch(const float4* table, int block) {
    const int b = cur ^ 1;
    if (held(b) != block) issue(b, table, block);
  }

  // No copy may be in flight when the CTA exits.
  __device__ void drain() {
    wait(0);
    wait(1);
  }
};

// ---------------------------------------------------------------------------
// Host side.

template <int N>
using Int = std::integral_constant<int, N>;

// The run-time shape of a launch: rays a thread, cluster size, lanes a ray.
struct Shape {
  int rpt, c, tpr;
  bool operator==(const Shape& o) const { return rpt == o.rpt && c == o.c && tpr == o.tpr; }
};

// Threads of one CTA when a tile of `tile_rays` is split over `s.c` CTAs,
// each ray on `s.tpr` lanes, `s.rpt` rays a thread (whole warps), or 0 if
// that exceeds kThreads.
inline int threads_for(int tile_rays, const Shape& s) {
  const int per_cta = (tile_rays + s.c - 1) / s.c;
  const int threads = ((per_cta + s.rpt - 1) / s.rpt * s.tpr + 31) / 32 * 32;
  return threads <= kThreads ? threads : 0;
}

// The shape a walk runs a tile of `tile_rays` at: its kept shape; for a
// tile too wide for that, a cluster of 8 at the kept lanes a ray, then one
// lane a ray and 1, 2 or 4 rays a thread (up to 16,384 rays).  False if
// none fits.
inline bool fit_shape(int tile_rays, Shape& s) {
  const Shape tries[] = {s, {s.rpt, kMaxCluster, s.tpr}, {1, kMaxCluster, 1},
                         {2, kMaxCluster, 1}, {4, kMaxCluster, 1}};
  for (const Shape& t : tries)
    if (threads_for(tile_rays, t)) {
      s = t;
      return true;
    }
  return false;
}

// A cluster above the portable size must be allowed for each kernel.
inline cudaError_t allow_cluster(const void* kernel, int cluster) {
  if (cluster <= kMaxCluster) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
}

// Launch `kernel` on n_tiles tiles of c CTAs (grid n_tiles * c) in
// clusters of `cluster` CTAs (c, or 1 for none), with `smem` bytes of
// dynamic shared memory; the CUDA error code.
template <typename... P, typename... A>
int launch_cluster(void (*kernel)(P...), int n_tiles, int c, int cluster, int threads,
                   size_t smem, cudaStream_t stream, A... args) {
  if (smem > 0) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  {
    const cudaError_t err = allow_cluster(reinterpret_cast<const void*>(kernel), cluster);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_tiles * c);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cluster > 1 ? 1 : 0;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// The launch shape, registers, shared memory and residency of `kernel`:
// out[0..8] = rpt, cluster, threads, registers a thread, static shared
// bytes, dynamic shared bytes, CTAs per SM, clusters the card holds at
// once, lanes a ray.
inline int describe(const void* kernel, const Shape& shape, int threads, size_t smem, int* out) {
  const int c = shape.c;
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err == cudaSuccess) err = allow_cluster(kernel, c);
  if (err == cudaSuccess && smem > 0)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
  int blocks = 0, clusters = 0, device = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads, smem);
  if (err == cudaSuccess && c == 1) {  // no cluster: every resident CTA is one
    err = cudaGetDevice(&device);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&clusters, cudaDevAttrMultiProcessorCount, device);
    clusters *= blocks;
  } else if (err == cudaSuccess) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(c * 1024);
    cfg.blockDim = dim3(threads);
    cfg.dynamicSmemBytes = smem;
    cudaLaunchAttribute la[1];
    la[0].id = cudaLaunchAttributeClusterDimension;
    la[0].val.clusterDim.x = c;
    la[0].val.clusterDim.y = 1;
    la[0].val.clusterDim.z = 1;
    cfg.attrs = la;
    cfg.numAttrs = 1;
    err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const int vals[9] = {shape.rpt, c, threads, attr.numRegs,
                       static_cast<int>(attr.sharedSizeBytes), static_cast<int>(smem), blocks,
                       clusters, shape.tpr};
  for (int i = 0; i < 9; ++i) out[i] = vals[i];
  return 0;
}

}  // namespace walk
}  // namespace tpt
