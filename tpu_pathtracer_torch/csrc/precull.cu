// The near-to-far walks' precull for Hopper (sm_90a): every ray slab-tested
// against every box, reduced to each ray tile's least entry distance a box,
// and each tile's boxes sorted near to far, in one launch.
//
// It replaces no TPU kernel.  In the JAX package the precull is XLA glue
// around the Pallas walks (`_precull_live_subs`, tpu_pathtracer/ops/pallas/
// mt_shade.py:364); its plain PyTorch version (ops/kernels/mt_shade.py
// `_precull_live_subs_plain`) is some 55 elementwise launches a 65,536-ray
// chunk over broadcast (Ms, rays) tensors, then a min, a count and a stable
// sort: about 190 launches for a 512x512 frame's rays, each of which costs
// the host more than the card.  The wrapper launches this kernel for the
// 'nf' and 'list' walks' sub boxes and the streamed walk's super boxes.
//
// What bounds it on the H100.  It reads 24 bytes a ray (ro, rd) and Ms boxes
// a tile, and writes 8 bytes a tile and box: at 512x512 (262,144 rays, 512
// tiles, Ms = 64) about 6.5 MB, 2 us at 3.35 TB/s.  Each ray-box pair costs
// about 20 FP32 operations: 336 MFLOP at Ms = 64, 5 us at 67 TFLOP/s (and,
// with -fmad=false, every product and sum issues alone).  So arithmetic
// binds, by little; what the torch version spent was launches.  This
// design:
//   * one CTA a ray tile (any tile width: the threads loop over the tile's
//     rays, kRpt at a time, each ray's origin, reciprocal direction and
//     parallel flags in registers); the rays are read once a slice of boxes;
//   * the boxes staged in shared memory kSlice at a time, so any Ms up to
//     kMaxBoxes fits;
//   * a box's least entry over the tile: each thread's rays in registers,
//     then a warp-shuffle min (four boxes' chains in flight at once), then
//     the warps' minima combined through shared memory by one thread a box.
//     No atomics: the minimum does not depend on the order it is taken in,
//     so the result is deterministic;
//   * the stable sort in the same CTA, by rank: box i goes to place
//     #{j : e_j < e_i or (e_j == e_i and j < i)}, which is the stable
//     ascending order;
//   * nothing but the outputs touches device memory: no chunks, no
//     intermediates.
// The arithmetic is `_slab_setup` / `_slab_entries` op for op: inv = 1 / (par
// ? 1 : rd) as an IEEE division, (lo - o) * inv each rounded (-fmad=false),
// then the same minimum / maximum / where order, with minimum and maximum
// that propagate NaN as torch's do (`min.NaN`, `max.NaN`: one instruction
// each, where a select on each operand took five and half the kernel's
// time), so counts, lists and emins equal the plain version's.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr float kInf = 1e20f;      // the finite sentinel (ops/vecmath.py INF)
constexpr float kEpsilon = 1e-6f;  // parallel axes: |rd| < EPSILON
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRpt = 2;          // rays a thread holds at a time
constexpr int kSlice = 128;      // boxes staged in shared memory at a time
constexpr int kMaxBoxes = 8192;  // the tile's minima, 32 KB of shared memory

// torch.minimum / torch.maximum: NaN if either operand is NaN, else the
// least (greatest) of the two, in one instruction.  The NaN is the canonical
// one, not the operand, which changes nothing: an entry that meets a NaN
// fails the hit test and reads INF, so no NaN reaches an output.
__device__ __forceinline__ float t_min(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}
__device__ __forceinline__ float t_max(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

struct Ray {
  float o[3];
  float inv[3];
  bool par[3];
};

__device__ __forceinline__ Ray load_ray(const float* __restrict__ phi_t, size_t r_pad,
                                        size_t ray) {
  Ray out;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    out.o[k] = phi_t[(1 + k) * r_pad + ray];
    const float d = phi_t[(4 + k) * r_pad + ray];
    out.par[k] = fabsf(d) < kEpsilon;
    out.inv[k] = __fdiv_rn(1.f, out.par[k] ? 1.f : d);
  }
  return out;
}

// `_slab_entries` for one ray and one box [min3, max3]: the entry distance,
// kInf where the box is missed; parallel axes require containment.
__device__ __forceinline__ float entry(const float* box, const Ray& ray) {
  bool hit_par = true;
  float tmin = -kInf, tmax = kInf;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float o = ray.o[k];
    const float lo = __fmul_rn(__fsub_rn(box[k], o), ray.inv[k]);
    const float hi = __fmul_rn(__fsub_rn(box[k + 3], o), ray.inv[k]);
    const float tn = ray.par[k] ? -kInf : t_min(lo, hi);
    const float tf = ray.par[k] ? kInf : t_max(lo, hi);
    hit_par = hit_par && (!ray.par[k] || (o >= box[k] && o <= box[k + 3]));
    tmin = t_max(tmin, tn);
    tmax = t_min(tmax, tf);
  }
  return hit_par && tmax >= t_max(tmin, 0.f) ? tmin : kInf;
}

__global__ void __launch_bounds__(kThreads)
    precull_kernel(const float* __restrict__ boxes, const float* __restrict__ phi_t, int ms,
                   int r_pad, int tile_rays, int* __restrict__ counts, int* __restrict__ lists,
                   float* __restrict__ emins) {
  extern __shared__ float s_emin[];  // [ms]: the tile's least entry a box
  __shared__ float s_box[kSlice][6];
  __shared__ float s_warp[kWarps][kSlice];
  __shared__ int s_live[kWarps];
  const int tile = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const size_t ray0 = static_cast<size_t>(tile) * tile_rays;

  for (int b0 = 0; b0 < ms; b0 += kSlice) {
    const int nb = min(kSlice, ms - b0);
    __syncthreads();  // the last slice's boxes and minima are read
    for (int i = threadIdx.x; i < nb * 6; i += kThreads)
      s_box[i / 6][i % 6] = boxes[static_cast<size_t>(b0 + i / 6) * 8 + i % 6];
    __syncthreads();
    for (int base = 0; base < tile_rays; base += kThreads * kRpt) {
      Ray ray[kRpt];
      bool valid[kRpt];
#pragma unroll
      for (int k = 0; k < kRpt; ++k) {
        const int i = base + k * kThreads + threadIdx.x;
        valid[k] = i < tile_rays;
        if (valid[k]) ray[k] = load_ray(phi_t, r_pad, ray0 + i);
      }
#pragma unroll 4
      for (int b = 0; b < nb; ++b) {
        float e = CUDART_INF_F;  // above every entry, kInf included
#pragma unroll
        for (int k = 0; k < kRpt; ++k)
          if (valid[k]) e = fminf(e, entry(s_box[b], ray[k]));
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) e = fminf(e, __shfl_xor_sync(0xffffffffu, e, o));
        if (lane == 0) s_warp[warp][b] = base == 0 ? e : fminf(s_warp[warp][b], e);
      }
    }
    __syncthreads();
    for (int b = threadIdx.x; b < nb; b += kThreads) {
      float e = s_warp[0][b];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) e = fminf(e, s_warp[w][b]);
      s_emin[b0 + b] = e;
    }
  }
  __syncthreads();

  // The stable ascending sort by rank, and the count of live boxes.
  const size_t row = static_cast<size_t>(tile) * ms;
  int live = 0;
  for (int i = threadIdx.x; i < ms; i += kThreads) {
    const float e = s_emin[i];
    int rank = 0;
    for (int j = 0; j < ms; ++j) {
      const float f = s_emin[j];
      rank += (f < e) | ((f == e) & (j < i));
    }
    lists[row + rank] = i;
    emins[row + rank] = e;
    live += e < kInf;
  }
  live = __reduce_add_sync(0xffffffffu, live);
  if (lane == 0) s_live[warp] = live;
  __syncthreads();
  if (threadIdx.x == 0) {
    int total = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) total += s_live[w];
    counts[tile] = total;
  }
}

}  // namespace

// boxes: (ms, 8) f32 [min3, max3, 0, 0]; phi_t: (10, r_pad) f32 ray
// features, r_pad a multiple of tile_rays.  Writes counts (T,) i32, lists
// (T, ms) i32 and emins (T, ms) f32, T = r_pad / tile_rays: lists[t] holds
// tile t's boxes by ascending least entry distance (equal distances in
// index order), emins those distances (INF for a box no ray of the tile
// enters), counts[t] the boxes below INF; ms up to kMaxBoxes.  Returns a
// CUDA error code.
extern "C" int tpt_precull(const float* boxes, const float* phi_t, int* counts, int* lists,
                           float* emins, int ms, int r_pad, int tile_rays,
                           cudaStream_t stream) {
  if (ms < 0 || ms > kMaxBoxes || tile_rays <= 0 || r_pad < 0 || r_pad % tile_rays)
    return cudaErrorInvalidValue;
  const int n_tiles = r_pad / tile_rays;
  if (n_tiles == 0) return cudaSuccess;
  precull_kernel<<<n_tiles, kThreads, ms * sizeof(float), stream>>>(
      boxes, phi_t, ms, r_pad, tile_rays, counts, lists, emins);
  return cudaGetLastError();
}

// The text of a CUDA error code, for every wrapper's error messages
// (`_build.error_string`).
extern "C" const char* tpt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
