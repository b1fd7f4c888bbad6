// Bilateral "smart denoise" stencil for Hopper (sm_90a).
//
// Replaces the TPU kernel `_denoise_kernel` in
// tpu_pathtracer/ops/pallas/denoise.py: circular taps at sigma = 5 with
// fractional row offsets resolved by a two-row lerp, spatial x range
// Gaussian weights, wrap addressing on both axes.  The wrapper
// (ops/kernels/denoise.py) builds the tap table once per (sigma, k_sigma,
// threshold, device), one float4 per tap: (column offset, floor of the row
// offset, row fraction, spatial weight times the range normalisation), in
// the loop order of post/denoise.py.
//
// What bounds it on the H100: per pixel and tap about 20 FP32 operations
// and one expf (85 taps at the default radius), against one read and one
// write of the image: operations, by some 60x.  With -fmad=false every
// product and sum issues alone, so an exact kernel tops out at half of the
// FP32 peak.  So the kernel spends as little as it can on addressing and
// loads:
//   * each CTA stages its 32 x 32 output tile and a halo of `radius` rows
//     and columns in shared memory as three planes (structure of arrays);
//     the wrap is resolved once per staged pixel, so any H and W work,
//     images smaller than the halo included (the wrap goes round more than
//     once);
//   * each thread computes 4 vertically adjacent pixels, so a fractional
//     tap's second row is the next pixel's first: 5 rows of loads serve 4
//     pixels;
//   * at PostConfig's radius (sigma 5, k_sigma 1: radius 5, 85 taps) the
//     tap offsets are compile-time constants (`tap_offset`, the loop of
//     post/denoise.py `_taps` in integers) and the loop is unrolled, so
//     every shared-memory read has an immediate offset; a column's taps
//     share one load of its rows (a compiler fence between columns keeps
//     the next column's loads from being hoisted, which spilled); the
//     taps' row fractions and weights, which also depend on sigma and the
//     threshold, are launch parameters in the constant bank.  The host
//     checks the table against the compiled offsets before the launch.
//     Other radii, up to kMaxTaps taps, run the same tiled kernel on the
//     cached tap table staged in shared memory.
// The arithmetic: sums in tap order with -fmad=false, expf, a final
// __fdiv_rn; the plain PyTorch version adds in the same order, and expf
// differs from the host's exp by a few ulp, hence the stated tolerance.

#include <cuda_runtime.h>

#include <utility>

namespace {

constexpr int kMaxTaps = 1024;
constexpr int kDefaultRadius = 5;  // PostConfig: sigma 5, k_sigma 1
constexpr int kTileW = 32;         // output tile: 32 columns ...
constexpr int kThreadsY = 8;       // ... by 8 threads ...
constexpr int kRows = 4;           // ... of 4 pixels each (32 rows)
constexpr int kTileH = kThreadsY * kRows;
constexpr int kStaticSmem = 48 * 1024;

__host__ __device__ __forceinline__ int wrap(int i, int n) {
  i %= n;
  return i < 0 ? i + n : i;
}

// ---------------------------------------------------------------------------
// The taps of radius r in post/denoise.py `_taps` order, in integers.  Column
// dx = -r..r holds the row offsets dy = -pt, -pt + 1, ... <= pt with
// pt = sqrt(r^2 - dx^2): floor(2 pt) + 1 taps, whose floor is
// j - ceil(pt) and whose row fraction ceil(pt) - pt is nonzero unless
// r^2 - dx^2 is a perfect square.

__host__ __device__ constexpr int isqrt(int n) {  // floor(sqrt(n)), n >= 0
  int r = 0;
  while ((r + 1) * (r + 1) <= n) ++r;
  return r;
}

__host__ __device__ constexpr int tap_count(int r) {
  int n = 0;
  for (int x = -r; x <= r; ++x) n += isqrt(4 * (r * r - x * x)) + 1;
  return n;
}

struct TapOffset {
  int dx, y0;
  bool frac;  // the row fraction is nonzero: lerp with row y0 + 1
};

// Column x (0 .. 2r) of radius r: its first tap and its number of taps.
__host__ __device__ constexpr int column_first(int r, int x) {
  int k = 0;
  for (int c = 0; c < x; ++c) k += isqrt(4 * (r * r - (c - r) * (c - r))) + 1;
  return k;
}

__host__ __device__ constexpr int column_taps(int r, int x) {
  return isqrt(4 * (r * r - (x - r) * (x - r))) + 1;
}

__host__ __device__ constexpr TapOffset tap_offset(int r, int k) {
  for (int x = -r; x <= r; ++x) {
    const int m = r * r - x * x;
    const int n = isqrt(4 * m) + 1;
    if (k < n) {
      const int s = isqrt(m);
      const bool frac = s * s != m;
      return TapOffset{x, k - (frac ? s + 1 : s), frac};
    }
    k -= n;
  }
  return TapOffset{0, 0, false};
}

// The compile-time radius's row fractions and weights, by tap.
template <int R>
struct TapParams {
  float2 fw[tap_count(R)];
};

// The staged tile: three planes of (kTileH + 2 radius) rows of
// (kTileW + 2 radius) pixels, the tile's first pixel at (radius, radius).
struct Tile {
  const float* s;  // plane 0; planes 1 and 2 follow at n and 2n
  int n, pitch;
};

// Stage the tile whose output starts at (x0, y0), wrapping once per pixel.
__device__ __forceinline__ Tile stage(const float* __restrict__ img, float* s, int radius,
                                      int x0, int y0, int height, int width) {
  const int pitch = kTileW + 2 * radius, n = (kTileH + 2 * radius) * pitch;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x, step = blockDim.x * blockDim.y;
  for (int i = tid; i < n; i += step) {
    const int r = i / pitch, c = i - r * pitch;
    const float* p = img + (static_cast<size_t>(wrap(y0 - radius + r, height)) * width +
                            wrap(x0 - radius + c, width)) * 3;
    s[i] = p[0];
    s[n + i] = p[1];
    s[2 * n + i] = p[2];
  }
  __syncthreads();
  return Tile{s, n, pitch};
}

struct Acc {
  float z, a0, a1, a2;
};

// One pixel's share of one tap: its sample s0 (and with `frac` the next
// row's s1, lerped by fy) against its centre c, weighed by w.
__device__ __forceinline__ void accumulate(const float* s0, const float* s1, bool frac, float fy,
                                           float w, const float* c, Acc& acc,
                                           float neg_range_scale) {
  float s[3];
#pragma unroll
  for (int k = 0; k < 3; ++k)
    s[k] = frac ? __fadd_rn(s0[k], __fmul_rn(__fsub_rn(s1[k], s0[k]), fy)) : s0[k];
  const float d0 = __fsub_rn(s[0], c[0]), d1 = __fsub_rn(s[1], c[1]), d2 = __fsub_rn(s[2], c[2]);
  const float dist2 = __fadd_rn(__fadd_rn(__fmul_rn(d0, d0), __fmul_rn(d1, d1)),
                                __fmul_rn(d2, d2));
  const float delta = __fmul_rn(expf(__fmul_rn(dist2, neg_range_scale)), w);
  acc.z = __fadd_rn(acc.z, delta);
  acc.a0 = __fadd_rn(acc.a0, __fmul_rn(delta, s[0]));
  acc.a1 = __fadd_rn(acc.a1, __fmul_rn(delta, s[1]));
  acc.a2 = __fadd_rn(acc.a2, __fmul_rn(delta, s[2]));
}

// One tap read at run time for this thread's kRows pixels: `at` indexes
// the tap's row y0 for the first pixel; the lerp with the next row when
// fy > 0.
__device__ __forceinline__ void add_tap(const Tile& t, int at, float fy, float w,
                                        const float (&c)[kRows][3], Acc (&acc)[kRows],
                                        float neg_range_scale) {
  const bool frac = fy > 0.f;
  float v[kRows + 1][3];
#pragma unroll
  for (int i = 0; i < kRows + 1; ++i) {
    if (i == kRows && !frac) break;
#pragma unroll
    for (int k = 0; k < 3; ++k) v[i][k] = t.s[k * t.n + at + i * t.pitch];
  }
#pragma unroll
  for (int p = 0; p < kRows; ++p)
    accumulate(v[p], v[p + 1], frac, fy, w, c[p], acc[p], neg_range_scale);
}

// Column X of the compile-time radius R: its rows loaded once, then its
// taps in order.
template <int R, int X>
__device__ __forceinline__ void fixed_column(const Tile& t, int base, const TapParams<R>& prm,
                                             const float (&c)[kRows][3], Acc (&acc)[kRows],
                                             float neg_range_scale) {
  constexpr int k0 = column_first(R, X), n = column_taps(R, X);
  constexpr TapOffset o = tap_offset(R, k0);
  constexpr int pitch = kTileW + 2 * R, rows = n + kRows - 1 + (o.frac ? 1 : 0);
  const int at = base + o.y0 * pitch + o.dx;
  float v[rows][3];
#pragma unroll
  for (int i = 0; i < rows; ++i)
#pragma unroll
    for (int k = 0; k < 3; ++k) v[i][k] = t.s[k * t.n + at + i * pitch];
#pragma unroll
  for (int j = 0; j < n; ++j)
#pragma unroll
    for (int p = 0; p < kRows; ++p)
      accumulate(v[j + p], v[j + p + (o.frac ? 1 : 0)], o.frac, prm.fw[k0 + j].x,
                 prm.fw[k0 + j].y, c[p], acc[p], neg_range_scale);
  // the next column's loads stay after this column's taps are summed
#pragma unroll
  for (int p = 0; p < kRows; ++p)
    asm volatile("" : "+f"(acc[p].z), "+f"(acc[p].a0), "+f"(acc[p].a1), "+f"(acc[p].a2)::"memory");
}

template <int R, int... X>
__device__ __forceinline__ void fixed_taps(std::integer_sequence<int, X...>, const Tile& t,
                                           int base, const TapParams<R>& prm,
                                           const float (&c)[kRows][3], Acc (&acc)[kRows],
                                           float neg_range_scale) {
  (fixed_column<R, X>(t, base, prm, c, acc, neg_range_scale), ...);  // in tap order
}

// This thread's pixels: their centres, then after the taps their outputs.
__device__ __forceinline__ void centres(const Tile& t, int base, float (&c)[kRows][3],
                                        Acc (&acc)[kRows]) {
#pragma unroll
  for (int p = 0; p < kRows; ++p) {
#pragma unroll
    for (int k = 0; k < 3; ++k) c[p][k] = t.s[k * t.n + base + p * t.pitch];
    acc[p] = Acc{0.f, 0.f, 0.f, 0.f};
  }
}

__device__ __forceinline__ void write(float* __restrict__ out, const Acc (&acc)[kRows], int x,
                                      int y, int height, int width) {
  if (x >= width) return;
#pragma unroll
  for (int p = 0; p < kRows; ++p) {
    if (y + p >= height) return;
    float* o = out + (static_cast<size_t>(y + p) * width + x) * 3;
    o[0] = __fdiv_rn(acc[p].a0, acc[p].z);
    o[1] = __fdiv_rn(acc[p].a1, acc[p].z);
    o[2] = __fdiv_rn(acc[p].a2, acc[p].z);
  }
}

// The taps of radius R at compile time (R = kDefaultRadius).
template <int R>
__global__ void __launch_bounds__(kTileW * kThreadsY)
    denoise_fixed_kernel(const float* __restrict__ img, float* __restrict__ out, int height,
                         int width, float neg_range_scale, const __grid_constant__ TapParams<R> prm) {
  extern __shared__ __align__(16) float smem[];
  const int x0 = blockIdx.x * kTileW, y0 = blockIdx.y * kTileH;
  const Tile t = stage(img, smem, R, x0, y0, height, width);
  const int base = (threadIdx.y * kRows + R) * t.pitch + threadIdx.x + R;
  float c[kRows][3];
  Acc acc[kRows];
  centres(t, base, c, acc);
  fixed_taps<R>(std::make_integer_sequence<int, 2 * R + 1>{}, t, base, prm, c, acc,
                neg_range_scale);
  write(out, acc, x0 + threadIdx.x, y0 + threadIdx.y * kRows, height, width);
}

// Any radius: the tap table staged in shared memory, read at run time.
__global__ void __launch_bounds__(kTileW * kThreadsY)
    denoise_any_kernel(const float* __restrict__ img, float* __restrict__ out,
                       const float4* __restrict__ taps, int n_taps, int radius, int height,
                       int width, float neg_range_scale) {
  extern __shared__ __align__(16) float smem[];
  float4* s_taps = reinterpret_cast<float4*>(smem);
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  for (int i = tid; i < n_taps; i += blockDim.x * blockDim.y) s_taps[i] = taps[i];
  const int x0 = blockIdx.x * kTileW, y0 = blockIdx.y * kTileH;
  const Tile t = stage(img, smem + 4 * n_taps, radius, x0, y0, height, width);
  const int base = (threadIdx.y * kRows + radius) * t.pitch + threadIdx.x + radius;
  float c[kRows][3];
  Acc acc[kRows];
  centres(t, base, c, acc);
  for (int k = 0; k < n_taps; ++k) {
    const float4 tap = s_taps[k];
    const int at = base + static_cast<int>(tap.y) * t.pitch + static_cast<int>(tap.x);
    add_tap(t, at, tap.z, tap.w, c, acc, neg_range_scale);
  }
  write(out, acc, x0 + threadIdx.x, y0 + threadIdx.y * kRows, height, width);
}

size_t tile_bytes(int radius) {
  return sizeof(float) * 3 * (kTileW + 2 * radius) * (kTileH + 2 * radius);
}

}  // namespace

// `taps` is the device tap table, `host_taps` the same table in host
// memory (read here, before the launch); `radius` bounds every tap's row
// and column offsets (its rows y0 and y0 + 1).
extern "C" int tpt_denoise(const float* img, float* out, const float* taps,
                           const float* host_taps, int n_taps, int radius, int height,
                           int width, float neg_range_scale, cudaStream_t stream) {
  if (n_taps <= 0 || n_taps > kMaxTaps || radius < 0 || height <= 0 || width <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 block(kTileW, kThreadsY);
  const dim3 grid((width + kTileW - 1) / kTileW, (height + kTileH - 1) / kTileH);
  if (radius == kDefaultRadius) {
    constexpr int R = kDefaultRadius;
    if (n_taps != tap_count(R)) return static_cast<int>(cudaErrorInvalidValue);
    TapParams<R> prm;
    for (int k = 0; k < n_taps; ++k) {
      const TapOffset o = tap_offset(R, k);
      const float* h = host_taps + 4 * k;
      if (static_cast<int>(h[0]) != o.dx || static_cast<int>(h[1]) != o.y0 ||
          (h[2] > 0.f) != o.frac)
        return static_cast<int>(cudaErrorInvalidValue);
      prm.fw[k] = make_float2(h[2], h[3]);
    }
    denoise_fixed_kernel<R><<<grid, block, tile_bytes(R), stream>>>(img, out, height, width,
                                                                   neg_range_scale, prm);
    return static_cast<int>(cudaGetLastError());
  }
  const size_t smem = sizeof(float4) * n_taps + tile_bytes(radius);
  if (smem > kStaticSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        denoise_any_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  denoise_any_kernel<<<grid, block, smem, stream>>>(img, out, reinterpret_cast<const float4*>(taps),
                                                    n_taps, radius, height, width,
                                                    neg_range_scale);
  return static_cast<int>(cudaGetLastError());
}
