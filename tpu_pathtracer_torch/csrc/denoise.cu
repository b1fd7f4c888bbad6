// Bilateral "smart denoise" stencil for Hopper (sm_90a).
//
// Replaces the TPU kernel `_denoise_kernel` in
// tpu_pathtracer/ops/pallas/denoise.py: circular taps at sigma = 5 with
// fractional row offsets resolved by a two-row lerp, spatial x range
// Gaussian weights, wrap addressing on both axes.  The wrapper
// (ops/kernels/denoise.py) builds the tap table on the host, one float4 per
// tap: (column offset, floor of the row offset, row fraction, spatial
// weight times the range normalisation), in the loop order of
// post/denoise.py.
//
// Design: one thread per output pixel, reading the (H, W, 3) f32 image in
// place with wrap addressing, so any H and W work (the TPU kernel needed
// W % 128 == 0 and H % 8 == 0).  The tap table is staged in shared memory.
//
// What bounds it on the H100: at 85 taps a pixel makes about 130 gathers of
// 12 bytes, nearly all hits in L1/L2 since neighbouring threads read
// neighbouring pixels, and 85 expf calls; DRAM traffic is one read and one
// write of the image.  The sums run in tap order with -fmad=false, as the
// plain PyTorch version adds them; expf differs from the host's exp by a
// few ulp, hence the stated tolerance.  Shared-memory halo tiles are later
// work.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxTaps = 1024;

__device__ __forceinline__ int wrap(int i, int n) {
  i %= n;
  return i < 0 ? i + n : i;
}

__global__ void denoise_kernel(const float* __restrict__ img,
                               float* __restrict__ out,
                               const float4* __restrict__ taps, int n_taps,
                               int height, int width, float neg_range_scale) {
  __shared__ float4 s_taps[kMaxTaps];
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  for (int i = tid; i < n_taps; i += blockDim.x * blockDim.y) s_taps[i] = taps[i];
  __syncthreads();

  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= width || y >= height) return;

  const float* c = img + (static_cast<size_t>(y) * width + x) * 3;
  const float c0 = c[0], c1 = c[1], c2 = c[2];
  float z = 0.f, a0 = 0.f, a1 = 0.f, a2 = 0.f;
  for (int k = 0; k < n_taps; ++k) {
    const float4 tap = s_taps[k];
    const int xx = wrap(x + static_cast<int>(tap.x), width);
    const int y0 = y + static_cast<int>(tap.y);
    const float* p = img + (static_cast<size_t>(wrap(y0, height)) * width + xx) * 3;
    float s0 = p[0], s1 = p[1], s2 = p[2];
    if (tap.z > 0.f) {
      const float* q =
          img + (static_cast<size_t>(wrap(y0 + 1, height)) * width + xx) * 3;
      s0 = __fadd_rn(s0, __fmul_rn(__fsub_rn(q[0], s0), tap.z));
      s1 = __fadd_rn(s1, __fmul_rn(__fsub_rn(q[1], s1), tap.z));
      s2 = __fadd_rn(s2, __fmul_rn(__fsub_rn(q[2], s2), tap.z));
    }
    const float d0 = __fsub_rn(s0, c0), d1 = __fsub_rn(s1, c1),
                d2 = __fsub_rn(s2, c2);
    const float dist2 = __fadd_rn(__fadd_rn(__fmul_rn(d0, d0), __fmul_rn(d1, d1)),
                                  __fmul_rn(d2, d2));
    const float delta = __fmul_rn(expf(__fmul_rn(dist2, neg_range_scale)), tap.w);
    z = __fadd_rn(z, delta);
    a0 = __fadd_rn(a0, __fmul_rn(delta, s0));
    a1 = __fadd_rn(a1, __fmul_rn(delta, s1));
    a2 = __fadd_rn(a2, __fmul_rn(delta, s2));
  }
  float* o = out + (static_cast<size_t>(y) * width + x) * 3;
  o[0] = __fdiv_rn(a0, z);
  o[1] = __fdiv_rn(a1, z);
  o[2] = __fdiv_rn(a2, z);
}

}  // namespace

extern "C" int tpt_denoise(const float* img, float* out, const float* taps,
                           int n_taps, int height, int width,
                           float neg_range_scale, cudaStream_t stream) {
  if (n_taps <= 0 || n_taps > kMaxTaps || height <= 0 || width <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 block(32, 8);
  const dim3 grid((width + block.x - 1) / block.x,
                  (height + block.y - 1) / block.y);
  denoise_kernel<<<grid, block, 0, stream>>>(
      img, out, reinterpret_cast<const float4*>(taps), n_taps, height, width,
      neg_range_scale);
  return static_cast<int>(cudaGetLastError());
}
