"""Blue-noise texture generation (void-and-cluster), numpy only.

A copy of `tpu_pathtracer.utils.bluenoise` (the port imports nothing of
the JAX package; tests/test_torch_bluenoise.py holds the two copies' tables
byte-equal).  The reference vendors a 64x64 blue-noise PNG that it loads
nowhere (reference: src/assets/noise.ts; the loader is commented out at
src/renderer.ts:562-588).  This module generates blue-noise ranking
textures with Ulichney's void-and-cluster algorithm instead:
`blue_noise(64)` returns a (64, 64) array of unique ranks in [0, 1) whose
spectrum is high-frequency ("blue"), the per-pixel offsets of the
blue-noise AA jitter (`ops.trace.render_frame(blue_noise=...)`).
"""

from __future__ import annotations

import numpy as np


def _energy_kernel(n: int, sigma: float = 1.5) -> np.ndarray:
    """Toroidal Gaussian energy splat centered at (0, 0)."""
    ax = np.arange(n)
    d = np.minimum(ax, n - ax).astype(np.float64)  # wrap-around distance
    d2 = d[:, None] ** 2 + d[None, :] ** 2
    return np.exp(-d2 / (2.0 * sigma * sigma))


def blue_noise(n: int = 64, sigma: float = 1.5, seed: int = 0) -> np.ndarray:
    """(n, n) float32 blue-noise ranks in [0, 1), each texel unique.

    Void-and-cluster: start from a random dither pattern, relax it by
    repeatedly moving the tightest-cluster point into the largest void, then
    rank all texels by removal/insertion order.
    """
    rng = np.random.default_rng(seed)
    total = n * n
    kernel = _energy_kernel(n, sigma)
    kf = np.fft.rfft2(kernel)

    def energy(binary):
        return np.fft.irfft2(np.fft.rfft2(binary) * kf, s=(n, n))

    # initial pattern: ~10% ones
    ones = max(1, total // 10)
    binary = np.zeros((n, n))
    idx = rng.choice(total, ones, replace=False)
    binary.flat[idx] = 1.0

    # relaxation: swap tightest cluster -> largest void until stable
    for _ in range(total):
        e = energy(binary)
        cluster = np.where(binary == 1, e, -np.inf)
        ci = np.argmax(cluster)
        binary.flat[ci] = 0.0
        e = energy(binary)
        void = np.where(binary == 0, e, np.inf)
        vi = np.argmin(void)
        binary.flat[vi] = 1.0
        if vi == ci:
            break

    rank = np.zeros(total, np.int64)
    work = binary.copy()

    # phase 1: remove ones, tightest cluster first -> ranks ones-1 .. 0
    for r in range(ones - 1, -1, -1):
        e = energy(work)
        ci = np.argmax(np.where(work == 1, e, -np.inf))
        work.flat[ci] = 0.0
        rank[ci] = r

    # phase 2: refill into the largest void -> ranks ones .. total-1
    work = binary.copy()
    for r in range(ones, total):
        e = energy(work)
        vi = np.argmin(np.where(work == 0, e, np.inf))
        work.flat[vi] = 1.0
        rank[vi] = r

    return (rank.reshape(n, n).astype(np.float32) + 0.5) / np.float32(total)


def blue_noise_table(n: int = 64, seed: int = 0):
    """(n, n, 2) float32 table of two independent blue-noise rank planes —
    the per-pixel Cranley–Patterson offsets for the 2D AA jitter
    (ops/trace.render_frame blue_noise=...)."""
    return np.stack([blue_noise(n, seed=seed), blue_noise(n, seed=seed + 1)], axis=-1)
