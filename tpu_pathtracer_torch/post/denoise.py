"""Smart denoise: circular-kernel bilateral Gaussian blur (plain PyTorch).

The port of `tpu_pathtracer.post.denoise.smart_denoise` (the reference's
fragment shader, src/passes/shaders/fullscreen.wgsl:53-86, called with
sigma=5, kSigma=1, threshold=0.08): circular support with fractional row
offsets resolved by a two-row lerp, wrap addressing (torch.roll), spatial x
range Gaussian weights.  This is the plain version of the CUDA kernel in
ops/kernels/denoise.py; both read the same tap table (`tap_table`).
"""

from __future__ import annotations

import math

import numpy as np
import torch

INV_PI = np.float32(0.31830988618379067153776752674503)
INV_SQRT_OF_2PI = np.float32(0.39894228040143267793994605993439)


def _taps(radius: float):
    """Static (dx, dy) tap list matching the WGSL loop order."""
    taps = []
    x = -radius
    while x <= radius:
        pt = math.sqrt(radius * radius - x * x)
        y = -pt
        while y <= pt:
            taps.append((x, y))
            y += 1.0
        x += 1.0
    return taps


def tap_table(sigma: float = 5.0, k_sigma: float = 1.0, threshold: float = 0.08):
    """(taps (n, 4) f32 numpy, range_scale f32).

    Row = (column offset, floor of the row offset, row fraction, weight),
    weight = f32(inv_threshold_sqrt_2pi * blur) computed in Python double as
    the JAX package does; a tap's contribution is
    exp(-dist2 * range_scale) * weight."""
    radius = float(round(k_sigma * sigma))
    inv_sigma_qx2 = 0.5 / (sigma * sigma)
    inv_sigma_qx2_pi = float(INV_PI) * inv_sigma_qx2
    inv_threshold_sqx2 = 0.5 / (threshold * threshold)
    inv_threshold_sqrt_2pi = float(INV_SQRT_OF_2PI) / threshold
    rows = []
    for dx, dy in _taps(radius):
        y0 = math.floor(dy)
        blur = math.exp(-(dx * dx + dy * dy) * inv_sigma_qx2) * inv_sigma_qx2_pi
        rows.append((int(dx), y0, np.float32(dy - y0), np.float32(inv_threshold_sqrt_2pi * blur)))
    return np.asarray(rows, np.float32).reshape(-1, 4), np.float32(inv_threshold_sqx2)


def smart_denoise(img, sigma: float = 5.0, k_sigma: float = 1.0, threshold: float = 0.08):
    """img: (H, W, 3) f32 -> (H, W, 3) f32, on any device."""
    taps, range_scale = tap_table(sigma, k_sigma, threshold)
    center = img
    z = torch.zeros_like(img[..., :1])
    a = torch.zeros_like(img)
    for ix, y0, fy, w in taps.tolist():
        ix, y0 = int(ix), int(y0)
        # value[p] = img[p + d] with wrap
        s = torch.roll(img, shifts=(-y0, -ix), dims=(0, 1))
        if fy > 0.0:
            s1 = torch.roll(img, shifts=(-(y0 + 1), -ix), dims=(0, 1))
            s = s + (s1 - s) * fy
        d = s - center
        dist2 = d[..., 0:1] * d[..., 0:1] + d[..., 1:2] * d[..., 1:2] + d[..., 2:3] * d[..., 2:3]
        delta = torch.exp(dist2 * -float(range_scale)) * w
        z = z + delta
        a = a + delta * s
    return a / z
