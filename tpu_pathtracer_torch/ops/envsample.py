"""Environment-map sampling: equirect UV mapping, texture filtering and CDF
importance sampling.

The port of `tpu_pathtracer.ops.envsample` (reference:
src/passes/shaders/raytrace.wgsl:289-371; linear sampler with
clamp-to-edge for the radiance, nearest for the CDF tables).  The
importance sampler inverts the exclusive per-texel CDFs of
`scene.envmap.build_cdf_tables` exactly (integer binary search, then a
uniform place inside the texel), so its density is `env.sample_pdf` and
the L/pdf estimator is unbiased; the operations and their order are the
JAX package's, so seeds and texel indices come out bit-equal.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import rng
from .vecmath import EPSILON

INVPI = np.float32(0.31830988618)  # raytrace.wgsl:4
INVTWOPI = np.float32(0.15915494309)  # raytrace.wgsl:5


def env_uv_from_ray(rd, rotation):
    """Equirect UV for (possibly non-unit) directions rd (..., 3);
    rotation: () f32 tensor.  Returns (..., 2)."""
    cos_r = torch.cos(rotation)
    sin_r = torch.sin(rotation)
    dx = rd[..., 0] * cos_r - rd[..., 2] * sin_r
    dy = rd[..., 1]
    dz = rd[..., 0] * sin_r + rd[..., 2] * cos_r
    phi = torch.atan2(dx, dz)
    theta = torch.asin(torch.clamp(dy, -1.0, 1.0))
    return torch.stack([phi * float(INVTWOPI) + 0.5, -theta * float(INVPI) + 0.5], dim=-1)


def sample_bilinear(img, uv):
    """Bilinear texture fetch with clamp-to-edge; img (H, W, C), uv (..., 2)."""
    h, w = img.shape[0], img.shape[1]
    x = uv[..., 0] * w - 0.5
    y = uv[..., 1] * h - 0.5
    x0f = torch.floor(x)
    y0f = torch.floor(y)
    fx = (x - x0f)[..., None]
    fy = (y - y0f)[..., None]
    x0i = x0f.to(torch.int64)
    y0i = y0f.to(torch.int64)
    x0 = x0i.clamp(0, w - 1)
    y0 = y0i.clamp(0, h - 1)
    x1 = (x0i + 1).clamp(0, w - 1)
    y1 = (y0i + 1).clamp(0, h - 1)
    c00 = img[y0, x0]
    c10 = img[y0, x1]
    c01 = img[y1, x0]
    c11 = img[y1, x1]
    top = c00 + (c10 - c00) * fx
    bot = c01 + (c11 - c01) * fx
    return top + (bot - top) * fy


def pack_env_patches(radiance):
    """(H, W, 3) -> (H*W, 12) rows holding each texel's 2x2 bilinear patch
    [c(y,x), c(y,x+1), c(y+1,x), c(y+1,x+1)] with clamp-to-edge neighbours:
    one row gather per lookup instead of four."""
    h, w = radiance.shape[0], radiance.shape[1]
    xs = torch.clamp(torch.arange(w, device=radiance.device) + 1, max=w - 1)
    ys = torch.clamp(torch.arange(h, device=radiance.device) + 1, max=h - 1)
    c10 = radiance[:, xs]
    c01 = radiance[ys]
    c11 = c01[:, xs]
    return torch.cat([radiance, c10, c01, c11], dim=-1).reshape(h * w, 12)


def env_radiance_packed(patches, shape, uv):
    """Bilinear env fetch from `pack_env_patches` rows; matches
    `sample_bilinear`, including its clamp-to-edge taps (when the left/top
    tap clamps, both taps read one texel: the fraction is zeroed)."""
    h, w = shape
    x = uv[..., 0] * w - 0.5
    y = uv[..., 1] * h - 0.5
    x0f = torch.floor(x)
    y0f = torch.floor(y)
    fx = torch.where(x0f < 0, 0.0, x - x0f)[..., None]
    fy = torch.where(y0f < 0, 0.0, y - y0f)[..., None]
    x0 = x0f.to(torch.int64).clamp(0, w - 1)
    y0 = y0f.to(torch.int64).clamp(0, h - 1)
    row = patches[y0 * w + x0]  # (..., 12) single gather
    top = row[..., 0:3] + (row[..., 3:6] - row[..., 0:3]) * fx
    bot = row[..., 6:9] + (row[..., 9:12] - row[..., 6:9]) * fx
    return top + (bot - top) * fy


def sample_nearest(img, uv):
    """Nearest texture fetch with clamp-to-edge; img (H, W) or (H, W, C),
    uv (..., 2)."""
    h, w = img.shape[0], img.shape[1]
    x = torch.floor(uv[..., 0] * w).to(torch.int64).clamp(0, w - 1)
    y = torch.floor(uv[..., 1] * h).to(torch.int64).clamp(0, h - 1)
    return img[y, x]


def _invert_exclusive_cdf(cdf_at, target, size: int):
    """Exact inversion of an exclusive per-texel CDF: `cdf_at(i)` gives
    cdf[i] = P(texels < i) for int64 i in [0, size).  A binary search of
    ceil(log2(size)) steps finds the texel x with cdf[x] <= target <
    cdf[x+1]; the sample then lies in it at the piecewise-linear fraction.
    Returns (x int64, coordinate f32 in [0, 1)).  Every index stays in
    [0, size): on the card an index out of range is a device assert."""
    lo = torch.zeros(target.shape, dtype=torch.int64, device=target.device)  # cdf[lo] <= target
    hi = torch.full_like(lo, size)  # target < cdf[hi] (cdf[size] = 1)
    for _ in range(max(1, math.ceil(math.log2(max(size, 2))))):
        mid = (lo + hi) // 2
        go_right = cdf_at(mid) <= target
        lo = torch.where(go_right, mid, lo)
        hi = torch.where(go_right, hi, mid)
    c_lo = cdf_at(lo)
    c_hi = torch.where(lo + 1 < size, cdf_at((lo + 1).clamp(max=size - 1)), 1.0)
    width = torch.clamp(c_hi - c_lo, min=float(EPSILON))
    frac = torch.clamp((target - c_lo) / width, 0.0, 1.0)
    return lo, (lo.to(torch.float32) + frac) / float(np.float32(size))


def env_importance_sample(env, seed):
    """CDF inversion sampling of the environment map: the row from the
    marginal CDF, then the column from that row's conditional CDF.
    Consumes 2 uniforms.  Returns (seed, uv (..., 2)); the sample's density
    is `env.sample_pdf` at its texel."""
    seed, r1 = rng.rand(seed)
    seed, r2 = rng.rand(seed)
    marginal = env.marginal_cdf[:, 0]
    y, v = _invert_exclusive_cdf(lambda i: marginal[i], r1, env.height)
    _, u = _invert_exclusive_cdf(lambda i: env.conditional_cdf[y, i], r2, env.width)
    return seed, torch.stack([u, v], dim=-1)


def env_pdf(env, uv):
    """Density of `env_importance_sample` at uv (nearest texel of
    `env.sample_pdf`), floored at EPSILON so that an environment with no
    light (every density 0) still gives finite L/pdf."""
    return torch.clamp(sample_nearest(env.sample_pdf, uv), min=float(EPSILON))
