"""The display pass of the reference renderer in plain PyTorch: the running
mean of the frames, the bilateral "smart denoise" and the ACES tone curve
(webgpu-pathtracer src/passes/shaders/accumulate.wgsl:21-28 and
fullscreen.wgsl:53-126, denoise(tex, uv, 5.0, 1.0, 0.08)).

The denoise is evaluated only at the pixels the benchmark checks: a block
of centres and the halo of accumulated radiance around it.  A tap (dx, dy)
samples the texture at the centre plus (dx, dy) pixels with wrap
addressing; a fractional dy blends the two rows it falls between, as the
texture's linear filter does at a pixel centre's column.
"""

from __future__ import annotations

import math

import torch

INV_PI = 0.31830988618379067153776752674503
INV_SQRT_OF_2PI = 0.39894228040143267793994605993439
SIGMA, K_SIGMA, THRESHOLD = 5.0, 1.0, 0.08
RADIUS = int(round(K_SIGMA * SIGMA))  # the halo a block of centres needs, each side


def running_mean(frames):
    """accumulate.wgsl: acc_k = acc_{k-1} + (frame_k - acc_{k-1}) / k, frame
    by frame; `frames` (F, ...) in frame order from frame 1."""
    acc = torch.zeros_like(frames[0])
    for k in range(frames.shape[0]):
        weight = float(torch.tensor(1.0, dtype=torch.float32) / torch.tensor(float(k + 1)))
        acc = acc + (frames[k] - acc) * weight
    return acc


def taps():
    """The denoise's taps in the shader's loop order: (dx, dy, weight), the
    spatial weight in double precision."""
    inv_sigma_qx2 = 0.5 / (SIGMA * SIGMA)
    inv_threshold_sqrt_2pi = INV_SQRT_OF_2PI / THRESHOLD
    out = []
    x = -float(RADIUS)
    while x <= RADIUS:
        pt = math.sqrt(RADIUS * RADIUS - x * x)
        y = -pt
        while y <= pt:
            blur = math.exp(-(x * x + y * y) * inv_sigma_qx2) * INV_PI * inv_sigma_qx2
            out.append((int(x), y, inv_threshold_sqrt_2pi * blur))
            y += 1.0
        x += 1.0
    return out


def denoise_block(tile, block: int):
    """Denoise the block x block centres of `tile` ((block + 2 RADIUS)^2, 3),
    whose halo is RADIUS pixels each side."""
    range_scale = 0.5 / (THRESHOLD * THRESHOLD)
    r = RADIUS
    centre = tile[r:r + block, r:r + block]
    z = torch.zeros_like(centre[..., :1])
    a = torch.zeros_like(centre)
    for dx, dy, weight in taps():
        y0 = math.floor(dy)
        frac = dy - y0
        s = tile[r + y0:r + y0 + block, r + dx:r + dx + block]
        if frac > 0.0:
            s1 = tile[r + y0 + 1:r + y0 + 1 + block, r + dx:r + dx + block]
            s = s + (s1 - s) * frac
        d = s - centre
        dist2 = d[..., 0:1] * d[..., 0:1] + d[..., 1:2] * d[..., 1:2] + d[..., 2:3] * d[..., 2:3]
        delta = torch.exp(dist2 * -range_scale) * weight
        z = z + delta
        a = a + delta * s
    return a / z


ACES_IN = ((0.59719, 0.35458, 0.04823), (0.07600, 0.90834, 0.01566), (0.02840, 0.13383, 0.83777))
ACES_OUT = ((1.60475, -0.53108, -0.07367), (-0.10208, 1.10813, -0.00605),
            (-0.00327, -0.07276, 1.07602))


def _apply(m, c):
    return torch.stack([c[..., 0] * m[i][0] + c[..., 1] * m[i][1] + c[..., 2] * m[i][2]
                        for i in range(3)], dim=-1)


def aces(color):
    """fullscreen.wgsl:88-103: the fitted ACES curve, clamped, then 1/2.2."""
    v = _apply(ACES_IN, color)
    a = v * (v + 0.0245786) - 0.000090537
    b = v * (0.983729 * v + 0.4329510) + 0.238081
    return torch.clamp(_apply(ACES_OUT, a / b), 0.0, 1.0) ** (1.0 / 2.2)
