"""Small vector helpers over trailing-axis-3 tensors (f32)."""

from __future__ import annotations

import numpy as np
import torch

INF = np.float32(1e20)  # raytrace.wgsl:6 -- a finite sentinel, not inf
EPSILON = np.float32(1e-6)  # raytrace.wgsl:7


def dot(a, b):
    return torch.sum(a * b, dim=-1)


def cross(a, b):
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2, a0 * b1 - a1 * b0], dim=-1)


def normalize(v):
    n = torch.sqrt(torch.sum(v * v, dim=-1, keepdim=True))
    return v / n


def reflect(d, n):
    """WGSL reflect: d - 2*dot(d,n)*n."""
    return d - 2.0 * dot(d, n)[..., None] * n


def mix(a, b, t):
    return a + (b - a) * t
