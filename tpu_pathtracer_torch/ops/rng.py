"""Counter-free sequential RNG, bit-exact with the reference's WGSL stream.

The port of `tpu_pathtracer.ops.rng`: a u32 seed per pixel threaded through
every sampling decision (reference: src/passes/shaders/raytrace.wgsl:253-287).
Seeds are int64 tensors holding values in [0, 2**32): every product of the
PCG hash fits in 63 bits, so masking to 32 bits after each step reproduces
u32 wrap-around, and right shifts of non-negative int64 are logical.  (torch
has no portable u32 arithmetic on CUDA.)

All functions are shape-polymorphic and return `(new_seed, value)`.
"""

from __future__ import annotations

import numpy as np
import torch

SEED = 123456789  # raytrace.wgsl:1
TWOPI = np.float32(6.28318530718)  # raytrace.wgsl:3
U32_NORM = np.float32(4294967295.0)  # rounds to 2^32 in f32, like WGSL's literal
_MASK = 0xFFFFFFFF


def pixel_seed(pixel_index, frame: int):
    """seed = index + frame*719393 + SEED (raytrace.wgsl:435-436), mod 2**32."""
    idx = pixel_index.to(torch.int64) & _MASK
    return (idx + ((int(frame) * 719393 + SEED) & _MASK)) & _MASK


def rand(seed):
    """PCG-style hash advance (raytrace.wgsl:253-259); returns uniform f32 [0,1]."""
    seed = (seed * 747796405 + 2891336453) & _MASK
    word = (((seed >> ((seed >> 28) + 4)) ^ seed) * 277803737) & _MASK
    word = (word >> 22) ^ word
    return seed, word.to(torch.float32) / float(U32_NORM)


def rand_normal(seed):
    """Box–Muller (raytrace.wgsl:261-265)."""
    seed, r1 = rand(seed)
    seed, r2 = rand(seed)
    theta = float(TWOPI) * r1
    rho = torch.sqrt(-2.0 * torch.log(r2))
    return seed, rho * torch.cos(theta)


def rand_direction(seed):
    """Uniform sphere direction via 3 normals (raytrace.wgsl:267-272); (..., 3)."""
    seed, x = rand_normal(seed)
    seed, y = rand_normal(seed)
    seed, z = rand_normal(seed)
    v = torch.stack([x, y, z], dim=-1)
    n = torch.sqrt(torch.sum(v * v, dim=-1, keepdim=True))
    return seed, v / n


def rand_cosine_hemisphere(seed, normal):
    """normalize(normal + random_direction) (raytrace.wgsl:279-281); (..., 3)."""
    seed, d = rand_direction(seed)
    v = normal + d
    n = torch.sqrt(torch.sum(v * v, dim=-1, keepdim=True))
    return seed, v / n


def disk_from_uniforms(r1, r2):
    """Two uniforms -> uniform disk point (raytrace.wgsl:283-287); (..., 2)."""
    theta = float(TWOPI) * r1
    rho = torch.sqrt(r2)
    return torch.stack([rho * torch.cos(theta), rho * torch.sin(theta)], dim=-1)


def rand_point_in_circle(seed):
    """Uniform disk point (raytrace.wgsl:283-287). Returns (..., 2)."""
    seed, r1 = rand(seed)
    seed, r2 = rand(seed)
    return seed, disk_from_uniforms(r1, r2)
