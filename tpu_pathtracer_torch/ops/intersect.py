"""Differentiable hit replay for the path-replay gradient.

The port of `replay_hit` from `tpu_pathtracer.ops.intersect`.  The
traversal intersectors of that module (`bvh_intersect`,
`bvh_fat_intersect`) are not ported yet (ROADMAP.md); the MT kernels of
ops/kernels/ choose the triangles here.
"""

from __future__ import annotations

import torch

from .mt_matmul import Hit
from .vecmath import EPSILON, INF, cross, dot

__all__ = ["Hit", "replay_hit"]


def replay_hit(tri_pos, ro, rd, h: Hit) -> Hit:
    """Analytically recompute (t, u, v) for an already-chosen triangle.

    The discrete choice of triangle `h.tri` comes from an intersector run on
    detached inputs; (t, u, v) are recomputed for that triangle with the
    Möller–Trumbore math, which autograd differentiates with respect to the
    ray origins and directions (R, 3) and the packed vertex rows tri_pos
    (N, 9).  Visibility is treated as locally constant (path-replay
    backprop: silhouette terms are out of scope).

    The denominator is pinned to 1 on miss lanes before the division, so
    the backward pass never forms 0 * inf there."""
    tri_safe = h.tri.clamp(0, tri_pos.shape[0] - 1).long()
    td = torch.index_select(tri_pos, 0, tri_safe)
    p0, p1, p2 = td[:, 0:3], td[:, 3:6], td[:, 6:9]

    edge1 = p1 - p0
    edge2 = p2 - p0
    hvec = cross(rd, edge2)
    a = dot(edge1, hvec)
    # On a hit lane the intersector accepted this triangle, so |a| >= EPSILON;
    # miss lanes carry clamped garbage: pin their denominator to 1.
    a_safe = torch.where(h.hit & (torch.abs(a) >= float(EPSILON)), a, 1.0)
    f = 1.0 / a_safe
    s = ro - p0
    u = f * dot(s, hvec)
    q = cross(s, edge1)
    v = f * dot(rd, q)
    t = f * dot(edge2, q)

    t = torch.where(h.hit, t, float(INF))
    u = torch.where(h.hit, u, 0.0)
    v = torch.where(h.hit, v, 0.0)
    return Hit(h.hit, t, h.tri, u, v)
