"""All-pairs Möller–Trumbore intersection in the bilinear form: the portable
oracle the MT kernel is held against.

The port of `tpu_pathtracer.ops.mt_matmul`.  With the 10-feature ray vector
phi = [1, ro, rd, ro x rd], the four MT determinants of every ray x triangle
pair are dot products with a per-triangle coefficient table
(`triangle_columns`):

    a   = rd . (e2 x e1)
    u*a = e2 . (ro x rd) - rd . (e2 x p0)
    v*a = -e1 . (ro x rd) - rd . (p0 x e1)
    t*a = ro . (e1 x e2) - e2 . (p0 x e1)

The products are summed over the nonzero features only (`FEATS`), in
ascending feature order, as explicit elementwise products: no matrix
product, so no TF32 and one rounding per operation on every device.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .vecmath import EPSILON, INF, cross

# Feature indices of phi = [1, ro(1:4), rd(4:7), ro x rd(7:10)] that carry
# nonzero coefficients per determinant [a, u*a, v*a, t*a].
FEATS = ((4, 5, 6), (4, 5, 6, 7, 8, 9), (4, 5, 6, 7, 8, 9), (0, 1, 2, 3))

_BIG_I32 = 2**31 - 1


class Hit(NamedTuple):
    """SoA hit record over the ray axis (reference Hit struct + barycentrics)."""

    hit: torch.Tensor  # (R,) bool
    t: torch.Tensor  # (R,) f32 (INF on miss)
    tri: torch.Tensor  # (R,) i32 triangle index (-1 on miss)
    u: torch.Tensor  # (R,) f32 barycentric for p1
    v: torch.Tensor  # (R,) f32 barycentric for p2


def miss_hit(r: int, device) -> Hit:
    """All-miss record (the empty-scene early out, raytrace.wgsl:205-211)."""
    z = torch.zeros((r,), dtype=torch.float32, device=device)
    return Hit(torch.zeros((r,), dtype=torch.bool, device=device),
               torch.full((r,), float(INF), device=device),
               torch.full((r,), -1, dtype=torch.int32, device=device), z, z.clone())


def triangle_columns(tri_pos):
    """Per-triangle MT coefficients: tri_pos (N, 9) -> (10, 4, N) f32; axis 1
    is [a, u*a, v*a, t*a], axis 0 the phi features."""
    p0 = tri_pos[:, 0:3]
    e1 = tri_pos[:, 3:6] - p0
    e2 = tri_pos[:, 6:9] - p0
    n = cross(e2, e1)
    e2xp0 = cross(e2, p0)
    p0xe1 = cross(p0, e1)
    e1xe2 = cross(e1, e2)
    zeros3 = torch.zeros_like(p0)
    zeros1 = torch.zeros_like(p0[:, :1])
    col_a = torch.cat([zeros1, zeros3, n, zeros3], dim=1)
    col_ua = torch.cat([zeros1, zeros3, -e2xp0, e2], dim=1)
    col_va = torch.cat([zeros1, zeros3, -p0xe1, -e1], dim=1)
    ta_const = -torch.sum(e2 * p0xe1, dim=1, keepdim=True)
    col_ta = torch.cat([ta_const, e1xe2, zeros3, zeros3], dim=1)
    cols = torch.stack([col_a, col_ua, col_va, col_ta], dim=1)  # (N, 4, 10)
    return cols.permute(2, 1, 0).contiguous()  # (10, 4, N)


def ray_features(ro, rd):
    """phi(ray): (R, 3),(R, 3) -> (R, 10) = [1, ro, rd, ro x rd]."""
    return torch.cat([torch.ones_like(ro[:, :1]), ro, rd, cross(ro, rd)], dim=1)


def determinants(phi, coef):
    """The four MT determinants of every (ray, triangle) pair.

    phi: (..., 10, R) ray features; coef: (..., 4, C, 10) coefficients.
    Returns [a, ua, va, ta], each (..., C, R), summed in FEATS order."""
    out = []
    for q in range(4):
        acc = None
        for k in FEATS[q]:
            term = coef[..., q, :, k, None] * phi[..., k, None, :]
            acc = term if acc is None else acc + term
        out.append(acc)
    return out


def epilogue(a, ua, va, ta):
    """MT validity in the multiplied-through form (ts > EPSILON*|a|) and
    (t, u, v) for every pair: inputs (..., C, R); t is INF where invalid."""
    abs_a = torch.abs(a)
    sa = torch.sign(a)
    us = ua * sa
    vs = va * sa
    ts = ta * sa
    ok_a = abs_a >= float(EPSILON)
    valid = (
        ok_a
        & (us >= 0.0)
        & (us <= abs_a)
        & (vs >= 0.0)
        & (us + vs <= abs_a)
        & (ts > float(EPSILON) * abs_a)
    )
    f = 1.0 / torch.where(ok_a, a, torch.ones_like(a))
    t = torch.where(valid, ta * f, torch.full_like(a, float(INF)))
    return t, ua * f, va * f


def nearest(t, u, v, base):
    """Nearest valid pair along axis -2 (lowest index on exact-t ties).
    t/u/v: (..., C, R); base: global index of row 0 (int or (...,) tensor).
    Returns (tmin, imin, u_w, v_w), each (..., R)."""
    tmin = t.min(dim=-2).values
    rows = torch.arange(t.shape[-2], device=t.device, dtype=torch.int32)[:, None]
    big = torch.full_like(t, _BIG_I32, dtype=torch.int32)
    jmin = torch.where(t == tmin.unsqueeze(-2), rows.expand_as(t), big).min(dim=-2).values
    j = jmin.clamp(max=t.shape[-2] - 1).long().unsqueeze(-2)
    u_w = torch.gather(u, -2, j).squeeze(-2)
    v_w = torch.gather(v, -2, j).squeeze(-2)
    if isinstance(base, torch.Tensor):
        base = base.unsqueeze(-1)
    return tmin, (jmin + base).to(torch.int32), u_w, v_w


def mt_intersect(tri_pos, ro, rd, *, chunk: int = 512, ray_chunk: int = 8192) -> Hit:
    """All-pairs MT intersection (the oracle); returns `Hit`.

    tri_pos: (N, 9) packed vertices; ro, rd: (R, 3).  Triangles are walked
    in ascending chunks with a strict `<` against the running best, so exact-t
    ties keep the lowest triangle index (brute_force_intersect contract).
    Rays and triangles are chunked to bound the (C, R) intermediates."""
    r_total, n = ro.shape[0], tri_pos.shape[0]
    if n == 0:
        return miss_hit(r_total, ro.device)
    phi_all = ray_features(ro, rd).T  # (10, R)
    coef_all = triangle_columns(tri_pos).permute(1, 2, 0)  # (4, N, 10)
    outs = []
    for r0 in range(0, r_total, ray_chunk):
        phi = phi_all[:, r0:r0 + ray_chunk]
        r = phi.shape[1]
        best_t = torch.full((r,), float(INF), device=ro.device)
        best_i = torch.full((r,), -1, dtype=torch.int32, device=ro.device)
        best_u = torch.zeros((r,), device=ro.device)
        best_v = torch.zeros((r,), device=ro.device)
        for c0 in range(0, n, chunk):
            t, u, v = epilogue(*determinants(phi, coef_all[:, c0:c0 + chunk]))
            tmin, imin, u_w, v_w = nearest(t, u, v, c0)
            take = tmin < best_t
            best_t = torch.where(take, tmin, best_t)
            best_i = torch.where(take, imin, best_i)
            best_u = torch.where(take, u_w, best_u)
            best_v = torch.where(take, v_w, best_v)
        outs.append((best_t, best_i, best_u, best_v))
    best_t, best_i, best_u, best_v = (torch.cat(x) for x in zip(*outs))
    return Hit(best_i >= 0, best_t, best_i, best_u, best_v)


def mt_intersect_diff(tri_pos, ro, rd, *, chunk: int = 512) -> Hit:
    """Differentiable variant: the nearest triangle is chosen on detached
    inputs and its (t, u, v) replayed analytically (`intersect.replay_hit`,
    the contract of `intersect.bvh_intersect_diff`)."""
    from .intersect import replay_hit

    h = mt_intersect(tri_pos.detach(), ro.detach(), rd.detach(), chunk=chunk)
    return replay_hit(tri_pos, ro, rd, h)
