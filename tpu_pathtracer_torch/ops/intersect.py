"""Ray-primitive intersection, BVH traversal and the differentiable hit
replay, as torch ops.

The port of `tpu_pathtracer.ops.intersect`, with the reference kernels'
semantics:

  * Möller–Trumbore with EPSILON determinant rejection and t > EPSILON
    acceptance (reference: src/passes/shaders/raytrace.wgsl:78-116);
  * slab ray-AABB test with the parallel-axis containment check
    (raytrace.wgsl:118-152);
  * traversals: the skip-link walk over `PackedGeometry.nodes`
    (`bvh_intersect`), the fat-leaf skip-link walk over `fat_nodes`
    (`bvh_fat_intersect`, the 'bvh8' intersector), and the literal 64-deep
    stack walk with its overflow early exit (`bvh_intersect_stack`, kept as
    the semantic cross-check).  Nearest hit wins with a strict `<`; inside a
    fat leaf the lowest row takes exact-t ties (`torch.argmin` returns the
    first minimum, as `jnp.argmin` does).

Each ray's walk is independent of the others.  The JAX package steps every
lane of a batch in lockstep until the last one finishes; here the host
checks every `_CHECK_EVERY` steps which lanes still walk and carries on
with those alone (`_walk`).  A step is an identity on a lane that has
finished, so every lane ends in the state the per-step loop gives it.

Columns of `nodes` and `fat_nodes` that hold int32 bit patterns are read
through an int32 view of those columns, never through float arithmetic.
"""

from __future__ import annotations

import torch

from .mt_matmul import Hit, miss_hit
from .vecmath import EPSILON, INF, cross, dot

__all__ = [
    "Hit", "MAX_STACK_SIZE", "brute_force_intersect", "bvh_fat_intersect", "bvh_intersect",
    "bvh_intersect_diff", "bvh_intersect_stack", "ray_aabb", "ray_aabb_t", "ray_triangle",
    "replay_hit", "skip_link_walk",
]

MAX_STACK_SIZE = 64  # raytrace.wgsl:8
_CHECK_EVERY = 8  # walk steps between host checks for finished lanes


def ray_triangle(ro, rd, p0, p1, p2):
    """Möller–Trumbore, elementwise over matching (broadcast) leading
    shapes.  Returns (valid, t, u, v)."""
    edge1 = p1 - p0
    edge2 = p2 - p0
    h = cross(rd, edge2)
    a = dot(edge1, h)
    non_parallel = torch.abs(a) >= float(EPSILON)
    f = 1.0 / a
    s = ro - p0
    u = f * dot(s, h)
    q = cross(s, edge1)
    v = f * dot(rd, q)
    t = f * dot(edge2, q)
    valid = non_parallel & (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (u + v <= 1.0) & (
        t > float(EPSILON))
    return valid, t, u, v


def ray_aabb_t(ro, rd, bmin, bmax):
    """Slab test that also returns the entry distance tmin: (hit, tmin).
    The reference's per-axis early outs collapse to: every parallel axis
    must contain the origin, and tmax >= max(0, tmin)."""
    inf = float(INF)
    parallel = torch.abs(rd) < float(EPSILON)
    inside = (ro >= bmin) & (ro <= bmax)
    ok_parallel = torch.all(~parallel | inside, dim=-1)
    safe_rd = torch.where(parallel, 1.0, rd)
    t1 = (bmin - ro) / safe_rd
    t2 = (bmax - ro) / safe_rd
    tnear = torch.where(parallel, -inf, torch.minimum(t1, t2))
    tfar = torch.where(parallel, inf, torch.maximum(t1, t2))
    tmin = torch.amax(tnear, dim=-1)
    tmax = torch.amin(tfar, dim=-1)
    return ok_parallel & (tmax >= torch.clamp(tmin, min=0.0)), tmin


def ray_aabb(ro, rd, bmin, bmax):
    """Slab test (raytrace.wgsl:118-152), elementwise; returns a bool mask."""
    return ray_aabb_t(ro, rd, bmin, bmax)[0]


def _walk(step, rays, state, walking):
    """Run `step(rays, state) -> state` until no lane walks; returns the
    final state.  `rays` and `state` are tuples of tensors over the lane
    axis 0; `walking(state)` is the (R,) mask of lanes not yet finished, on
    which `step` must be an identity.  Every `_CHECK_EVERY` steps the host
    reads how many lanes still walk and, once a quarter or more have
    finished, writes them out and keeps walking the rest alone."""
    out = [x.clone() for x in state]
    lanes = torch.arange(state[0].shape[0], device=state[0].device)
    while True:
        for _ in range(_CHECK_EVERY):
            state = step(rays, state)
        live = walking(state)
        n_live = int(live.sum())
        if n_live == 0 or 4 * n_live <= 3 * live.numel():
            for o, x in zip(out, state):
                o[lanes] = x
            if n_live == 0:
                return out
            keep = live.nonzero().squeeze(1)
            lanes = lanes[keep]
            rays = tuple(x[keep] for x in rays)
            state = tuple(x[keep] for x in state)


def _start(ro):
    """Initial best (t, tri, u, v) for every lane: a miss."""
    r = ro.shape[0]
    z = torch.zeros((r,), dtype=torch.float32, device=ro.device)
    return (torch.full((r,), float(INF), device=ro.device),
            torch.full((r,), -1, dtype=torch.int32, device=ro.device), z, z.clone())


def _link_columns(table, first: int, count: int):
    """Columns first..first+count-1 of an f32 node table, read as the int32
    bit patterns they hold: (K, count) int32."""
    return table[:, first:first + count].contiguous().view(torch.int32)


def bvh_intersect(nodes, tri_pos, ro, rd) -> Hit:
    """Stackless skip-link BVH traversal.

    nodes: (K, 8) packed skip-link nodes; tri_pos: (N, 9) packed vertex
    rows (scene.types.PackedGeometry); ro, rd: (R, 3).  Each ray carries one
    node pointer; a node whose entry distance is not below the ray's best
    hit is skipped, so no triangle below it can win.  The nearest-hit
    result matches the reference's stack traversal (raytrace.wgsl:154-203)
    up to exact-t ties, without its 64-deep overflow."""
    r, k = ro.shape[0], nodes.shape[0]
    if k == 0:  # empty-scene early out (raytrace.wgsl:205-211)
        return miss_hit(r, ro.device)
    return skip_link_walk(nodes, tri_pos, ro, rd,
                          torch.zeros((r,), dtype=torch.int32, device=ro.device))


def skip_link_walk(nodes, tri_pos, ro, rd, ptr, walking=None) -> Hit:
    """`bvh_intersect`'s walk from the node pointers `ptr` (R,) int32 of a
    non-empty node table: a lane that starts at the end sentinel K is
    finished and misses.  `walking(ptr)` gives the (R,) lanes that the
    walk keeps stepping (by default `ptr < K`); it must hold every lane
    with `ptr < K`, since a step is an identity only on a finished lane."""
    k = nodes.shape[0]
    links = _link_columns(nodes, 6, 2)  # [tri, miss]
    n_tri = tri_pos.shape[0]

    def step(rays, state):
        ro, rd = rays
        ptr, best_t, best_tri, best_u, best_v = state
        active = ptr < k
        p = torch.where(active, ptr, 0)
        nd = torch.index_select(nodes, 0, p)
        box_hit, box_tmin = ray_aabb_t(ro, rd, nd[:, 0:3], nd[:, 3:6])
        box_hit = box_hit & active & (box_tmin < best_t)
        ln = torch.index_select(links, 0, p)
        tri_idx, miss = ln[:, 0], ln[:, 1]
        is_leaf = tri_idx >= 0
        td = torch.index_select(tri_pos, 0, tri_idx.clamp(0, n_tri - 1))
        valid, t, u, v = ray_triangle(ro, rd, td[:, 0:3], td[:, 3:6], td[:, 6:9])
        take = box_hit & is_leaf & valid & (t < best_t)
        best_t = torch.where(take, t, best_t)
        best_tri = torch.where(take, tri_idx, best_tri)
        best_u = torch.where(take, u, best_u)
        best_v = torch.where(take, v, best_v)
        nxt = torch.where(box_hit & ~is_leaf, p + 1, miss)
        return torch.where(active, nxt, ptr), best_t, best_tri, best_u, best_v

    if walking is None:
        walking = lambda ptr: ptr < k
    _, t, tri, u, v = _walk(step, (ro, rd), (ptr, *_start(ro)), lambda s: walking(s[0]))
    return Hit(tri >= 0, t, tri, u, v)


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


def bvh_intersect_diff(nodes, tri_pos, ro, rd) -> Hit:
    """Differentiable BVH intersection: detached traversal + `replay_hit`."""
    h = bvh_intersect(nodes.detach(), tri_pos.detach(), ro.detach(), rd.detach())
    return replay_hit(tri_pos, ro, rd, h)


def bvh_intersect_stack(bvh, triangles, ro, rd) -> Hit:
    """Stack-based BVH traversal, the literal analogue of the reference's
    traversal including its 64-deep overflow early exit; the semantic
    cross-check for `bvh_intersect`.

    bvh: scene.types.FlatBVH; triangles: scene.types.Triangles; ro, rd:
    (R, 3).  Returns Hit with `tri` in the original (Triangles) order."""
    r, n_nodes = ro.shape[0], bvh.left.shape[0]
    if n_nodes == 0:  # empty-scene early out (raytrace.wgsl:205-211)
        return miss_hit(r, ro.device)
    n_tri = triangles.p0.shape[0]
    slots = torch.arange(MAX_STACK_SIZE, device=ro.device)[None, :]

    def step(rays, state):
        ro, rd = rays
        stack, sp, best_t, best_tri, best_u, best_v = state
        # Overflow rule: a ray whose stack reached MAX_STACK_SIZE terminates
        # with its best-so-far hit (raytrace.wgsl:167-171).
        sp = torch.where(sp >= MAX_STACK_SIZE, 0, sp)
        active = sp > 0
        top = (sp - 1).clamp(0, MAX_STACK_SIZE - 1)
        node = torch.gather(stack, 1, top[:, None].long())[:, 0]
        node = torch.where(active, node, 0)
        sp = torch.where(active, sp - 1, sp)
        leaf = bvh.is_leaf[node] == 1

        # leaf path: test the one triangle
        tri_idx = bvh.tri[node]
        tri_safe = tri_idx.clamp(0, n_tri - 1)
        valid, t, u, v = ray_triangle(ro, rd, triangles.p0[tri_safe], triangles.p1[tri_safe],
                                      triangles.p2[tri_safe])
        take = active & leaf & valid & (t < best_t)
        best_t = torch.where(take, t, best_t)
        best_tri = torch.where(take, tri_idx, best_tri)
        best_u = torch.where(take, u, best_u)
        best_v = torch.where(take, v, best_v)

        # internal path: slab-test the children, push the hit ones
        internal = active & ~leaf
        left, right = bvh.left[node], bvh.right[node]
        lsafe, rsafe = left.clamp(0, n_nodes - 1), right.clamp(0, n_nodes - 1)
        push_l = internal & (left >= 0) & ray_aabb(ro, rd, bvh.node_min[lsafe],
                                                   bvh.node_max[lsafe])
        push_r = internal & (right >= 0) & ray_aabb(ro, rd, bvh.node_min[rsafe],
                                                    bvh.node_max[rsafe])
        slot_l = sp.clamp(0, MAX_STACK_SIZE - 1)
        stack = torch.where((slots == slot_l[:, None]) & push_l[:, None], left[:, None], stack)
        sp = sp + push_l.to(torch.int32)
        slot_r = sp.clamp(0, MAX_STACK_SIZE - 1)
        stack = torch.where((slots == slot_r[:, None]) & push_r[:, None], right[:, None], stack)
        sp = sp + push_r.to(torch.int32)
        return stack, sp, best_t, best_tri, best_u, best_v

    root_hit = ray_aabb(ro, rd, bvh.node_min[0], bvh.node_max[0])
    stack = torch.zeros((r, MAX_STACK_SIZE), dtype=torch.int32, device=ro.device)
    sp = root_hit.to(torch.int32)
    _, _, t, tri, u, v = _walk(step, (ro, rd), (stack, sp, *_start(ro)), lambda s: s[1] > 0)
    return Hit(tri >= 0, t, tri, u, v)


def brute_force_intersect(triangles, ro, rd, num_valid=None) -> Hit:
    """All-pairs reference intersector: every ray against every triangle,
    in index order.  The nearest t wins with a strict `<`, so equal-t ties
    keep the lowest triangle index.  `num_valid` is accepted for the JAX
    signature and, as there, unused."""
    best_t, best_tri, best_u, best_v = _start(ro)
    for i in range(triangles.p0.shape[0]):
        valid, t, u, v = ray_triangle(ro, rd, triangles.p0[i], triangles.p1[i], triangles.p2[i])
        take = valid & (t < best_t)
        best_t = torch.where(take, t, best_t)
        best_tri = torch.where(take, i, best_tri)
        best_u = torch.where(take, u, best_u)
        best_v = torch.where(take, v, best_v)
    return Hit(best_tri >= 0, best_t, best_tri, best_u, best_v)


def _map_ray_batches(fn, ro, rd, batch: int) -> Hit:
    """Run `fn(ro, rd) -> Hit` over consecutive `batch`-ray slices of the
    ray axis, one after another, and join the hits; one call over all rays
    when `batch` is 0, covers them, or does not divide them."""
    r = ro.shape[0]
    if batch <= 0 or r <= batch or r % batch:
        return fn(ro, rd)
    hits = [fn(ro[i:i + batch], rd[i:i + batch]) for i in range(0, r, batch)]
    return Hit(*(torch.cat(x) for x in zip(*hits)))


def bvh_fat_intersect(fat_nodes, ro, rd, *, max_leaf: int = 8, ray_batch: int = 16384) -> Hit:
    """The fat-leaf skip-link traversal ('bvh8') in `ray_batch`-ray slices
    (`_map_ray_batches`; 0 walks all rays at once).  Every ray's result is
    the same either way: the slices only bound how many lanes step
    together."""
    if ray_batch:
        fn = lambda a, b: _bvh_fat_intersect_impl(fat_nodes, a, b, max_leaf=max_leaf)
        return _map_ray_batches(fn, ro, rd, ray_batch)
    return _bvh_fat_intersect_impl(fat_nodes, ro, rd, max_leaf=max_leaf)


def _bvh_fat_intersect_impl(fat_nodes, ro, rd, *, max_leaf: int = 8) -> Hit:
    """Skip-link traversal over the fat-leaf BVH (accel.bvh.links_to_fat).

    Each visited node costs one row gather (box, links and up to `max_leaf`
    inlined triangles).  The triangle tests of a leaf are elementwise over
    the leaf axis.  Nearest hit wins; within a leaf the lowest row takes
    exact-t ties; across nodes the first-visited node wins.  `Hit.tri`
    indexes the packed (DFS leaf order) triangle rows."""
    r, k = ro.shape[0], fat_nodes.shape[0]
    if k == 0:  # empty-scene early out (raytrace.wgsl:205-211)
        return miss_hit(r, ro.device)
    links = _link_columns(fat_nodes, 6, 3)  # [miss, tri_start, count]
    slots = torch.arange(max_leaf, device=ro.device)[None, :]

    def step(rays, state):
        ro, rd = rays
        ptr, best_t, best_tri, best_u, best_v = state
        active = ptr < k
        p = torch.where(active, ptr, 0)
        row = torch.index_select(fat_nodes, 0, p)
        box_hit, box_tmin = ray_aabb_t(ro, rd, row[:, 0:3], row[:, 3:6])
        box_hit = box_hit & active & (box_tmin < best_t)
        ln = torch.index_select(links, 0, p)
        miss, tstart, count = ln[:, 0], ln[:, 1], ln[:, 2]
        is_leaf = count > 0

        tp = row[:, 9:].reshape(-1, max_leaf, 9)
        valid, t, u, v = ray_triangle(ro[:, None, :], rd[:, None, :],
                                      tp[..., 0:3], tp[..., 3:6], tp[..., 6:9])
        usable = valid & (slots < count[:, None]) & (box_hit & is_leaf)[:, None]
        t = torch.where(usable, t, float(INF))
        j = torch.argmin(t, dim=1, keepdim=True)
        t_j = torch.gather(t, 1, j)[:, 0]
        take = t_j < best_t
        best_t = torch.where(take, t_j, best_t)
        best_tri = torch.where(take, tstart + j[:, 0].to(torch.int32), best_tri)
        best_u = torch.where(take, torch.gather(u, 1, j)[:, 0], best_u)
        best_v = torch.where(take, torch.gather(v, 1, j)[:, 0], best_v)

        nxt = torch.where(box_hit & ~is_leaf, p + 1, miss)
        return torch.where(active, nxt, ptr), best_t, best_tri, best_u, best_v

    ptr = torch.zeros((r,), dtype=torch.int32, device=ro.device)
    _, t, tri, u, v = _walk(step, (ro, rd), (ptr, *_start(ro)), lambda s: s[0] < k)
    return Hit(tri >= 0, t, tri, u, v)
