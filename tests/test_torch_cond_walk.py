"""The Hopper 'cond' walk's decision order (csrc/cond_walk.cu), mirrored in
torch on the CPU, against the plain walk `mt_shade._walk_cond_plain`.

The kernel decides by mask: chunks are taken 16 at a time, a mask of the
group's live chunks (some ray enters the box before its current t) is
decided once, a live chunk's sub mask likewise, and both masks are formed
again after each evaluated sub; the walk takes the lowest set bit.  Each
decision is the OR over the cluster's CTAs, each CTA holding a slice of the
tile's rays.  `_mirror` walks in exactly that order, one tile at a time,
and must give the plain walk's hits and per-tile walk counts (chunks live,
subs evaluated) bit for bit; without the re-formation it evaluates blocks
the plain walk culls.  The CUDA walk itself is held to the plain walk on a
machine with a card (tests/test_torch_cuda.py, chip_smoke.py)."""

import math

import numpy as np
import pytest
import torch

import tpu_pathtracer_torch as tpt
from tpu_pathtracer_torch.ops import camera as camera_ops
from tpu_pathtracer_torch.ops import trace as ttrace
from tpu_pathtracer_torch.ops.kernels import mt_shade
from tpu_pathtracer_torch.ops.kernels.mt_intersect import treelet_boxes

CAM = dict(position=(0, 1, 4), look_at=(0, 0.5, 0), fov=45)
GROUP = 16  # chunks a decision covers
CLUSTER = 4  # CTAs a tile is split over (csrc/cond_walk.cu kCluster)


def _mirror(phi_pad, cols_rows, chunk_boxes, sub_boxes, tile_rays, reform=True):
    """The cond walk in the kernel's decision order; returns (hits (R_pad,)
    x4, walk counts (T, 2))."""
    n_tiles = phi_pad.shape[1] // tile_rays
    n_chunks, n_subs = chunk_boxes.shape[0], sub_boxes.shape[0]
    spc = n_subs // n_chunks
    phi, best = mt_shade._walk_start(phi_pad, n_tiles, tile_rays, park=False)
    coef = cols_rows.reshape(n_subs, 4, -1, 10)
    ro, rd = phi[:, 1:4], phi[:, 4:7]
    par, inv = mt_shade._slab_setup(ro, rd)
    t = best[0]
    stats = torch.zeros((n_tiles, 2), dtype=torch.int32)
    per_cta = math.ceil(tile_rays / CLUSTER)

    for tile in range(n_tiles):
        rays = tuple(x[tile:tile + 1] for x in (ro, rd, par, inv))

        def vote(lanes):  # (TR,) bool: the OR of the cluster's CTAs' ORs
            return any(bool(lanes[r0:r0 + per_cta].any()) for r0 in range(0, tile_rays, per_cta))

        def entries(boxes):  # (K, 8) -> (K, TR)
            return mt_shade._slab_entries(boxes[None], *rays)[0]

        def live(entry, bits):
            return {b for b in bits if vote(entry[b] < t[tile])}

        def evaluate(sub_id):
            stats[tile, 1] += 1
            mt_shade._fold_subs(phi, coef, torch.tensor([tile]), torch.tensor([sub_id]), best)

        if not vote(rd[tile].abs().sum(dim=0) > 0):  # the tile-alive gate
            continue
        for g in range(0, n_chunks, GROUP):
            centry = entries(chunk_boxes[g:g + GROUP])
            chunks = live(centry, range(centry.shape[0]))
            while chunks:
                k = min(chunks)
                chunks.discard(k)
                stats[tile, 0] += 1
                c = g + k
                if spc == 1:  # the chunk is the sub
                    evaluate(c)
                    chunks = live(centry, chunks) if reform else chunks
                    continue
                sentry = entries(sub_boxes[c * spc:(c + 1) * spc])
                subs = live(sentry, range(spc))
                while subs:
                    s = min(subs)
                    subs.discard(s)
                    evaluate(c * spc + s)
                    if reform:
                        subs, chunks = live(sentry, subs), live(centry, chunks)
    return tuple(x.reshape(-1) for x in best), stats


def _camera_phi(size):
    cam = tpt.Camera.create(**CAM)
    xs, ys = ttrace.blocked_pixel_grid(size, size)
    o, d = camera_ops.camera_rays(cam, torch.stack([xs / float(size), ys / float(size)], dim=-1),
                                  1.0)
    return ttrace._ray_features_t(o.T.contiguous(), d.T.contiguous())


def _inputs(kind):
    """(tri_pos, phi_t, tile width): camera rays on the default scene (16
    chunks: one group), or a soup of 4,200 triangles (33 chunks: two full
    groups and one of a single chunk) with parked rays; tile widths that a
    cluster of 4 splits unevenly."""
    if kind == "mesh":
        return tpt.default_scene().compile(device="cpu").packed.tri_pos, _camera_phi(24), 102
    rng = np.random.default_rng(7)
    v0 = rng.uniform(-1, 1, (4200, 3))
    e = rng.uniform(-0.1, 0.1, (4200, 2, 3))
    tri = np.concatenate([v0, v0 + e[:, 0], v0 + e[:, 1]], axis=1).astype(np.float32)
    ro = rng.uniform(-1.5, 1.5, (700, 3)).astype(np.float32)
    rd = rng.normal(size=(700, 3))
    rd = (rd / np.linalg.norm(rd, axis=1, keepdims=True)).astype(np.float32)
    rd[::9] = 0.0  # parked lanes
    phi = ttrace._ray_features_t(torch.from_numpy(ro).T.contiguous(),
                                 torch.from_numpy(rd).T.contiguous())
    return torch.from_numpy(tri), phi, 302


def _prepare(tri, phi, tile_rays, sub):
    """`_prepare_cond` at any tile width."""
    tri_padded, cols_rows = mt_shade._pad_scene(tri, sub)
    return (mt_shade._pad_rays(phi, tile_rays), cols_rows,
            treelet_boxes(tri_padded, mt_shade.CHUNK_TRIS), treelet_boxes(tri_padded, sub))


@pytest.mark.parametrize("sub", [8, 16, 32, 64, 128])
@pytest.mark.parametrize("kind", ["mesh", "soup"])
def test_torch_cond_walk_order_matches_plain(kind, sub):
    tri, phi, tile_rays = _inputs(kind)
    prep = _prepare(tri, phi, tile_rays, sub)
    sp = torch.zeros((prep[0].shape[1] // tile_rays, 2), dtype=torch.int32)
    hp = mt_shade._walk_cond_plain(*prep, tile_rays, stats=sp)
    hm, sm = _mirror(*prep, tile_rays)
    for a, b in zip(hm, hp):
        assert torch.equal(a, b)
    assert torch.equal(sm, sp)
    live, evaluated = (int(x) for x in sp.sum(dim=0))
    assert int((hp[1] >= 0).sum()) > 20 and evaluated > 0
    if kind == "mesh":  # both levels cull
        assert live < sp.shape[0] * prep[2].shape[0]
        if sub < mt_shade.CHUNK_TRIS:
            assert evaluated < live * (mt_shade.CHUNK_TRIS // sub)


def _stacked_planes():
    """Two 128-triangle chunks of squares [-1, 1]^2 facing the rays: chunk
    0 at z = 0 (its first 64 triangles) and z = 1, chunk 1 at z = 2; rays
    from z = -1 along +z.  Once the first sub is evaluated (t = 1), the
    second sub and the second chunk lie behind every ray's t."""
    def square(z, copies):
        a = [[-1, -1, z, 1, -1, z, 1, 1, z], [-1, -1, z, 1, 1, z, -1, 1, z]]
        return np.asarray(a * copies, np.float32)

    tri = np.concatenate([square(0.0, 32), square(1.0, 32), square(2.0, 64)])
    rng = np.random.default_rng(9)
    ro = np.concatenate([rng.uniform(-0.9, 0.9, (204, 2)), -np.ones((204, 1))], axis=1)
    rd = np.tile(np.float32([0.0, 0.0, 1.0]), (204, 1))
    phi = ttrace._ray_features_t(torch.from_numpy(ro.astype(np.float32)).T.contiguous(),
                                 torch.from_numpy(rd).T.contiguous())
    return torch.from_numpy(tri), phi, 102


def test_torch_cond_walk_order_needs_the_mask_reformation():
    """Without forming the masks again after an evaluated sub, the walk
    keeps blocks that the current t culls: the same hits, but the second
    sub is evaluated and the second chunk staged (the card test's mutation
    check, mirrored)."""
    tri, phi, tile_rays = _stacked_planes()
    prep = _prepare(tri, phi, tile_rays, 64)
    sp = torch.zeros((prep[0].shape[1] // tile_rays, 2), dtype=torch.int32)
    hp = mt_shade._walk_cond_plain(*prep, tile_rays, stats=sp)
    assert (sp == torch.tensor([1, 1], dtype=torch.int32)).all()  # one chunk, one sub a tile
    hm, sm = _mirror(*prep, tile_rays)
    assert torch.equal(sm, sp) and all(torch.equal(a, b) for a, b in zip(hm, hp))
    hm, sm = _mirror(*prep, tile_rays, reform=False)
    for a, b in zip(hm, hp):
        assert torch.equal(a, b)
    assert (sm == torch.tensor([2, 2], dtype=torch.int32)).all()
