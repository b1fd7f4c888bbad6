"""Wavefront path tracing: per-bounce ray sorting and chunked traversal.

The port of `tpu_pathtracer.ops.wavefront`.  Each bounce is broken into
stages:

  1. *sort*: order rays by a coherence key (`_coherence_key`): rays that
     are no longer active sink to the tail, live rays group by direction
     octant, then by a cell of an 8^3 grid over the root node's box;
  2. *intersect*: the skip-link BVH walk in fixed-size chunks of `chunk`
     rays (`_chunked_intersect`).  A chunk walks while any of its lanes
     is live, so its cost is its worst lane's, as in the JAX package's
     `lax.map` of one `while_loop` per chunk;
  3. *shade*: `trace.bounce_shade`, the plain loop's bounce, so every
     ray's radiance and RNG stream are the plain loop's: sorting only
     permutes lanes, and the order is undone on return.

The JAX package maps over the chunks one after another.  Here every chunk
walks in one batch on `intersect._walk`, which every few steps writes out
the chunks whose lanes have all finished and drops them whole, so the
launches per step do not grow with the number of chunks.  A finished lane
is an identity of the step, so no lane's result depends on the grouping:
the frame equals `render_frame(..., intersector="bvh")` bit for bit.

The path runs no CUDA kernel: it is torch ops on any device, as the
`bvh` intersector is.
"""

from __future__ import annotations

import numpy as np
import torch

from . import camera as camera_ops
from . import envsample
from .intersect import skip_link_walk
from .mt_matmul import Hit, miss_hit
from .trace import accumulate, band_pixels, bounce_shade, pack_shade_material_rows  # noqa: F401

__all__ = ["accumulate", "render_frame_wavefront", "trace_rays_wavefront"]

_KEY_INACTIVE = 0xFFFFFFFF  # the JAX package's uint32 key of a lane that is not active


def _coherence_key(ro, rd, active, scene_min, scene_max, cells: int = 8):
    """Sort key (R,) int64 holding the JAX package's uint32 key: lanes that
    are not active last, active lanes by direction octant, then by origin
    cell of a `cells`^3 grid over [scene_min, scene_max]."""
    octant = ((rd[:, 0] >= 0).to(torch.int64) + 2 * (rd[:, 1] >= 0).to(torch.int64)
              + 4 * (rd[:, 2] >= 0).to(torch.int64))
    extent = torch.clamp(scene_max - scene_min, min=1e-6)
    cell_f = (ro - scene_min) / extent * float(cells)
    cell = torch.clamp(cell_f.to(torch.int32), 0, cells - 1).to(torch.int64)
    cell_id = (cell[:, 0] * cells + cell[:, 1]) * cells + cell[:, 2]
    key = octant * cells**3 + cell_id
    return torch.where(active, key, _KEY_INACTIVE)


def _masked_intersect(nodes, tri_pos, ro, rd, active, chunk: int | None = None) -> Hit:
    """`bvh_intersect` with the lanes that are not active starting at the
    end sentinel K.  With `chunk`, the lanes walk in groups of `chunk`
    consecutive lanes (R a multiple of it), each group while any of its
    lanes is live."""
    r, k = ro.shape[0], nodes.shape[0]
    if k == 0:
        return miss_hit(r, ro.device)
    ptr = torch.where(active, 0, k).to(torch.int32)
    walking = None
    if chunk is not None:
        walking = lambda p: (p < k).view(-1, chunk).any(dim=1).repeat_interleave(chunk)
    return skip_link_walk(nodes, tri_pos, ro, rd, ptr, walking)


def _chunked_intersect(nodes, tri_pos, ro, rd, active, chunk: int) -> Hit:
    """BVH-intersect in independent chunks of `chunk` rays (R a multiple
    of it): the JAX package's `lax.map` over chunks, as one batched walk
    that drops each chunk once all its lanes have finished."""
    if ro.shape[0] % chunk:
        raise ValueError(f"{ro.shape[0]} rays are not a multiple of chunk={chunk}")
    return _masked_intersect(nodes, tri_pos, ro, rd, active, chunk)


def trace_rays_wavefront(scene, params, ro, rd, seed, *, max_bounces: int, chunk: int = 2048,
                         sort_rays: bool = True, env_importance: bool = False):
    """Wavefront trace of rays (R, 3) with seeds (R,) int64: per bounce a
    sort, the chunked intersect and the shade.  Returns (incoming (R, 3)
    f32, seed (R,) int64) in the input ray order, equal to `trace_rays`'
    with the 'bvh' intersector."""
    device = ro.device
    r = ro.shape[0]
    pad = (-r) % chunk
    if pad:
        # inactive padding lanes: they start finished in the chunked walk
        ro = torch.cat([ro, torch.zeros((pad, 3), dtype=torch.float32, device=device)])
        rd = torch.cat([rd, torch.tensor([0.0, 0.0, 1.0], device=device).expand(pad, 3)])
        seed = torch.cat([seed, torch.zeros((pad,), dtype=seed.dtype, device=device)])
    rp = r + pad

    nodes = scene.packed.nodes.detach()
    tri_pos = scene.packed.tri_pos.detach()
    scene_min, scene_max = nodes[0, 0:3], nodes[0, 3:6]
    shade_mat = pack_shade_material_rows(scene)
    env_patches = envsample.pack_env_patches(scene.env.radiance)

    incoming = torch.zeros((rp, 3), dtype=torch.float32, device=device)
    color = torch.ones((rp, 3), dtype=torch.float32, device=device)
    active = torch.arange(rp, device=device) < r
    lane = torch.arange(rp, device=device)  # lane[i]: the ray now in slot i
    for _ in range(max_bounces):
        if not bool(active.any()):
            break  # every later bounce is an identity
        if sort_rays:
            order = torch.argsort(_coherence_key(ro, rd, active, scene_min, scene_max),
                                  stable=True)
            ro, rd, incoming, color, seed, active, lane = (
                x[order] for x in (ro, rd, incoming, color, seed, active, lane))
        hit = _chunked_intersect(nodes, tri_pos, ro, rd, active, chunk)
        ro, rd, incoming, color, seed, active = bounce_shade(
            scene, params, hit, (ro, rd, incoming, color, seed, active),
            shade_mat=shade_mat, env_patches=env_patches, env_importance=env_importance)

    # undo the permutation, dropping the padding lanes
    inv = torch.empty_like(lane)
    inv[lane] = torch.arange(rp, device=device)
    inv = inv[:r]
    return incoming[inv], seed[inv]


def render_frame_wavefront(scene, params, *, width: int, height: int, aspect: float,
                           samples_per_frame: int = 1, max_bounces: int = 4,
                           chunk: int = 2048, sort_rays: bool = True,
                           env_importance: bool = False):
    """`render_frame` on the wavefront trace: (H, W, 3) f32 on the scene's
    device, row 0 the bottom of the frustum, the same per-pixel RNG
    streams as the plain loop (a row-major pixel grid).  `params` is moved
    to the scene's device first."""
    device = scene.packed.tri_pos.device
    params = params.to(device)
    _, _, uv, seed = band_pixels(width, height, params.frame, device=device)
    base_o, base_d = camera_ops.camera_rays(params.camera, uv, aspect)
    resolution = torch.tensor([width, height], dtype=torch.float32, device=device)
    acc = torch.zeros((height * width, 3), dtype=torch.float32, device=device)
    for _ in range(samples_per_frame):
        seed, o, d = camera_ops.apply_dof(seed, base_o, base_d, params.camera, resolution)
        light, seed = trace_rays_wavefront(scene, params, o, d, seed, max_bounces=max_bounces,
                                           chunk=chunk, sort_rays=sort_rays,
                                           env_importance=env_importance)
        acc = acc + light
    return (acc / float(np.float32(samples_per_frame))).reshape(height, width, 3)
