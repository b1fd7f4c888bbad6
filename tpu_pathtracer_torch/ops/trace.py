"""The path-trace loops and whole-frame rendering.

The port of `tpu_pathtracer.ops.trace`: the fused branch of `render_frame`
(-> `trace_rays_fused`), which the MT kernel intersectors take when the
frame is not differentiable, and the plain loop (`trace_rays`), which every
other frame takes: differentiable ones, and those through the all-pairs MT
oracle ('mt') or a BVH walk ('bvh', 'bvh8').  Per-ray math and RNG streams
follow the reference's single compute kernel (reference:
src/passes/shaders/raytrace.wgsl:373-478):

  * per bounce: intersection (the MT kernels: whole-scene up to 8,192
    padded triangles, cull 'nf', 'list' or 'cond', streamed up to 262,144;
    or the torch-op intersectors of ops/mt_matmul.py and ops/intersect.py) ->
    shading (cosine-hemisphere diffuse or mirror specular chosen with
    probability metalness, blended by roughness without renormalising;
    throughput *= mix(color, specular_color, is_specular); emission added
    on hits);
  * fused loop: vector state is component-major, (3, R); after each of the
    first `sort_bounces` bounces the ray state is re-binned by a coherence
    key (nearest live treelet, live count, direction bin), so rays sharing a
    kernel tile share work, by one global sort or by independent sorts of
    consecutive windows (`_sort_window`, `_windowed_sort`); the environment
    term of rays that missed is added once after the loop (a miss is always
    a ray's last event, and its carried seed is the miss-time seed, so the
    importance sampler's draws replay the plain loop's exactly), and the
    caller's ray order is restored by scattering on the carried pixel index;
  * plain loop: row-major state, the environment looked up per bounce
    (`bounce_shade`), by the ray's direction or, with `env_importance`, by
    CDF importance sampling with the pdf correction (two uniforms on a
    miss).  With `differentiable=True` the intersector picks the
    triangles on detached inputs and `replay_hit` recomputes (t, u, v) for
    them, so torch autograd differentiates the frame with respect to
    materials, environment radiance, camera and vertex positions.

Terminated rays are parked at ro = 1e30, rd = 0 before intersection, which
the kernels treat as lanes that never hit.  Both loops leave early once no
ray is active (a host check per bounce): the loop body is an identity then.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from . import camera as camera_ops
from . import envsample, rng
from .intersect import bvh_fat_intersect, bvh_intersect, replay_hit
from .kernels.mt_shade import (
    CHUNK_TRIS,
    MT_SHADE_MAX_TRIS,
    MT_STREAM2_MAX_TRIS,
    _pad_to,
    _slab_entries,
    _slab_setup,
    mt_intersect_pallas2_phi,
    mt_intersect_pallas2_phi_plain,
    treelet_boxes,
)
from .kernels.mt_stream import mt_intersect_stream2_phi, mt_intersect_stream2_phi_plain
from .mt_matmul import mt_intersect, ray_features
from .vecmath import INF, mix, normalize, reflect

_SORT_BOUNCES = 2  # default count of leading bounces that re-bin the ray state
_SORT_WINDOW = 32768  # default window of the binning sort, the JAX package's
_DIR_BINS = 96  # 6 dominant-axis half-spaces x 4x4 quantized minor axes
_KEY_SENTINEL = 2**31 - 1  # coherence key of inactive rays: sorts last


def resolve_intersector(intersector: str, n_tris: int) -> str:
    """Resolve 'auto' as the JAX package does on an accelerator, on every
    device (on the CPU the kernels run their plain versions): the
    near-to-far MT kernel ('mt_pallas') up to 8,192 padded triangles, the
    streamed MT kernel ('mt_stream') up to 262,144, and the fat-leaf BVH
    walk ('bvh8') above.  'mt' (the all-pairs MT oracle) and 'bvh' (the
    one-triangle-leaf skip-link walk) are explicit choices only.  An
    explicit name is returned as it is: an MT kernel's wrapper rejects a
    scene too large for it."""
    if intersector == "auto":
        if n_tris <= MT_SHADE_MAX_TRIS:
            return "mt_pallas"
        if n_tris <= MT_STREAM2_MAX_TRIS:
            return "mt_stream"
        return "bvh8"
    if intersector not in ("mt", "mt_pallas", "mt_stream", "bvh", "bvh8"):
        raise ValueError(f"unknown intersector {intersector!r}")
    return intersector


def _sort_bounces(override=None) -> int:
    """How many leading bounces of the fused loop re-bin the ray state:
    `override`, then TPT_SORT_BOUNCES, then 2."""
    if override is not None:
        return int(override)
    return int(os.environ.get("TPT_SORT_BOUNCES", str(_SORT_BOUNCES)))


def _sort_window(override=None) -> int:
    """Window of the per-bounce binning sort: `override`
    (RenderConfig.sort_window), then TPT_SORT_WINDOW, then 32768, as the
    JAX package resolves it (`tpu_pathtracer/ops/trace.py:366-387`).  0 is
    one global sort.  The image does not depend on the window: per-ray math
    is order-free and the final scatter keys on the unique pixel index."""
    if override is not None:
        return int(override)
    return int(os.environ.get("TPT_SORT_WINDOW", str(_SORT_WINDOW)))


def _windowed_sort(key, window: int):
    """The permutation that sorts int64 `key` (R,) within each consecutive
    `window`-ray window (an unstable sort along dim 1 of an (R/W, W) view,
    indices offset to their window), so no ray leaves its window.  One
    global sort where the JAX package takes one: W <= 0, R not a multiple
    of W, or fewer than 8 windows."""
    r = key.shape[0]
    if window <= 0 or r % window or r // window < 8:
        return torch.sort(key).indices
    idx = torch.sort(key.view(r // window, window), dim=1).indices
    return (idx + torch.arange(0, r, window, device=key.device)[:, None]).reshape(r)


def _intersector_phi(kind: str, plain: bool):
    """The MT wrapper for a resolved intersector: (tri_pos, phi_t (10, R),
    tile_rays=...) -> Hit."""
    if kind == "mt_stream":
        return mt_intersect_stream2_phi_plain if plain else mt_intersect_stream2_phi
    return mt_intersect_pallas2_phi_plain if plain else mt_intersect_pallas2_phi


def pack_material_rows(materials):
    """Material SoA -> (M, 12) rows [color(3), specular_color(3),
    emission_color(3), roughness, metalness, emission_strength]."""
    return torch.cat(
        [
            materials.color,
            materials.specular_color,
            materials.emission_color,
            materials.roughness[:, None],
            materials.metalness[:, None],
            materials.emission_strength[:, None],
        ],
        dim=1,
    )


def pack_shade_material_rows(scene):
    """Per-triangle shading row joined with its material row: (N, 21) =
    [n0(3), n1(3), n2(3), material row(12)], one gather per bounce."""
    mat_rows = pack_material_rows(scene.materials)
    mat_idx = scene.packed.tri_shade[:, 9].contiguous().view(torch.int32)
    tri_mat = mat_rows[mat_idx.clamp(0, mat_rows.shape[0] - 1).long()]
    return torch.cat([scene.packed.tri_shade[:, 0:9], tri_mat], dim=1)


# --- component-major helpers: (3, R) / (C, R) state ---------------------


def _normalize_t(v):
    return v / torch.sqrt(torch.sum(v * v, dim=0, keepdim=True))


def _reflect_t(d, n):
    dn = torch.sum(d * n, dim=0)
    return d - 2.0 * dn[None, :] * n


def _rand_direction_t(seed):
    seed, x = rng.rand_normal(seed)
    seed, y = rng.rand_normal(seed)
    seed, z = rng.rand_normal(seed)
    return seed, _normalize_t(torch.stack([x, y, z], dim=0))


def _rand_cosine_hemisphere_t(seed, normal):
    seed, d = _rand_direction_t(seed)
    return seed, _normalize_t(normal + d)


def _ray_features_t(ro, rd):
    """phi(ray) component-major: (3, R), (3, R) -> (10, R) = [1, ro, rd, ro x rd]."""
    cx = ro[1] * rd[2] - ro[2] * rd[1]
    cy = ro[2] * rd[0] - ro[0] * rd[2]
    cz = ro[0] * rd[1] - ro[1] * rd[0]
    return torch.cat([torch.ones_like(ro[:1]), ro, rd, torch.stack([cx, cy, cz])], dim=0)


def _gather_rows_t(table, idx):
    """Row gather with transposed output: table (N, C), idx (R,) in [0, N)
    -> (C, R).  Callers clip first: on CUDA an out-of-range index is a
    device assert."""
    return torch.index_select(table, 0, idx).T


def bounce_shade_t(scene, params, hit, carry, *, shade_mat):
    """One bounce given a Hit, component-major, env lookup deferred.
    carry = (ro, rd, incoming, color (3, R) f32, seed (R,) i64, active (R,) bool)."""
    ro, rd, incoming, color, seed, active = carry
    hit_mask = active & hit.hit

    tri_safe = hit.tri.clamp(0, scene.triangles.p0.shape[0] - 1).long()
    shade = _gather_rows_t(shade_mat, tri_safe)  # (21, R)
    roughness = shade[18]
    metalness = shade[19]
    w = 1.0 - hit.u - hit.v
    normal = _normalize_t(
        shade[0:3] * w[None, :] + shade[3:6] * hit.u[None, :] + shade[6:9] * hit.v[None, :]
    )
    position = ro + hit.t[None, :] * rd

    # RNG: hit rays consume 7 uniforms; missed/inactive rays must not advance.
    seed_h, diffuse_dir = _rand_cosine_hemisphere_t(seed, normal)
    seed_h, r_spec = rng.rand(seed_h)
    is_specular = (metalness >= r_spec).to(torch.float32)
    specular_dir = _reflect_t(rd, normal)
    blend = (is_specular * (1.0 - roughness))[None, :]
    new_dir = mix(diffuse_dir, specular_dir, blend)  # deliberately unnormalized

    emitted = shade[15:18] * shade[20][None, :]
    hm = hit_mask[None, :]
    incoming = incoming + torch.where(hm, emitted * color, 0.0)
    color = torch.where(hm, color * mix(shade[9:12], shade[12:15], is_specular[None, :]), color)
    ro = torch.where(hm, position, ro)
    rd = torch.where(hm, new_dir, rd)
    seed = torch.where(hit_mask, seed_h, seed)
    return ro, rd, incoming, color, seed, hit_mask


def _env_importance_term(scene, params, seed, env_patches):
    """CDF importance sampling of the environment with the pdf correction
    (raytrace.wgsl:315-349, 398-404): (seed after the two uniform draws,
    radiance * intensity / pdf (R, 3)), in the JAX package's order."""
    seed, uv = envsample.env_importance_sample(scene.env, seed)
    pdf = envsample.env_pdf(scene.env, uv)
    radiance = envsample.env_radiance_packed(env_patches, (scene.env.height, scene.env.width), uv)
    return seed, radiance * params.env_intensity / pdf[:, None]


def bounce_shade(scene, params, hit, carry, *, shade_mat, env_patches,
                 env_importance: bool = False):
    """One bounce of the plain loop given a Hit, row-major, with the
    environment looked up on misses (the JAX `bounce_shade` with
    `defer_env=False`): by the ray's direction, or with `env_importance`
    by CDF importance sampling with the pdf correction, which draws two
    uniforms on a miss (raytrace.wgsl:398-404).  carry = (ro, rd,
    incoming, color (R, 3) f32, seed (R,) i64, active (R,) bool)."""
    ro, rd, incoming, color, seed, active = carry
    hit_mask = active & hit.hit

    tri_safe = hit.tri.clamp(0, scene.triangles.p0.shape[0] - 1).long()
    shade = torch.index_select(shade_mat, 0, tri_safe)  # (R, 21)
    w = 1.0 - hit.u - hit.v
    normal = normalize(
        shade[:, 0:3] * w[:, None] + shade[:, 3:6] * hit.u[:, None] + shade[:, 6:9] * hit.v[:, None]
    )
    position = ro + hit.t[:, None] * rd

    # RNG: hit rays consume 7 uniforms; missed/inactive rays must not advance.
    seed_h, diffuse_dir = rng.rand_cosine_hemisphere(seed, normal)
    seed_h, r_spec = rng.rand(seed_h)
    is_specular = (shade[:, 19] >= r_spec).to(torch.float32)
    specular_dir = reflect(rd, normal)
    blend = (is_specular * (1.0 - shade[:, 18]))[:, None]
    new_dir = mix(diffuse_dir, specular_dir, blend)  # deliberately unnormalized

    emitted = shade[:, 15:18] * shade[:, 20][:, None]
    hm = hit_mask[:, None]
    incoming = incoming + torch.where(hm, emitted * color, 0.0)
    miss_mask = active & ~hit.hit
    if env_importance:
        seed_m, env_contrib = _env_importance_term(scene, params, seed, env_patches)
        seed = torch.where(miss_mask, seed_m, seed)
    else:
        env_uv = envsample.env_uv_from_ray(rd, params.env_rotation)
        env_contrib = envsample.env_radiance_packed(
            env_patches, (scene.env.height, scene.env.width), env_uv) * params.env_intensity
    incoming = incoming + torch.where(miss_mask[:, None], env_contrib * color, 0.0)

    color = torch.where(hm, color * mix(shade[:, 9:12], shade[:, 12:15], is_specular[:, None]),
                        color)
    ro = torch.where(hm, position, ro)
    rd = torch.where(hm, new_dir, rd)
    seed = torch.where(hit_mask, seed_h, seed)
    return ro, rd, incoming, color, seed, hit_mask


def trace_rays(scene, params, ro, rd, seed, *, max_bounces: int, env_importance: bool = False,
               differentiable: bool = False, intersector: str = "auto", plain: bool = False):
    """Trace rays (R, 3) with seeds (R,) int64 to completion through the
    plain loop; returns (incoming (R, 3) f32, seed (R,) int64).

    `intersector` is 'auto', 'mt_pallas' (through `mt_intersect_pallas2_phi`,
    so TPT_CULL, TPT_SUB and TPT_TILE_RAYS apply), 'mt_stream', 'mt' (the
    all-pairs MT oracle), 'bvh' (the skip-link walk over `packed.nodes`) or
    'bvh8' (the fat-leaf walk over `packed.fat_nodes`).  The intersectors
    always see detached inputs.  With `differentiable=True` the (t, u, v) of
    the chosen triangles are replayed by `replay_hit` on the live tensors,
    so autograd reaches ray origins, directions and vertex positions
    through them.  `plain=True` intersects through the MT kernels' plain
    versions (the other intersectors have no kernel).  `env_importance`
    samples the environment by its CDFs on a miss (`bounce_shade`)."""
    tri_pos = scene.packed.tri_pos
    kind = resolve_intersector(intersector, tri_pos.shape[0])
    tri_fixed = tri_pos.detach()
    if kind in ("mt_pallas", "mt_stream"):
        base = _intersector_phi(kind, plain)
        choose = lambda ro, rd: base(tri_fixed, ray_features(ro, rd).T.contiguous())
    elif kind == "mt":
        choose = lambda ro, rd: mt_intersect(tri_fixed, ro, rd)
    elif kind == "bvh":
        nodes = scene.packed.nodes.detach()
        choose = lambda ro, rd: bvh_intersect(nodes, tri_fixed, ro, rd)
    else:
        # One walk over all rays: it drops finished lanes as it goes, so the
        # JAX package's 16,384-ray batches, which bound its lockstep cost,
        # would only multiply the launches per step here.
        fat = scene.packed.fat_nodes.detach()
        choose = lambda ro, rd: bvh_fat_intersect(fat, ro, rd, ray_batch=0)

    def intersect(ro, rd):
        h = choose(ro.detach(), rd.detach())
        return replay_hit(tri_pos, ro, rd, h) if differentiable else h

    shade_mat = pack_shade_material_rows(scene)
    env_patches = envsample.pack_env_patches(scene.env.radiance)
    r = ro.shape[0]
    incoming = torch.zeros((r, 3), dtype=torch.float32, device=ro.device)
    color = torch.ones((r, 3), dtype=torch.float32, device=ro.device)
    active = torch.ones((r,), dtype=torch.bool, device=ro.device)
    for _ in range(max_bounces):
        if not bool(active.any()):
            break
        am = active[:, None]
        hit = intersect(torch.where(am, ro, 1e30), torch.where(am, rd, 0.0))
        ro, rd, incoming, color, seed, active = bounce_shade(
            scene, params, hit, (ro, rd, incoming, color, seed, active),
            shade_mat=shade_mat, env_patches=env_patches, env_importance=env_importance)
    return incoming, seed


def _direction_bin(rd):
    """Quantize (3, R) directions into 96 bins: dominant axis + sign x a 4x4
    grid over the two minor-axis slopes."""
    ax, ay, az = torch.abs(rd[0]), torch.abs(rd[1]), torch.abs(rd[2])
    dom_y = (ay >= ax) & (ay >= az)
    dom_z = (az >= ax) & (az > ay) & ~dom_y
    dom_x = ~dom_y & ~dom_z
    d_dom = torch.where(dom_x, rd[0], torch.where(dom_y, rd[1], rd[2]))
    a_dom = torch.clamp(torch.abs(d_dom), min=1e-30)
    u1 = torch.where(dom_x, rd[1], torch.where(dom_y, rd[2], rd[0])) / a_dom
    u2 = torch.where(dom_x, rd[2], torch.where(dom_y, rd[0], rd[1])) / a_dom
    q1 = ((u1 + 1.0) * 2.0).to(torch.int64).clamp(0, 3)
    q2 = ((u2 + 1.0) * 2.0).to(torch.int64).clamp(0, 3)
    axis = torch.where(dom_x, 0, torch.where(dom_y, 1, 2))
    half = axis * 2 + (d_dom > 0).to(torch.int64)
    return half * 16 + q1 * 4 + q2


def _coherence_key(ro, rd, active, boxes):
    """Binning key for the bounce sort: (nearest live treelet, live-treelet
    count, direction bin); ro/rd (3, R), boxes (Mc, 8) -> int64 (R,), with
    a sentinel that sorts last for inactive rays."""
    entry = _slab_entries(boxes, ro, rd, *_slab_setup(ro, rd))  # (Mc, R)
    live = entry < float(INF)
    nlive = live.sum(dim=0)
    nearest = torch.argmin(entry, dim=0)
    mc = boxes.shape[0]
    nearest = torch.where(nlive > 0, nearest, mc)
    key = (nearest * (mc + 1) + nlive) * _DIR_BINS + _direction_bin(rd)
    return torch.where(active, key, _KEY_SENTINEL)


def _key_boxes(tri_pos):
    """Treelet boxes for the coherence key: 128-triangle chunks, coarsened
    so that there are at most 64 boxes."""
    n_tris = tri_pos.shape[0]
    granule = CHUNK_TRIS
    while n_tris > 64 * granule:
        granule *= 2
    return treelet_boxes(_pad_to(tri_pos, -(-n_tris // granule) * granule, 0), granule)


def trace_rays_fused(scene, params, ro, rd, seed, *, max_bounces: int,
                     intersector_phi_fn, shade_mat=None, env_patches=None,
                     sort_bounces=None, sort_window=None, env_importance: bool = False):
    """Trace rays (R, 3) with seeds (R,) int64 to completion through
    `intersector_phi_fn` ((10, R) ray features -> Hit).  Returns
    (incoming (R, 3) f32, seed (R,) int64) in the input ray order, equal
    to `trace_rays`' (seeds bit for bit) for any `sort_window`."""
    r = ro.shape[0]
    device = ro.device
    if shade_mat is None:
        shade_mat = pack_shade_material_rows(scene)
    if env_patches is None:
        env_patches = envsample.pack_env_patches(scene.env.radiance)
    key_boxes = _key_boxes(scene.packed.tri_pos)
    n_sort = min(_sort_bounces(sort_bounces), max_bounces)
    window = _sort_window(sort_window)

    pix = torch.arange(r, device=device)
    ro = ro.T.contiguous()
    rd = rd.T.contiguous()
    incoming = torch.zeros((3, r), dtype=torch.float32, device=device)
    color = torch.ones((3, r), dtype=torch.float32, device=device)
    active = torch.ones((r,), dtype=torch.bool, device=device)
    for bounce in range(max_bounces):
        if not bool(active.any()):
            break
        am = active[None, :]
        hit = intersector_phi_fn(_ray_features_t(
            torch.where(am, ro, 1e30), torch.where(am, rd, 0.0)))
        ro, rd, incoming, color, seed, active = bounce_shade_t(
            scene, params, hit, (ro, rd, incoming, color, seed, active), shade_mat=shade_mat)
        if bounce < n_sort:
            # Unstable sort: any ray order gives the same per-ray results,
            # and the final scatter keys on the unique pixel index.
            order = _windowed_sort(_coherence_key(ro, rd, active, key_boxes), window)
            ro, rd, incoming, color = (x[:, order] for x in (ro, rd, incoming, color))
            seed, active, pix = seed[order], active[order], pix[order]

    # Deferred environment term for the rays that ended on a miss; rays
    # still active after max_bounces get nothing (raytrace.wgsl:378-408).
    # rd, color and seed still hold their miss-time values (the updates are
    # hit-gated), so the importance sampler draws what the plain loop draws.
    missed = ~active
    if env_importance:
        seed_m, env_term = _env_importance_term(scene, params, seed, env_patches)
        env_term = env_term.T
        seed = torch.where(missed, seed_m, seed)
    else:
        env_uv = envsample.env_uv_from_ray(rd.T, params.env_rotation)
        env_term = envsample.env_radiance_packed(
            env_patches, (scene.env.height, scene.env.width), env_uv).T * params.env_intensity
    incoming = incoming + torch.where(missed[None, :], env_term * color, 0.0)

    out_incoming = torch.empty((r, 3), dtype=torch.float32, device=device)
    out_seed = torch.empty_like(seed)
    out_incoming[pix] = incoming.T
    out_seed[pix] = seed
    return out_incoming, out_seed


def _block_size(n: int) -> int:
    return next(b for b in (32, 16, 8, 4, 2, 1) if n % b == 0)


def blocked_pixel_grid(height: int, width: int, device="cpu"):
    """Pixel coordinates in screen-block order: consecutive rays form
    bh x bw screen blocks (largest power-of-two divisors <= 32), so a ray
    tile covers a compact region.  Returns flat (xs, ys) int64."""
    bh, bw = _block_size(height), _block_size(width)
    by = torch.arange(height // bh, device=device)[:, None, None, None]
    bx = torch.arange(width // bw, device=device)[None, :, None, None]
    iy = torch.arange(bh, device=device)[None, None, :, None]
    ix = torch.arange(bw, device=device)[None, None, None, :]
    shape = (height // bh, width // bw, bh, bw)
    ys = (by * bh + iy).expand(shape)
    xs = (bx * bw + ix).expand(shape)
    return xs.reshape(-1), ys.reshape(-1)


def unblock_image(flat, height: int, width: int):
    """(H*W, C) in blocked_pixel_grid order -> (H, W, C) row-major."""
    bh, bw = _block_size(height), _block_size(width)
    c = flat.shape[-1]
    img = flat.reshape(height // bh, width // bw, bh, bw, c)
    return img.permute(0, 2, 1, 3, 4).reshape(height, width, c)


_R2 = np.array([0.7548776662466927, 0.5698402909980532], np.float32)  # Roberts' R2 steps


def _r2_point(frame: int, samples_per_frame: int, s: int, device):
    """Point n = (frame - 1) * spp + s of the R2 sequence, (2,) f32, in the
    JAX package's float32 operations: frac(n * a) per axis."""
    n = (np.float32(frame) - np.float32(1.0)) * np.float32(samples_per_frame) + np.float32(s)
    return torch.from_numpy(np.mod(n * _R2, np.float32(1.0))).to(device)


def band_pixels(width: int, height: int, frame: int, *, row_offset: int = 0,
                full_height: int | None = None, seed_salt=None, blocked: bool = False,
                device="cpu"):
    """The pixels of rows [row_offset, row_offset + height) of a
    `full_height`-tall image, as `render_frame` lays them out: flat (xs, ys)
    int64 in global coordinates (screen-block order of the band when
    `blocked`, else row-major), their uvs (R, 2) f32 with uv.y = ys /
    full_height, and their seeds `pixel_seed(xs + ys * width, frame)` plus
    `seed_salt`, mod 2**32 (salt None or 0: the unsharded stream)."""
    if full_height is None:
        full_height = height
    if blocked:
        xs, ys = blocked_pixel_grid(height, width, device)
    else:
        ys, xs = torch.meshgrid(torch.arange(height, device=device),
                                torch.arange(width, device=device), indexing="ij")
        xs, ys = xs.reshape(-1), ys.reshape(-1)
    ys = ys + int(row_offset)
    uv = torch.stack([xs.to(torch.float32) / float(width),
                      ys.to(torch.float32) / float(full_height)], dim=-1)
    seed = rng.pixel_seed(xs + ys * width, frame)
    if seed_salt is not None:
        seed = (seed + (int(seed_salt) & 0xFFFFFFFF)) & 0xFFFFFFFF
    return xs, ys, uv, seed


def render_frame(scene, params, *, width: int, height: int, aspect: float,
                 samples_per_frame: int = 1, max_bounces: int = 4,
                 env_importance: bool = False, differentiable: bool = False,
                 intersector: str = "auto", blue_noise=None, row_offset: int = 0,
                 full_height: int | None = None, seed_salt=None, sort_bounces=None,
                 sort_window=None, tile_rays=None, plain: bool = False):
    """Render one progressive frame at (height, width): (H, W, 3) f32 on the
    scene's device.  Row 0 is the bottom of the camera frustum.

    The MT kernel intersectors ('mt_pallas', 'mt_stream', and 'auto' up to
    262,144 padded triangles) take the fused loop over rays in screen-block
    order.  `differentiable=True`, and the intersectors 'mt', 'bvh' and
    'bvh8' ('auto' above 262,144), take the plain loop (`trace_rays`) over a
    row-major pixel grid, as the JAX package does; a differentiable frame is
    differentiable by torch autograd.  `sort_bounces`, `sort_window` (see
    `_sort_window`) and `tile_rays` are options of the fused loop only.
    `env_importance` samples the environment by its CDFs on a miss.

    `blue_noise`: optional (Hb, Wb, 2) toroidal rank table
    (`utils.bluenoise.blue_noise_table`, numpy or tensor).  The AA jitter
    then takes point n = (frame - 1) * spp + s of the R2 sequence, the same
    for every pixel, offset per pixel by the table (Cranley–Patterson
    rotation) in place of the two hash draws, so the error across pixels is
    high-frequency; every other draw keeps the per-pixel PCG stream.

    Sharding hooks (`parallel.sharded`): the call renders rows
    [row_offset, row_offset + height) of a `full_height`-tall image, with
    seeds, uv.y, the AA resolution and the blue-noise lookup in global
    coordinates, so the bands of a row-sharded frame put together give the
    unsharded frame (`band_pixels`).  `seed_salt` (an integer) is added to
    every pixel seed mod 2**32 to decorrelate the sample axis's shards.

    `plain=True` intersects through the kernels' plain PyTorch versions on
    any device (a reference for the kernel path); the default launches the
    kernels for CUDA tensors and runs the plain versions for CPU tensors."""
    tri_pos = scene.packed.tri_pos
    kind = resolve_intersector(intersector, tri_pos.shape[0])
    fused = kind in ("mt_pallas", "mt_stream") and not differentiable
    device = tri_pos.device

    if full_height is None:
        full_height = height
    xs, ys, uv, seed = band_pixels(width, height, params.frame, row_offset=row_offset,
                                   full_height=full_height, seed_salt=seed_salt,
                                   blocked=fused, device=device)
    base_o, base_d = camera_ops.camera_rays(params.camera, uv, aspect)
    # AA jitter scales by the whole image's resolution, not the band's
    resolution = torch.tensor([width, full_height], dtype=torch.float32, device=device)
    if blue_noise is not None:
        bn = torch.as_tensor(blue_noise, dtype=torch.float32, device=device)
        bn_pix = bn[ys % bn.shape[0], xs % bn.shape[1]]  # per-pixel CP offsets (R, 2)

    if not fused:
        def trace(o, d, seed):
            return trace_rays(scene, params, o, d, seed, max_bounces=max_bounces,
                              env_importance=env_importance, differentiable=differentiable,
                              intersector=kind, plain=plain)
    else:
        intersect = _intersector_phi(kind, plain)
        shade_mat = pack_shade_material_rows(scene)
        env_patches = envsample.pack_env_patches(scene.env.radiance)

        def trace(o, d, seed):
            return trace_rays_fused(
                scene, params, o, d, seed, max_bounces=max_bounces,
                intersector_phi_fn=lambda phi: intersect(tri_pos, phi, tile_rays=tile_rays),
                shade_mat=shade_mat, env_patches=env_patches, sort_bounces=sort_bounces,
                sort_window=sort_window, env_importance=env_importance,
            )

    acc = torch.zeros((height * width, 3), dtype=torch.float32, device=device)
    for s in range(samples_per_frame):
        aa = None
        if blue_noise is not None:
            aa = torch.remainder(_r2_point(params.frame, samples_per_frame, s, device) + bn_pix,
                                 1.0)
        seed, o, d = camera_ops.apply_dof(seed, base_o, base_d, params.camera, resolution,
                                          aa_uniforms=aa)
        light, seed = trace(o, d, seed)
        acc = acc + light
    color = acc / float(np.float32(samples_per_frame))
    if not fused:
        return color.reshape(height, width, 3)
    return unblock_image(color, height, width)


def accumulate(prev, current, frame: int, enabled: bool = True, *, out=None):
    """Progressive running mean (reference: src/passes/shaders/accumulate.wgsl:21-28):
    prev + (current - prev) / frame, frame 1-based; passthrough when
    disabled.  `out=prev` updates the accumulation in place."""
    weight = np.float32(1.0)
    if enabled and frame > 0:
        weight = np.float32(1.0) / np.float32(frame)
    return torch.add(prev, (current - prev) * float(weight), out=out)
