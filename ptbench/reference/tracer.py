"""A plain PyTorch path tracer: the benchmark's reference for correctness.

It follows the reference renderer's compute kernel (webgpu-pathtracer,
src/passes/shaders/raytrace.wgsl:217-478) from its description, and shares
no code with the program it checks: it imports neither the program nor JAX,
and takes nothing the program made.  The benchmark hands it the same scene
arrays (world-space triangles, materials, environment radiance) and camera
that it hands the program; the reference works out everything else itself.

  * the u32 RNG stream (a PCG hash a draw, seed = pixel index + frame *
    719393 + 123456789) in int64 arithmetic masked to 32 bits, bit-exact;
  * pinhole rays with the reference's quirks (focal length equal to the
    aspect ratio, no half-pixel offset) and the AA / thin-lens jitter;
  * nearest-hit Moller-Trumbore in its textbook form over every triangle,
    culled by the boxes of 32-triangle clusters in Morton order (an
    exact cull: a box only drops triangles it does not contain);
  * diffuse (cosine hemisphere) or mirror bounce chosen with probability
    metalness, blended by roughness; the environment by its equirect uv,
    bilinear with clamp-to-edge, on a miss.

`dtype` sets the precision of every floating-point step of the arithmetic
(float32 for the reference; bfloat16 for the benchmark's control).  The
cull's boxes are tested in float32 on the values in `dtype`, widened a
little, so they never decide a result.

Paths are traced once into `Paths`: per bounce, which rays hit, the
material they hit, whether they bounced specularly, and the environment
radiance met on a miss.  `radiance` turns them into light for a given set
of material colours, so the light is a function of the colours that
autograd differentiates (inverse rendering), and the colours never steer
a path.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

SEED = 123456789
MASK = 0xFFFFFFFF
TWOPI = float(np.float32(6.28318530718))
INVPI = float(np.float32(0.31830988618))
INVTWOPI = float(np.float32(0.15915494309))
EPSILON = float(np.float32(1e-6))
U32_SCALE = float(np.float32(4294967295.0))  # the WGSL literal, which rounds to 2**32
CLUSTER = 32  # triangles a culling box
RAY_CHUNK = 8192  # rays a culling pass
PAIR_CHUNK = 1 << 17  # (ray, cluster) pairs a Moller-Trumbore pass


@dataclasses.dataclass
class Scene:
    """World-space triangles in cluster order, their materials, the
    environment radiance, all on one device."""

    p0: torch.Tensor  # (N, 3) dtype
    e1: torch.Tensor  # (N, 3) p1 - p0
    e2: torch.Tensor  # (N, 3) p2 - p0
    n0: torch.Tensor  # (N, 3) vertex normals
    n1: torch.Tensor
    n2: torch.Tensor
    material: torch.Tensor  # (N,) int64
    box_min: torch.Tensor  # (C, 3) float32
    box_max: torch.Tensor  # (C, 3) float32
    color: torch.Tensor  # (M, 3)
    specular: torch.Tensor  # (M, 3)
    emission: torch.Tensor  # (M, 3) emission colour * strength
    roughness: torch.Tensor  # (M,)
    metalness: torch.Tensor  # (M,)
    env: torch.Tensor  # (H, W, 3)
    dtype: torch.dtype


def _morton_order(centroids: np.ndarray) -> np.ndarray:
    lo, hi = centroids.min(axis=0), centroids.max(axis=0)
    q = ((centroids - lo) / np.maximum(hi - lo, 1e-12) * 1023).astype(np.int64)
    code = np.zeros(len(q), np.int64)
    for bit in range(10):
        for axis in range(3):
            code |= ((q[:, axis] >> bit) & 1) << (3 * bit + axis)
    return np.argsort(code, kind="stable")


def build_scene(triangles: dict, materials: dict, env: np.ndarray, *, device="cpu",
                dtype=torch.float32) -> Scene:
    """`triangles`: world-space p0, p1, p2, n0, n1, n2 (N, 3) float32 and
    material (N,) int; `materials`: color, specular_color, emission_color
    (M, 3), roughness, metalness, emission_strength (M,) float32; `env`:
    (H, W, 3) float32 radiance."""
    p0, p1, p2 = (np.asarray(triangles[k], np.float32) for k in ("p0", "p1", "p2"))
    n = p0.shape[0]
    order = _morton_order((p0.astype(np.float64) + p1 + p2) / 3.0)
    pad = -n % CLUSTER
    # padding triangles collapse onto a real vertex: they never hit and
    # leave their cluster's box as it is
    take = np.concatenate([order, np.full(pad, order[-1], np.int64)])
    rows = {k: np.asarray(triangles[k], np.float32)[take] for k in ("p0", "p1", "p2", "n0", "n1", "n2")}
    for k in ("p1", "p2"):
        rows[k][n:] = rows["p0"][n:]
    t = lambda a, dt=dtype: torch.as_tensor(np.ascontiguousarray(a)).to(device=device, dtype=dt)
    p0_t, p1_t, p2_t = t(rows["p0"]), t(rows["p1"]), t(rows["p2"])
    corners = torch.stack([p0_t, p1_t, p2_t], 1).float().reshape(-1, CLUSTER * 3, 3)
    box_min, box_max = corners.amin(1), corners.amax(1)
    widen = 1e-4 * (1.0 + torch.maximum(box_min.abs(), box_max.abs()))
    m = {k: np.asarray(v, np.float32) for k, v in materials.items()}
    return Scene(
        p0=p0_t, e1=p1_t - p0_t, e2=p2_t - p0_t, n0=t(rows["n0"]), n1=t(rows["n1"]),
        n2=t(rows["n2"]),
        material=torch.as_tensor(np.asarray(triangles["material"], np.int64)[take], device=device),
        box_min=box_min - widen, box_max=box_max + widen,
        color=t(m["color"]), specular=t(m["specular_color"]),
        emission=t(m["emission_color"] * m["emission_strength"][:, None]),
        roughness=t(m["roughness"]), metalness=t(m["metalness"]), env=t(env), dtype=dtype,
    )


# --- the RNG stream (raytrace.wgsl:253-287) --------------------------------


def rand(seed, dtype):
    seed = (seed * 747796405 + 2891336453) & MASK
    word = (((seed >> ((seed >> 28) + 4)) ^ seed) * 277803737) & MASK
    word = (word >> 22) ^ word
    return seed, (word.to(torch.float32) / U32_SCALE).to(dtype)


def rand_normal(seed, dtype):
    seed, r1 = rand(seed, dtype)
    seed, r2 = rand(seed, dtype)
    return seed, torch.sqrt(-2.0 * torch.log(r2)) * torch.cos(TWOPI * r1)


def _dot(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def _cross(a, b):
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], dim=-1)


def _normalize(v):
    return v / torch.sqrt(_dot(v, v))[..., None]


def rand_direction(seed, dtype):
    seed, x = rand_normal(seed, dtype)
    seed, y = rand_normal(seed, dtype)
    seed, z = rand_normal(seed, dtype)
    return seed, _normalize(torch.stack([x, y, z], dim=-1))


def rand_disk(seed, dtype):
    seed, r1 = rand(seed, dtype)
    seed, r2 = rand(seed, dtype)
    theta, rho = TWOPI * r1, torch.sqrt(r2)
    return seed, torch.stack([rho * torch.cos(theta), rho * torch.sin(theta)], dim=-1)


def pixel_seeds(index, frame: int):
    """seed = pixel index + frame * 719393 + SEED, mod 2**32 (raytrace.wgsl:435-436)."""
    return (index.to(torch.int64) + (int(frame) * 719393 + SEED)) & MASK


# --- camera (raytrace.wgsl:217-250, 444-449) -------------------------------


def camera_rays(camera: dict, uv, aspect: float, dtype):
    """Pinhole rays for uv (R, 2): (origin (R, 3), direction (R, 3)).
    `camera`: position, look_at (3 floats each), fov in degrees."""
    dev = uv.device
    pos = torch.tensor(np.asarray(camera["position"], np.float32), device=dev).to(dtype)
    look = torch.tensor(np.asarray(camera["look_at"], np.float32), device=dev).to(dtype)
    direction = _normalize(look - pos)
    t = torch.tan(torch.tensor(math.radians(float(camera["fov"])) / 2.0, device=dev).to(dtype))
    r = float(aspect) * t
    u = -r + 2.0 * r * uv[:, 0]
    v = -t + 2.0 * t * uv[:, 1]
    w = -direction
    up = torch.tensor([0.0, 1.0, 0.0], device=dev, dtype=dtype)
    if abs(float(w[1])) > 0.99999:
        up = torch.tensor([0.0, 0.0, 1.0], device=dev, dtype=dtype)
    u_dir = _normalize(_cross(up, w))
    v_dir = _cross(w, u_dir)
    d = _normalize(u_dir * u[:, None] + v_dir * v[:, None] - w * float(aspect))
    return pos.expand_as(d), d


def jitter_rays(seed, origin, direction, camera: dict, resolution, dtype):
    """The AA disk draw (over the resolution) and the thin-lens draw (over
    the aperture), both in world x and y."""
    seed, disk1 = rand_disk(seed, dtype)
    seed, disk2 = rand_disk(seed, dtype)
    zero = torch.zeros_like(disk1[:, :1])
    res = torch.tensor(resolution, dtype=torch.float32, device=origin.device).to(dtype)
    jitter = torch.cat([disk1 / res, zero], dim=-1)
    jitter2 = torch.cat([disk2 * float(camera.get("aperture", 0.0)), zero], dim=-1)
    focal = origin + direction * float(camera.get("focal_distance", 1.0)) + jitter
    new_origin = origin + jitter2
    return seed, new_origin, _normalize(focal - new_origin)


# --- intersection -------------------------------------------------------------


def _mt(o, d, p0, e1, e2):
    """Textbook Moller-Trumbore; broadcasting (..., 3) -> (ok, t, u, v)."""
    h = _cross(d, e2)
    a = _dot(e1, h)
    f = 1.0 / a
    s = o - p0
    u = f * _dot(s, h)
    q = _cross(s, e1)
    v = f * _dot(d, q)
    t = f * _dot(e2, q)
    ok = (a.abs() >= EPSILON) & (u >= 0) & (u <= 1) & (v >= 0) & (u + v <= 1) & (t > EPSILON)
    return ok, t, u, v


def intersect(scene: Scene, ro, rd):
    """Nearest hit of each ray: (hit (R,), t, tri (R,) int64, u, v); ties in
    t go to the lower cluster-order index."""
    n_rays = ro.shape[0]
    dev = ro.device
    best_t = torch.full((n_rays,), math.inf, device=dev)
    best_tri = torch.full((n_rays,), -1, dtype=torch.int64, device=dev)
    lanes = torch.arange(CLUSTER, device=dev)
    for r0 in range(0, n_rays, RAY_CHUNK):
        o, d = ro[r0:r0 + RAY_CHUNK].float(), rd[r0:r0 + RAY_CHUNK].float()
        inv = 1.0 / torch.where(d.abs() < 1e-30, torch.copysign(torch.full_like(d, 1e-30), d), d)
        t1 = (scene.box_min[None] - o[:, None]) * inv[:, None]
        t2 = (scene.box_max[None] - o[:, None]) * inv[:, None]
        near = torch.minimum(t1, t2).amax(-1)
        far = torch.maximum(t1, t2).amin(-1)
        del t1, t2
        pairs = ((far >= near) & (far > 0)).nonzero()
        del near, far
        for p0_ in range(0, pairs.shape[0], PAIR_CHUNK):
            ray = pairs[p0_:p0_ + PAIR_CHUNK, 0]
            tri = pairs[p0_:p0_ + PAIR_CHUNK, 1, None] * CLUSTER + lanes  # (P, G)
            ok, t, _, _ = _mt(ro[r0 + ray][:, None], rd[r0 + ray][:, None], scene.p0[tri],
                              scene.e1[tri], scene.e2[tri])
            t = torch.where(ok, t.float(), math.inf)
            row_t, arg = t.min(dim=1)
            row_tri = tri.gather(1, arg[:, None])[:, 0]
            hit = row_t < math.inf
            ray, row_t, row_tri = ray[hit] + r0, row_t[hit], row_tri[hit]
            # lexicographic (t, tri) minimum over the blocks
            cand_t = torch.cat([best_t, row_t])
            cand_tri = torch.cat([best_tri, row_tri])
            owner = torch.cat([torch.arange(n_rays, device=dev), ray])
            best_t = torch.full_like(best_t, math.inf).scatter_reduce(0, owner, cand_t, "amin")
            at_best = cand_t == best_t[owner]
            big = torch.iinfo(torch.int64).max
            best_tri = torch.full_like(best_tri, big).scatter_reduce(
                0, owner, torch.where(at_best & (cand_tri >= 0), cand_tri, big), "amin")
            best_tri = torch.where(best_tri == big, -1, best_tri)
    hit = best_tri >= 0
    tri = best_tri.clamp(min=0)
    _, t, u, v = _mt(ro, rd, scene.p0[tri], scene.e1[tri], scene.e2[tri])
    return hit, t, tri, u, v


# --- paths and their light ----------------------------------------------------


def env_lookup(env, rd, rotation: float):
    """Equirect uv of the direction, bilinear with clamp-to-edge
    (raytrace.wgsl:289-313)."""
    cr, sr = math.cos(rotation), math.sin(rotation)
    x = rd[:, 0] * cr - rd[:, 2] * sr
    z = rd[:, 0] * sr + rd[:, 2] * cr
    u = torch.atan2(x, z) * INVTWOPI + 0.5
    v = -torch.asin(torch.clamp(rd[:, 1], -1.0, 1.0)) * INVPI + 0.5
    h, w = env.shape[0], env.shape[1]
    fx, fy = u * w - 0.5, v * h - 0.5
    x0, y0 = torch.floor(fx), torch.floor(fy)
    ax, ay = (fx - x0)[:, None], (fy - y0)[:, None]
    x0, y0 = x0.long(), y0.long()
    xa, xb = x0.clamp(0, w - 1), (x0 + 1).clamp(0, w - 1)
    ya, yb = y0.clamp(0, h - 1), (y0 + 1).clamp(0, h - 1)
    top = env[ya, xa] * (1 - ax) + env[ya, xb] * ax
    bottom = env[yb, xa] * (1 - ax) + env[yb, xb] * ax
    return top * (1 - ay) + bottom * ay


@dataclasses.dataclass
class Paths:
    """Per bounce: hit (R,) bool, material (R,) int64, specular (R,) bool,
    miss (R,) bool, env (R, 3) radiance times intensity, met on a miss."""

    hit: list
    material: list
    specular: list
    miss: list
    env: list


def trace(scene: Scene, ro, rd, seed, bounces: int, *, intensity: float = 1.0,
          rotation: float = 0.0) -> Paths:
    """Trace rays (R, 3) with seeds (R,) for up to `bounces` bounces
    (raytrace.wgsl:373-411): a hit takes 7 draws (the hemisphere's 6, then
    the specular choice), a miss or an ended ray none."""
    dt = scene.dtype
    ro, rd = ro.to(dt), rd.to(dt)
    active = torch.ones(ro.shape[0], dtype=torch.bool, device=ro.device)
    paths = Paths([], [], [], [], [])
    for _ in range(bounces):
        hit, t, tri, u, v = intersect(scene, ro, rd)
        hit_now = active & hit
        miss_now = active & ~hit
        w = 1.0 - u - v
        normal = _normalize(scene.n0[tri] * w[:, None] + scene.n1[tri] * u[:, None]
                            + scene.n2[tri] * v[:, None])
        mat = scene.material[tri]
        seed_h, d = rand_direction(seed, dt)
        diffuse = _normalize(normal + d)
        seed_h, r_spec = rand(seed_h, dt)
        specular = scene.metalness[mat] >= r_spec
        mirror = rd - 2.0 * _dot(rd, normal)[:, None] * normal
        blend = (specular.to(dt) * (1.0 - scene.roughness[mat]))[:, None]
        new_dir = diffuse + (mirror - diffuse) * blend
        paths.hit.append(hit_now)
        paths.material.append(mat)
        paths.specular.append(specular)
        paths.miss.append(miss_now)
        paths.env.append(env_lookup(scene.env, rd, rotation) * intensity)
        h = hit_now[:, None]
        ro = torch.where(h, ro + t[:, None] * rd, ro)
        rd = torch.where(h, new_dir, rd)
        seed = torch.where(hit_now, seed_h, seed)
        active = hit_now
        if not bool(active.any()):
            break
    return paths


def radiance(paths: Paths, color, specular, emission):
    """Light of each traced ray, (R, 3), for material colours `color` (M, 3)
    (differentiable), specular colours and emission (M, 3)."""
    throughput = torch.ones_like(paths.env[0])
    light = torch.zeros_like(paths.env[0])
    for hit, mat, spec, miss, env in zip(paths.hit, paths.material, paths.specular, paths.miss,
                                         paths.env):
        h = hit[:, None]
        light = light + torch.where(h, emission[mat] * throughput, 0.0)
        light = light + torch.where(miss[:, None], env * throughput, 0.0)
        tint = torch.where(spec[:, None], specular[mat], color[mat])
        throughput = torch.where(h, throughput * tint, throughput)
    return light


def primary(scene: Scene, camera: dict, xs, ys, frame: int, width: int, height: int):
    """Jittered primary rays and their seeds after the two disk draws, for
    pixels (xs, ys) of a width x height image at `frame` (1 spp)."""
    dt = scene.dtype
    uv = torch.stack([xs.float() / float(width), ys.float() / float(height)], dim=-1).to(dt)
    origin, direction = camera_rays(camera, uv, width / height, dt)
    seed = pixel_seeds(xs + ys * width, frame)
    return jitter_rays(seed, origin, direction, camera, (float(width), float(height)), dt)


def render(scene: Scene, camera: dict, xs, ys, frames, width: int, height: int, bounces: int,
           *, color=None):
    """Light (len(frames), P, 3) of pixels (xs, ys) in each of `frames`, at
    1 sample a pixel and frame, traced as one batch of rays."""
    frames = list(frames)
    p = xs.shape[0]
    seeds, origins, dirs = [], [], []
    for f in frames:
        seed, o, d = primary(scene, camera, xs, ys, f, width, height)
        seeds.append(seed)
        origins.append(o)
        dirs.append(d)
    paths = trace(scene, torch.cat(origins), torch.cat(dirs), torch.cat(seeds), bounces)
    light = radiance(paths, scene.color if color is None else color, scene.specular,
                     scene.emission)
    return light.reshape(len(frames), p, 3)
