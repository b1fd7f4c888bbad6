"""Camera ray generation: pinhole frustum + thin-lens depth of field.

The port of `tpu_pathtracer.ops.camera`, with the reference's quirks
(reference: src/passes/shaders/raytrace.wgsl:217-250, 444-449): focal length
equal to the aspect ratio, the up-vector degeneracy fix, uv without a
half-pixel offset, and both DoF and AA jitter applied in world axes.
"""

from __future__ import annotations

import numpy as np
import torch

from . import rng
from .vecmath import cross, normalize


def camera_basis(direction):
    """Returns (u_dir, v_dir, w) per raytrace.wgsl:226-235.  `direction` (3,)."""
    w = normalize(-direction)
    up_default = torch.tensor([0.0, 1.0, 0.0], dtype=torch.float32, device=w.device)
    up_alt = torch.tensor([0.0, 0.0, 1.0], dtype=torch.float32, device=w.device)
    degenerate = torch.abs(torch.sum(w * up_default)) > float(np.float32(0.99999))
    up = torch.where(degenerate, up_alt, up_default)
    u_dir = normalize(cross(up, w))
    v_dir = cross(w, u_dir)
    return u_dir, v_dir, w


def camera_rays(camera, uv, aspect: float):
    """Primary rays for pixel uvs: uv (R, 2) f32 -> (origin (R,3), direction (R,3))."""
    aspect_t = torch.tensor(np.float32(aspect), device=uv.device)
    fov_rad = camera.fov * float(np.float32(np.pi / 180.0))
    t = torch.tan(fov_rad / 2.0)
    r = aspect_t * t
    u = -r + (r - (-r)) * uv[..., 0]
    v = -t + (t - (-t)) * uv[..., 1]

    u_dir, v_dir, w = camera_basis(camera.direction)
    direction = normalize(u_dir * u[..., None] + v_dir * v[..., None] - w * aspect_t)
    origin = camera.position.expand(direction.shape)
    return origin, direction


def apply_dof(seed, origin, direction, camera, resolution, aa_uniforms=None):
    """Per-sample AA + thin-lens jitter (raytrace.wgsl:444-449).

    resolution: (2,) f32 (render resolution, like uniforms.resolution).
    `aa_uniforms`: optional (R, 2) uniforms that place the AA disk point in
    place of the two hash draws (the blue-noise jitter of
    `ops.trace.render_frame`); the seed stream then skips those draws.
    Returns (seed, new_origin, new_direction)."""
    if aa_uniforms is None:
        seed, disk1 = rng.rand_point_in_circle(seed)
    else:
        disk1 = rng.disk_from_uniforms(aa_uniforms[..., 0], aa_uniforms[..., 1])
    seed, disk2 = rng.rand_point_in_circle(seed)
    zeros = torch.zeros(disk1.shape[:-1] + (1,), dtype=torch.float32, device=disk1.device)
    jitter = torch.cat([disk1 / resolution, zeros], dim=-1)
    jitter2 = torch.cat([disk2 * camera.aperture, zeros], dim=-1)
    focal_point = origin + direction * camera.focal_distance + jitter
    new_origin = origin + jitter2
    new_direction = normalize(focal_point - new_origin)
    return seed, new_origin, new_direction
