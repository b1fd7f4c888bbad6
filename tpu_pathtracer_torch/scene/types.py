"""Device-side scene representation: dataclasses of tensors.

The counterparts of the pytrees in `tpu_pathtracer.scene.types`, field for
field, so that `scene.convert` can carry a compiled JAX scene across key by
key.  Every class has `.to(device)`, which returns a copy whose tensors live
on that device.

Padding conventions are the JAX package's: padded triangles are all-zero
(the Möller–Trumbore determinant is 0, so they never hit), padded
materials are black, padded BVH nodes have the inverted box
[+inf]*3, [-inf]*3 (never hit) and links that end the walk.

Some f32 columns hold int32 bit patterns (`PackedGeometry.nodes` columns
6-7, `fat_nodes` columns 6-8; an index of -1 is a NaN pattern).  Read them
with `.contiguous().view(torch.int32)`; they must never pass through float
arithmetic or a float compare.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


class _TensorDataclass:
    """`.to(device)` over every tensor (or nested dataclass) field."""

    def to(self, device):
        out = {}
        for f in dataclasses.fields(self):
            value = getattr(self, f.name)
            if isinstance(value, (torch.Tensor, _TensorDataclass)):
                value = value.to(device)
            out[f.name] = value
        return dataclasses.replace(self, **out)


@dataclasses.dataclass
class Triangles(_TensorDataclass):
    """World-space triangle soup (reference Triangle struct, raytrace.wgsl:40-49)."""

    p0: torch.Tensor  # (N, 3) f32 vertex positions
    p1: torch.Tensor
    p2: torch.Tensor
    n0: torch.Tensor  # (N, 3) f32 vertex normals (world space, normalized)
    n1: torch.Tensor
    n2: torch.Tensor
    material: torch.Tensor  # (N,) i32 material index

    @property
    def count(self) -> int:
        return self.p0.shape[0]


@dataclasses.dataclass
class Materials(_TensorDataclass):
    """Material table (reference Material struct, raytrace.wgsl:31-38)."""

    color: torch.Tensor  # (M, 3)
    specular_color: torch.Tensor  # (M, 3)
    roughness: torch.Tensor  # (M,)
    metalness: torch.Tensor  # (M,)
    emission_color: torch.Tensor  # (M, 3)
    emission_strength: torch.Tensor  # (M,)

    @property
    def count(self) -> int:
        return self.roughness.shape[0]


@dataclasses.dataclass
class FlatBVH(_TensorDataclass):
    """Flattened BVH, breadth-first order, root at index 0, one triangle per
    leaf (the layout contract of the reference flattener,
    src/passes/raytrace.ts:667-694; node fields raytrace.wgsl:51-64)."""

    node_min: torch.Tensor  # (K, 3)
    node_max: torch.Tensor  # (K, 3)
    left: torch.Tensor  # (K,) i32, -1 for leaves/padding
    right: torch.Tensor  # (K,) i32
    tri: torch.Tensor  # (K,) i32 triangle index, -1 for internal/padding
    is_leaf: torch.Tensor  # (K,) i32 1 = leaf

    @property
    def count(self) -> int:
        return self.left.shape[0]


@dataclasses.dataclass
class LinkedBVH(_TensorDataclass):
    """DFS-preorder skip-link BVH (see accel.bvh.flat_to_links): hit-next is
    implicit (i + 1), `miss[i]` jumps over i's subtree, `tri[i] >= 0` marks a
    leaf.  The termination sentinel is the padded node count."""

    node_min: torch.Tensor  # (K, 3)
    node_max: torch.Tensor  # (K, 3)
    tri: torch.Tensor  # (K,) i32, -1 for internal
    miss: torch.Tensor  # (K,) i32

    @property
    def count(self) -> int:
        return self.tri.shape[0]


@dataclasses.dataclass
class PackedGeometry(_TensorDataclass):
    """Packed rows for the hot loop.  Triangle rows are in BVH-DFS leaf
    order (spatially coherent, so consecutive 64-row sub-treelets are tight
    boxes for the MT kernels' culling):

      nodes:     (K, 8)  f32 = [min.xyz, max.xyz, bitcast(tri), bitcast(miss)]
                 in skip-link DFS order; `tri` indexes the packed rows
      tri_pos:   (N, 9)  f32 = [p0, p1, p2]
      tri_shade: (N, 10) f32 = [n0, n1, n2, bitcast(material_idx)]
      tri_perm:  (N,)    i32 = original triangle index of each packed row
      fat_nodes: (K2, 81) f32 fat-leaf skip-link rows (accel.bvh.links_to_fat):
                 [min.xyz, max.xyz, bitcast(miss), bitcast(tri_start),
                 bitcast(count), up to 8 inlined tri_pos rows]
    """

    nodes: torch.Tensor
    tri_pos: torch.Tensor
    tri_shade: torch.Tensor
    tri_perm: torch.Tensor
    fat_nodes: torch.Tensor


@dataclasses.dataclass
class EnvironmentMap(_TensorDataclass):
    """Equirectangular environment map + CDF tables (see
    `tpu_pathtracer.scene.types.EnvironmentMap` for what each table means)."""

    radiance: torch.Tensor  # (H, W, 3) f32
    marginal_cdf: torch.Tensor  # (H, W) f32
    conditional_cdf: torch.Tensor  # (H, W) f32
    pdf: torch.Tensor  # (H, W) f32, reference-packed channel
    sample_pdf: torch.Tensor  # (H, W) f32, true uv-density of the CDF sampler

    @property
    def height(self) -> int:
        return self.radiance.shape[0]

    @property
    def width(self) -> int:
        return self.radiance.shape[1]

    @classmethod
    def black(cls, height: int = 8, width: int = 16, device="cpu") -> "EnvironmentMap":
        z = torch.zeros((height, width), dtype=torch.float32, device=device)
        return cls(
            radiance=torch.zeros((height, width, 3), dtype=torch.float32, device=device),
            marginal_cdf=z,
            conditional_cdf=z.clone(),
            pdf=z.clone(),
            sample_pdf=z.clone(),
        )


@dataclasses.dataclass
class SceneData(_TensorDataclass):
    """The compiled device scene: everything a frame reads.  `bvh` is the
    reference-contract flat layout (the stack walk's), `links` the
    skip-link layout; `packed` is what the hot loops gather from."""

    triangles: Triangles
    materials: Materials
    bvh: FlatBVH
    links: LinkedBVH
    packed: PackedGeometry
    env: EnvironmentMap


@dataclasses.dataclass
class Camera(_TensorDataclass):
    """Thin-lens camera (reference Camera struct raytrace.wgsl:10-16)."""

    position: torch.Tensor  # (3,)
    direction: torch.Tensor  # (3,) normalized in ray-gen
    fov: torch.Tensor  # () degrees, vertical
    focal_distance: torch.Tensor  # ()
    aperture: torch.Tensor  # ()

    @classmethod
    def create(
        cls,
        position=(0.0, 1.0, 4.0),
        direction=None,
        look_at=None,
        fov: float = 45.0,
        focal_distance: float = 1.0,
        aperture: float = 0.0,
        device="cpu",
    ) -> "Camera":
        pos = np.asarray(position, np.float32)
        if direction is None:
            if look_at is not None:
                direction = np.asarray(look_at, np.float32) - pos
            else:
                direction = np.array([0.0, 0.0, -1.0], np.float32)
        d = np.asarray(direction, np.float32)
        d = d / np.linalg.norm(d)
        f32 = lambda x: torch.tensor(np.float32(x), device=device)
        return cls(
            position=torch.from_numpy(pos).to(device),
            direction=torch.from_numpy(d).to(device),
            fov=f32(fov),
            focal_distance=f32(focal_distance),
            aperture=f32(aperture),
        )


@dataclasses.dataclass
class RenderParams(_TensorDataclass):
    """Per-frame parameters (the reference's Uniforms minus the static shape
    data; raytrace.wgsl:66-75).  `frame` is a host integer (1-based): the
    port reads it on the host to seed the frame and weight the running
    mean, where the JAX package traced it."""

    camera: Camera
    frame: int
    env_intensity: torch.Tensor  # () f32
    env_rotation: torch.Tensor  # () f32, radians

    @classmethod
    def create(cls, camera: Camera, frame: int = 1, env_intensity: float = 1.0,
               env_rotation: float = 0.0) -> "RenderParams":
        device = camera.position.device
        return cls(
            camera=camera,
            frame=int(frame),
            env_intensity=torch.tensor(np.float32(env_intensity), device=device),
            env_rotation=torch.tensor(np.float32(env_rotation), device=device),
        )


def pad_pow2(n: int, minimum: int = 1) -> int:
    """Next power of two >= max(n, minimum)."""
    n = max(n, minimum)
    return 1 << (n - 1).bit_length()
