"""Host-side scene authoring and the scene -> device compile step.

The port of `tpu_pathtracer.scene.host`: meshes carry a 4x4 world
transform; at compile time triangles go to world space (positions by the
matrix, normals by the inverse-transpose, normalized), materials are
deduplicated, the SAH BVH is built and laid out for the traversals (flat,
skip-link, fat-leaf), and the triangle rows are packed in BVH-DFS leaf
order.  All of it is numpy on the host; `compile(device=...)` hands the
result over as tensors on that device, the card by default.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from ..accel.bvh import build_bvh_flat, flat_to_links, links_to_fat
from . import primitives
from .envmap import build_environment
from .types import (
    EnvironmentMap,
    FlatBVH,
    LinkedBVH,
    Materials,
    PackedGeometry,
    SceneData,
    Triangles,
    pad_pow2,
)


@dataclasses.dataclass
class Material:
    """Authoring material (reference RaytracingMaterial, src/scene.ts:12-14)."""

    color: tuple = (1.0, 1.0, 1.0)
    specular_color: tuple = (1.0, 1.0, 1.0)
    roughness: float = 1.0
    metalness: float = 0.0
    emission_color: tuple = (0.0, 0.0, 0.0)
    emission_strength: float = 0.0


def identity() -> np.ndarray:
    return np.eye(4, dtype=np.float64)


def translation(x: float, y: float, z: float) -> np.ndarray:
    m = identity()
    m[:3, 3] = (x, y, z)
    return m


def rotation_x(angle: float) -> np.ndarray:
    c, s = math.cos(angle), math.sin(angle)
    m = identity()
    m[1, 1], m[1, 2], m[2, 1], m[2, 2] = c, -s, s, c
    return m


def rotation_y(angle: float) -> np.ndarray:
    c, s = math.cos(angle), math.sin(angle)
    m = identity()
    m[0, 0], m[0, 2], m[2, 0], m[2, 2] = c, s, -s, c
    return m


def rotation_z(angle: float) -> np.ndarray:
    c, s = math.cos(angle), math.sin(angle)
    m = identity()
    m[0, 0], m[0, 1], m[1, 0], m[1, 1] = c, -s, s, c
    return m


def scaling(x: float, y: Optional[float] = None, z: Optional[float] = None) -> np.ndarray:
    y = x if y is None else y
    z = x if z is None else z
    m = identity()
    m[0, 0], m[1, 1], m[2, 2] = x, y, z
    return m


@dataclasses.dataclass
class Mesh:
    """A mesh instance: indexed geometry + material + world transform."""

    positions: np.ndarray  # (V, 3)
    normals: np.ndarray  # (V, 3)
    indices: np.ndarray  # (F, 3) int
    material: Material
    transform: np.ndarray = dataclasses.field(default_factory=identity)
    visible: bool = True

    def transformed(self, matrix: np.ndarray) -> "Mesh":
        return dataclasses.replace(self, transform=matrix @ self.transform)


def _pad(a: np.ndarray, cap: int, fill=0.0) -> np.ndarray:
    out = np.full((cap,) + a.shape[1:], fill, a.dtype)
    out[: a.shape[0]] = a
    return out


def _fat_nodes(links_np, packed_tri_pos, tri_packed_id) -> np.ndarray:
    """The fat-leaf traversal table (`accel.bvh.links_to_fat`, 8 triangles a
    leaf) padded to a power of two, as the JAX compile pads it: padded rows
    have the inverted box and a miss link to the padded count, and links
    that ended the real tree end the padded one."""
    fat_np = links_to_fat(links_np, packed_tri_pos, tri_packed_id)
    k2 = fat_np.shape[0]
    cap_fat = pad_pow2(max(k2, 1), 1)
    width = fat_np.shape[1] if fat_np.size else 81
    fat_padded = np.zeros((cap_fat, width), np.float32)
    fat_padded[:, 0:3] = np.float32(np.inf)  # inverted boxes: never hit
    fat_padded[:, 3:6] = np.float32(-np.inf)
    fat_padded[:, 6] = np.int32(cap_fat).view(np.float32)
    if k2:
        # re-target the termination sentinel to the padded node count
        mcol = np.ascontiguousarray(fat_np[:, 6]).view(np.int32)
        mcol[mcol == k2] = cap_fat
        fat_np[:, 6] = mcol.view(np.float32)
        fat_padded[:k2] = fat_np
    return fat_padded


class Scene:
    """Mutable authoring scene; `compile(device=...)` produces `SceneData`.

    `needs_update` mirrors RaytracingScene.needsUpdate (src/scene.ts:3-5): the
    Renderer checks it to decide whether to re-run the scene compiler."""

    def __init__(self) -> None:
        self.meshes: list[Mesh] = []
        self.env_radiance: Optional[np.ndarray] = None  # (H, W, 3) float32
        self.needs_update: bool = True

    def add(self, mesh: Mesh) -> None:
        self.meshes.append(mesh)
        self.needs_update = True

    def clear(self) -> None:
        self.meshes.clear()
        self.needs_update = True

    def set_environment(self, radiance: np.ndarray) -> None:
        self.env_radiance = np.asarray(radiance, np.float32)
        self.needs_update = True

    def gather_triangles(self):
        """World-space triangle extraction + material dedup (the host half of
        raytrace.ts:407-502).  Returns numpy SoA + material list."""
        tri_p = [[], [], []]
        tri_n = [[], [], []]
        tri_m = []
        materials: list[Material] = []

        for mesh in self.meshes:
            if not mesh.visible:
                continue
            if mesh.material in materials:
                mat_idx = materials.index(mesh.material)
            else:
                mat_idx = len(materials)
                materials.append(mesh.material)

            m = np.asarray(mesh.transform, np.float64)
            normal_matrix = np.linalg.inv(m[:3, :3]).T

            pos = np.asarray(mesh.positions, np.float64)
            world_pos = pos @ m[:3, :3].T + m[:3, 3]
            nrm = np.asarray(mesh.normals, np.float64) @ normal_matrix.T
            nrm /= np.maximum(np.linalg.norm(nrm, axis=1, keepdims=True), 1e-30)

            idx = np.asarray(mesh.indices, np.int64).reshape(-1, 3)
            for corner in range(3):
                tri_p[corner].append(world_pos[idx[:, corner]].astype(np.float32))
                tri_n[corner].append(nrm[idx[:, corner]].astype(np.float32))
            tri_m.append(np.full((idx.shape[0],), mat_idx, np.int32))

        if not tri_m:
            empty3 = np.zeros((0, 3), np.float32)
            return (empty3,) * 6 + (np.zeros((0,), np.int32), materials)

        p0, p1, p2 = (np.concatenate(tri_p[c], axis=0) for c in range(3))
        n0, n1, n2 = (np.concatenate(tri_n[c], axis=0) for c in range(3))
        mat = np.concatenate(tri_m, axis=0)
        return p0, p1, p2, n0, n1, n2, mat, materials

    def compile(self, pad_triangles: Optional[int] = None, pad_nodes: Optional[int] = None,
                env_size: Optional[tuple] = None, device="cuda") -> SceneData:
        """Build the device scene (triangles, materials, the BVH in its three
        layouts, packed rows, env CDF) as tensors on `device`, the card unless
        the caller asks for another.  The BVH comes from the native builder
        (`accel.native`) unless TPU_PT_NO_NATIVE selects the numpy one; both
        give the same bytes."""
        p0, p1, p2, n0, n1, n2, mat, materials = self.gather_triangles()
        n = p0.shape[0]

        bvh_np = build_bvh_flat(p0, p1, p2)
        k = bvh_np["min"].shape[0]
        cap_tris = pad_triangles if pad_triangles is not None else pad_pow2(n, 1)
        cap_nodes = pad_nodes if pad_nodes is not None else pad_pow2(max(k, 1), 1)
        if cap_tris < n or cap_nodes < k:
            raise ValueError(f"padding too small: tris {n}>{cap_tris} or nodes {k}>{cap_nodes}")

        inf = np.float32(np.inf)
        flat = [_pad(bvh_np["min"], cap_nodes, inf), _pad(bvh_np["max"], cap_nodes, -inf),
                _pad(bvh_np["left"], cap_nodes, np.int32(-1)),
                _pad(bvh_np["right"], cap_nodes, np.int32(-1)),
                _pad(bvh_np["tri"], cap_nodes, np.int32(-1)),
                _pad(bvh_np["is_leaf"], cap_nodes, np.int32(0))]

        links_np = flat_to_links(bvh_np, end=cap_nodes)
        lmin = _pad(links_np["min"], cap_nodes, inf)
        lmax = _pad(links_np["max"], cap_nodes, -inf)
        ltri = _pad(links_np["tri"], cap_nodes, np.int32(-1))
        lmiss = _pad(links_np["miss"], cap_nodes, np.int32(cap_nodes))

        # Packed rows use BVH-DFS *leaf order*: consecutive rows are spatially
        # adjacent, so the MT kernels' fixed-size treelets are tight boxes for
        # their culling.  Skip-link leaf pointers are relabelled to that order;
        # `tri_perm` maps packed rows back to input order.
        leaf_order = links_np["tri"][links_np["tri"] >= 0].astype(np.int64)
        if leaf_order.shape[0] != n:  # degenerate/empty scene: identity
            leaf_order = np.arange(n, dtype=np.int64)
        inv_order = np.empty(n, np.int64)
        inv_order[leaf_order] = np.arange(n)
        perm = lambda a: a[leaf_order] if n else a

        def packed_ids(tri):  # skip-link leaf pointers -> packed rows (-1 stays)
            if not n:
                return tri
            return np.where(tri >= 0, inv_order[np.clip(tri, 0, n - 1)], -1).astype(np.int32)

        packed_nodes = np.concatenate(
            [lmin, lmax, packed_ids(ltri).view(np.float32)[:, None],
             lmiss.view(np.float32)[:, None]], axis=1)
        packed_tri_pos = np.concatenate(
            [_pad(perm(p0), cap_tris), _pad(perm(p1), cap_tris), _pad(perm(p2), cap_tris)],
            axis=1,
        )
        packed_tri_shade = np.concatenate(
            [
                _pad(perm(n0), cap_tris),
                _pad(perm(n1), cap_tris),
                _pad(perm(n2), cap_tris),
                _pad(perm(mat), cap_tris).view(np.float32)[:, None],
            ],
            axis=1,
        )
        tri_perm = np.full((cap_tris,), -1, np.int32)
        tri_perm[:n] = leaf_order
        fat_nodes = _fat_nodes(links_np, packed_tri_pos, packed_ids(links_np["tri"]))

        nmat = max(1, len(materials))
        color = np.zeros((nmat, 3), np.float32)
        spec = np.zeros((nmat, 3), np.float32)
        rough = np.ones((nmat,), np.float32)
        metal = np.zeros((nmat,), np.float32)
        ecol = np.zeros((nmat, 3), np.float32)
        estr = np.zeros((nmat,), np.float32)
        for i, m in enumerate(materials):
            color[i] = m.color
            spec[i] = m.specular_color
            rough[i] = m.roughness
            metal[i] = m.metalness
            ecol[i] = m.emission_color
            estr[i] = m.emission_strength

        t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
        triangles = Triangles(
            p0=t(_pad(p0, cap_tris)), p1=t(_pad(p1, cap_tris)), p2=t(_pad(p2, cap_tris)),
            n0=t(_pad(n0, cap_tris)), n1=t(_pad(n1, cap_tris)), n2=t(_pad(n2, cap_tris)),
            material=t(_pad(mat, cap_tris)),
        )
        bvh = FlatBVH(node_min=t(flat[0]), node_max=t(flat[1]), left=t(flat[2]),
                      right=t(flat[3]), tri=t(flat[4]), is_leaf=t(flat[5]))
        links = LinkedBVH(node_min=t(lmin), node_max=t(lmax), tri=t(ltri), miss=t(lmiss))
        packed = PackedGeometry(
            nodes=t(packed_nodes), tri_pos=t(packed_tri_pos), tri_shade=t(packed_tri_shade),
            tri_perm=t(tri_perm), fat_nodes=t(fat_nodes),
        )
        mats = Materials(
            color=t(color), specular_color=t(spec), roughness=t(rough),
            metalness=t(metal), emission_color=t(ecol), emission_strength=t(estr),
        )
        if self.env_radiance is not None:
            env = build_environment(self.env_radiance, device=device)
        else:
            env = EnvironmentMap.black(*(env_size or (8, 16)), device=device)

        self.needs_update = False
        return SceneData(triangles=triangles, materials=mats, bvh=bvh, links=links,
                         packed=packed, env=env)


def default_scene(env_radiance: Optional[np.ndarray] = None) -> Scene:
    """The reference's default scene: 5x5 ground plane (white), 0.8 box (red)
    at (0, 0.4, 0.5), r=0.5 sphere (white) at (0, 0.5, -0.5)
    (reference: src/main.ts:49-75)."""
    white = Material(color=(1.0, 1.0, 1.0), roughness=1.0, metalness=0.02,
                     specular_color=(1.0, 1.0, 1.0))
    red = Material(color=(1.0, 0.05, 0.05), roughness=1.0, metalness=0.0,
                   specular_color=(1.0, 1.0, 1.0))

    scene = Scene()

    p, n, idx = primitives.plane(5.0, 5.0)
    scene.add(Mesh(p, n, idx, white, transform=rotation_x(-math.pi / 2)))

    p, n, idx = primitives.box(0.8, 0.8, 0.8)
    scene.add(Mesh(p, n, idx, red, transform=translation(0.0, 0.4, 0.5)))

    p, n, idx = primitives.sphere(0.5, 32, 32)
    scene.add(Mesh(p, n, idx, white, transform=translation(0.0, 0.5, -0.5)))

    if env_radiance is not None:
        scene.set_environment(env_radiance)
    return scene
