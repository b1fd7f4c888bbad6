"""Scenes from a configuration file: the meshes, materials, environment and
camera that the benchmark hands both the program and the reference.

The generators are the three.js tessellations that the reference's scene
uses (PlaneGeometry, BoxGeometry, SphereGeometry: vertex order, winding,
smooth normals) and the project's analytic gradient sky, copied into the
benchmark so that its inputs do not come from the program.  A mesh entry of
a configuration names its generator, the generator's arguments, a material
and a list of transforms applied right to left as the scene's matrices
multiply ([["translation", x, y, z]], [["rotation_x", angle]], ...).
"""

from __future__ import annotations

import math

import numpy as np


def plane(width=1.0, height=1.0, width_segments=1, height_segments=1):
    gx, gy = int(width_segments), int(height_segments)
    gx1 = gx + 1
    seg_w, seg_h = width / gx, height / gy
    positions = []
    for iy in range(gy + 1):
        y = iy * seg_h - height / 2.0
        for ix in range(gx1):
            positions.append((ix * seg_w - width / 2.0, -y, 0.0))
    normals = np.zeros((len(positions), 3), np.float32)
    normals[:, 2] = 1.0
    indices = []
    for iy in range(gy):
        for ix in range(gx):
            a, b = ix + gx1 * iy, ix + gx1 * (iy + 1)
            c, d = ix + 1 + gx1 * (iy + 1), ix + 1 + gx1 * iy
            indices += [(a, b, d), (b, c, d)]
    return np.asarray(positions, np.float32), normals, np.asarray(indices, np.int32)


def box(width=1.0, height=1.0, depth=1.0, segments=1):
    positions, normals, indices = [], [], []
    axes = {"x": 0, "y": 1, "z": 2}

    def side(u, v, w, udir, vdir, pw, ph, pd, grid):
        offset = len(positions)
        gx1 = grid + 1
        for iy in range(gx1):
            y = iy * ph / grid - ph / 2.0
            for ix in range(gx1):
                vec = [0.0, 0.0, 0.0]
                vec[axes[u]] = (ix * pw / grid - pw / 2.0) * udir
                vec[axes[v]] = y * vdir
                vec[axes[w]] = pd / 2.0
                positions.append(tuple(vec))
                nrm = [0.0, 0.0, 0.0]
                nrm[axes[w]] = 1.0 if pd > 0 else -1.0
                normals.append(tuple(nrm))
        for iy in range(grid):
            for ix in range(grid):
                a, b = offset + ix + gx1 * iy, offset + ix + gx1 * (iy + 1)
                c, d = offset + ix + 1 + gx1 * (iy + 1), offset + ix + 1 + gx1 * iy
                indices.extend([(a, b, d), (b, c, d)])

    s = int(segments)
    side("z", "y", "x", -1, -1, depth, height, width, s)
    side("z", "y", "x", 1, -1, depth, height, -width, s)
    side("x", "z", "y", 1, 1, width, depth, height, s)
    side("x", "z", "y", 1, -1, width, depth, -height, s)
    side("x", "y", "z", 1, -1, width, height, depth, s)
    side("x", "y", "z", -1, -1, width, height, -depth, s)
    return (np.asarray(positions, np.float32), np.asarray(normals, np.float32),
            np.asarray(indices, np.int32))


def sphere(radius=1.0, width_segments=32, height_segments=16):
    ws, hs = max(3, int(width_segments)), max(2, int(height_segments))
    positions, normals, grid = [], [], []
    for iy in range(hs + 1):
        theta = iy / hs * np.pi
        row = []
        for ix in range(ws + 1):
            phi = ix / ws * 2.0 * np.pi
            p = (-radius * np.cos(phi) * np.sin(theta), radius * np.cos(theta),
                 radius * np.sin(phi) * np.sin(theta))
            positions.append(p)
            n = np.array(p, np.float64)
            length = np.linalg.norm(n)
            normals.append(tuple(n / length) if length > 0 else (0.0, 1.0, 0.0))
            row.append(len(positions) - 1)
        grid.append(row)
    indices = []
    for iy in range(hs):
        for ix in range(ws):
            a, b = grid[iy][ix + 1], grid[iy][ix]
            c, d = grid[iy + 1][ix], grid[iy + 1][ix + 1]
            if iy != 0:
                indices.append((a, b, d))
            if iy != hs - 1:
                indices.append((b, c, d))
    return (np.asarray(positions, np.float32), np.asarray(normals, np.float32),
            np.asarray(indices, np.int32))


def gradient_sky(height=512, width=1024, horizon=(1.0, 0.9, 0.7), zenith=(0.2, 0.4, 0.9),
                 ground=(0.15, 0.12, 0.1), intensity=1.0):
    """The project's analytic sky: zenith, horizon and ground colours by
    elevation, and a bright sun blob, (H, W, 3) float32."""
    v = (np.arange(height, dtype=np.float32) + 0.5) / height
    elev = np.cos(v * np.pi)
    up = np.clip(elev, 0.0, 1.0)[:, None]
    down = np.clip(-elev, 0.0, 1.0)[:, None]
    col = (up * np.asarray(zenith, np.float32) + down * np.asarray(ground, np.float32)
           + (1.0 - up - down) * np.asarray(horizon, np.float32))
    img = np.broadcast_to(col[:, None, :], (height, width, 3)).copy()
    u = (np.arange(width, dtype=np.float32) + 0.5) / width
    sun = (np.exp(-(((u - 0.25) * 24.0) ** 2))[None, :, None]
           * np.exp(-(((v - 0.3) * 12.0) ** 2))[:, None, None])
    img += sun * np.asarray([40.0, 36.0, 30.0], np.float32)
    return (img * intensity).astype(np.float32)


GENERATORS = {"plane": plane, "box": box, "sphere": sphere}
ENVIRONMENTS = {"gradient_sky": gradient_sky}


def _matrix(transforms) -> np.ndarray:
    m = np.eye(4)
    for op, *args in transforms:
        t = np.eye(4)
        if op == "translation":
            t[:3, 3] = args
        elif op in ("rotation_x", "rotation_y", "rotation_z"):
            c, s = math.cos(args[0]), math.sin(args[0])
            i, j = {"rotation_x": (1, 2), "rotation_y": (2, 0), "rotation_z": (0, 1)}[op]
            t[i, i], t[i, j], t[j, i], t[j, j] = c, -s, s, c
        else:
            raise ValueError(f"unknown transform {op!r}")
        m = m @ t
    return m


MATERIAL_KEYS = ("color", "specular_color", "roughness", "metalness", "emission_color",
                 "emission_strength")
MATERIAL_DEFAULTS = {"color": (1.0, 1.0, 1.0), "specular_color": (1.0, 1.0, 1.0),
                     "roughness": 1.0, "metalness": 0.0, "emission_color": (0.0, 0.0, 0.0),
                     "emission_strength": 0.0}


def meshes(config: dict):
    """[(positions, normals, indices, material name, 4x4 matrix)] of the
    configuration's meshes."""
    out = []
    for mesh in config["meshes"]:
        p, n, idx = GENERATORS[mesh["shape"]](*mesh.get("args", ()))
        out.append((p, n, idx, mesh["material"], _matrix(mesh.get("transform", ()))))
    return out


def materials(config: dict) -> dict:
    """{name: full material dict} with the defaults filled in."""
    return {name: {k: m.get(k, MATERIAL_DEFAULTS[k]) for k in MATERIAL_KEYS}
            for name, m in config["materials"].items()}


def environment(config: dict) -> np.ndarray:
    env = dict(config["environment"])
    return ENVIRONMENTS[env.pop("kind")](**env)


def world_triangles(config: dict):
    """(triangles, material table) for the reference: world-space corners
    and vertex normals of every triangle, the normals by the inverse
    transpose and normalised, and the materials in order of first use."""
    mats = materials(config)
    names: list = []
    rows = {k: [] for k in ("p0", "p1", "p2", "n0", "n1", "n2")}
    index = []
    for p, n, idx, name, m in meshes(config):
        if name not in names:
            names.append(name)
        wp = p.astype(np.float64) @ m[:3, :3].T + m[:3, 3]
        wn = n.astype(np.float64) @ np.linalg.inv(m[:3, :3])
        wn /= np.maximum(np.linalg.norm(wn, axis=1, keepdims=True), 1e-30)
        for c in range(3):
            rows[f"p{c}"].append(wp[idx[:, c]].astype(np.float32))
            rows[f"n{c}"].append(wn[idx[:, c]].astype(np.float32))
        index.append(np.full(idx.shape[0], names.index(name), np.int64))
    tris = {k: np.concatenate(v) for k, v in rows.items()}
    tris["material"] = np.concatenate(index)
    table = {k: np.asarray([mats[nm][k] for nm in names], np.float32) for k in MATERIAL_KEYS}
    return tris, table


def program_scene(pt, config: dict):
    """The configuration as the program's authoring `Scene`."""
    mats = {name: pt.Material(**{k: (tuple(v) if isinstance(v, (list, tuple)) else v)
                                 for k, v in m.items()})
            for name, m in materials(config).items()}
    scene = pt.Scene()
    for p, n, idx, name, m in meshes(config):
        scene.add(pt.Mesh(p, n, idx, mats[name], transform=m))
    scene.set_environment(environment(config))
    return scene
