"""Procedural mesh generators with three.js-compatible tessellation.

The reference's default scene is built from three.js PlaneGeometry /
BoxGeometry / SphereGeometry (reference: src/main.ts:60-73).  To be able to
reproduce that scene triangle-for-triangle (golden-image parity), these
generators emit the same vertex ordering, winding and smooth normals as the
three.js geometry classes.  All outputs are indexed (positions, normals,
indices) numpy arrays.

A copy of `tpu_pathtracer.scene.primitives` (plane, box, sphere): the port
may not import the JAX package, whose `__init__` loads JAX.
"""

from __future__ import annotations

import numpy as np


def plane(width: float = 1.0, height: float = 1.0, width_segments: int = 1, height_segments: int = 1):
    """three.js PlaneGeometry: XY plane, +Z normal."""
    gx, gy = int(width_segments), int(height_segments)
    gx1, gy1 = gx + 1, gy + 1
    seg_w, seg_h = width / gx, height / gy
    half_w, half_h = width / 2.0, height / 2.0

    positions = np.zeros((gx1 * gy1, 3), np.float32)
    normals = np.zeros((gx1 * gy1, 3), np.float32)
    normals[:, 2] = 1.0
    k = 0
    for iy in range(gy1):
        y = iy * seg_h - half_h
        for ix in range(gx1):
            x = ix * seg_w - half_w
            positions[k] = (x, -y, 0.0)
            k += 1

    indices = []
    for iy in range(gy):
        for ix in range(gx):
            a = ix + gx1 * iy
            b = ix + gx1 * (iy + 1)
            c = (ix + 1) + gx1 * (iy + 1)
            d = (ix + 1) + gx1 * iy
            indices.append((a, b, d))
            indices.append((b, c, d))
    return positions, normals, np.asarray(indices, np.int32)


def box(width: float = 1.0, height: float = 1.0, depth: float = 1.0, segments: int = 1):
    """three.js BoxGeometry (uniform segment count per axis)."""
    positions: list = []
    normals: list = []
    indices: list = []

    axes = {"x": 0, "y": 1, "z": 2}

    def build_plane(u, v, w, udir, vdir, plane_w, plane_h, plane_d, grid_x, grid_y):
        seg_w = plane_w / grid_x
        seg_h = plane_h / grid_y
        half_w, half_h, half_d = plane_w / 2.0, plane_h / 2.0, plane_d / 2.0
        gx1, gy1 = grid_x + 1, grid_y + 1
        offset = len(positions)
        for iy in range(gy1):
            y = iy * seg_h - half_h
            for ix in range(gx1):
                x = ix * seg_w - half_w
                vec = [0.0, 0.0, 0.0]
                vec[axes[u]] = x * udir
                vec[axes[v]] = y * vdir
                vec[axes[w]] = half_d
                positions.append(tuple(vec))
                nrm = [0.0, 0.0, 0.0]
                nrm[axes[w]] = 1.0 if plane_d > 0 else -1.0
                normals.append(tuple(nrm))
        for iy in range(grid_y):
            for ix in range(grid_x):
                a = offset + ix + gx1 * iy
                b = offset + ix + gx1 * (iy + 1)
                c = offset + (ix + 1) + gx1 * (iy + 1)
                d = offset + (ix + 1) + gx1 * iy
                indices.append((a, b, d))
                indices.append((b, c, d))

    s = int(segments)
    build_plane("z", "y", "x", -1, -1, depth, height, width, s, s)  # px
    build_plane("z", "y", "x", 1, -1, depth, height, -width, s, s)  # nx
    build_plane("x", "z", "y", 1, 1, width, depth, height, s, s)  # py
    build_plane("x", "z", "y", 1, -1, width, depth, -height, s, s)  # ny
    build_plane("x", "y", "z", 1, -1, width, height, depth, s, s)  # pz
    build_plane("x", "y", "z", -1, -1, width, height, -depth, s, s)  # nz

    return (
        np.asarray(positions, np.float32),
        np.asarray(normals, np.float32),
        np.asarray(indices, np.int32),
    )


def sphere(radius: float = 1.0, width_segments: int = 32, height_segments: int = 16):
    """three.js SphereGeometry (full sphere), smooth normals = normalized position."""
    ws = max(3, int(width_segments))
    hs = max(2, int(height_segments))

    positions: list = []
    normals: list = []
    grid: list = []
    for iy in range(hs + 1):
        row = []
        v = iy / hs
        theta = v * np.pi
        for ix in range(ws + 1):
            u = ix / ws
            phi = u * 2.0 * np.pi
            x = -radius * np.cos(phi) * np.sin(theta)
            y = radius * np.cos(theta)
            z = radius * np.sin(phi) * np.sin(theta)
            positions.append((x, y, z))
            n = np.array((x, y, z), np.float64)
            ln = np.linalg.norm(n)
            normals.append(tuple(n / ln) if ln > 0 else (0.0, 1.0, 0.0))
            row.append(len(positions) - 1)
        grid.append(row)

    indices = []
    for iy in range(hs):
        for ix in range(ws):
            a = grid[iy][ix + 1]
            b = grid[iy][ix]
            c = grid[iy + 1][ix]
            d = grid[iy + 1][ix + 1]
            if iy != 0:
                indices.append((a, b, d))
            if iy != hs - 1:
                indices.append((b, c, d))

    return (
        np.asarray(positions, np.float32),
        np.asarray(normals, np.float32),
        np.asarray(indices, np.int32),
    )

