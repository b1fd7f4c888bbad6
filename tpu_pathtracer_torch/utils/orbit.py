"""Orbit camera controller — the three.js OrbitControls equivalent.

The port of `tpu_pathtracer.utils.orbit`.  The reference wires
OrbitControls to the camera and resets the progressive render on change
(reference: src/main.ts:366-371).  This is the headless counterpart:
spherical-coordinate state (azimuth/elevation/radius around a target) with
rotate/zoom/pan operations that produce `Camera`s on a given device.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from ..scene.types import Camera

_EPS = 1e-6


@dataclasses.dataclass
class OrbitCamera:
    """Spherical orbit rig: y-up, azimuth about +Y (0 looks down -Z shifted
    to +Z side), elevation in (-pi/2, pi/2)."""

    target: tuple = (0.0, 0.5, 0.0)
    radius: float = 4.0
    azimuth: float = 0.0  # radians
    elevation: float = 0.25  # radians above the horizon
    fov: float = 45.0
    focal_distance: float = 1.0
    aperture: float = 0.0
    min_radius: float = 0.05

    @property
    def position(self) -> np.ndarray:
        ce = math.cos(self.elevation)
        offset = np.array(
            [
                self.radius * ce * math.sin(self.azimuth),
                self.radius * math.sin(self.elevation),
                self.radius * ce * math.cos(self.azimuth),
            ]
        )
        return np.asarray(self.target, np.float64) + offset

    def rotate(self, d_azimuth: float, d_elevation: float) -> "OrbitCamera":
        lim = math.pi / 2 - _EPS
        return dataclasses.replace(
            self,
            azimuth=(self.azimuth + d_azimuth) % (2 * math.pi),
            elevation=max(-lim, min(lim, self.elevation + d_elevation)),
        )

    def zoom(self, factor: float) -> "OrbitCamera":
        """factor > 1 zooms out (dolly), < 1 zooms in."""
        return dataclasses.replace(
            self, radius=max(self.min_radius, self.radius * factor)
        )

    def pan(self, dx: float, dy: float) -> "OrbitCamera":
        """Shift the target in the camera's screen plane (right, up)."""
        pos = self.position
        fwd = np.asarray(self.target, np.float64) - pos
        fwd /= max(np.linalg.norm(fwd), _EPS)
        up = np.array([0.0, 1.0, 0.0])
        right = np.cross(fwd, up)
        right /= max(np.linalg.norm(right), _EPS)
        cam_up = np.cross(right, fwd)
        new_target = np.asarray(self.target, np.float64) + right * dx + cam_up * dy
        return dataclasses.replace(self, target=tuple(new_target))

    def camera(self, device="cpu") -> Camera:
        return Camera.create(
            position=tuple(self.position),
            look_at=tuple(self.target),
            fov=self.fov,
            focal_distance=self.focal_distance,
            aperture=self.aperture,
            device=device,
        )
