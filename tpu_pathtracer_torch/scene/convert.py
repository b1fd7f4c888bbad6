"""Carry a compiled scene and per-frame parameters across from numpy.

`tpu_pathtracer` compiles its scene into JAX pytrees.  The two functions
here take the leaves of such a pytree as numpy arrays, keyed by their field
path ("packed.tri_pos", "env.radiance", "camera.fov", ...), and return the
port's dataclasses, so that both packages can trace byte-identical inputs.
Keys the port has no field for (the JAX scene's `bvh.*`, `links.*`,
`packed.nodes`, `packed.fat_nodes`) are ignored.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np
import torch

from .types import (
    Camera,
    EnvironmentMap,
    Materials,
    PackedGeometry,
    RenderParams,
    SceneData,
    Triangles,
)


def _build(cls, arrays: Mapping[str, np.ndarray], prefix: str, device):
    return cls(**{
        f.name: torch.from_numpy(np.array(arrays[f"{prefix}.{f.name}"])).to(device)
        for f in dataclasses.fields(cls)
    })


def scene_from_numpy(arrays: Mapping[str, np.ndarray], device="cpu") -> SceneData:
    """`SceneData` on `device` from numpy leaves keyed "group.field"."""
    return SceneData(
        triangles=_build(Triangles, arrays, "triangles", device),
        materials=_build(Materials, arrays, "materials", device),
        packed=_build(PackedGeometry, arrays, "packed", device),
        env=_build(EnvironmentMap, arrays, "env", device),
    )


def params_from_numpy(arrays: Mapping[str, np.ndarray], device="cpu") -> RenderParams:
    """`RenderParams` on `device` from numpy leaves keyed "camera.position",
    ..., "frame", "env_intensity", "env_rotation"."""
    f32 = lambda key: torch.tensor(np.float32(arrays[key]), device=device)
    return RenderParams(
        camera=_build(Camera, arrays, "camera", device),
        frame=int(np.asarray(arrays["frame"])),
        env_intensity=f32("env_intensity"),
        env_rotation=f32("env_rotation"),
    )
