"""Carry a compiled scene and per-frame parameters across from numpy.

`tpu_pathtracer` compiles its scene into JAX pytrees.  The two functions
here take the leaves of such a pytree as numpy arrays, keyed by their field
path ("packed.tri_pos", "env.radiance", "camera.fov", ...), and return the
port's dataclasses, so that both packages can trace byte-identical inputs.
Keys the port has no field for (the JAX scene's `bvh.*`, `links.*`,
`packed.nodes`, `packed.fat_nodes`) are ignored.  `values_to_numpy` and
`leaves_to_numpy` carry results back the other way (the port's
`diff.extract` dicts and the gradient trees of `diff.grads`), keyed by the
same paths, so they can be compared leaf by leaf.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Optional

import numpy as np
import torch

from .types import (
    Camera,
    EnvironmentMap,
    FlatBVH,
    LinkedBVH,
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


def scene_from_numpy(arrays: Mapping[str, np.ndarray], device="cuda") -> SceneData:
    """`SceneData` on `device` (the card unless the caller asks for
    another) from numpy leaves keyed "group.field"."""
    return SceneData(
        triangles=_build(Triangles, arrays, "triangles", device),
        materials=_build(Materials, arrays, "materials", device),
        bvh=_build(FlatBVH, arrays, "bvh", device),
        links=_build(LinkedBVH, arrays, "links", device),
        packed=_build(PackedGeometry, arrays, "packed", device),
        env=_build(EnvironmentMap, arrays, "env", device),
    )


def params_from_numpy(arrays: Mapping[str, np.ndarray], device="cuda") -> RenderParams:
    """`RenderParams` on `device` (the card unless the caller asks for
    another) from numpy leaves keyed "camera.position", ..., "frame",
    "env_intensity", "env_rotation"."""
    f32 = lambda key: torch.tensor(np.float32(arrays[key]), device=device)
    return RenderParams(
        camera=_build(Camera, arrays, "camera", device),
        frame=int(np.asarray(arrays["frame"])),
        env_intensity=f32("env_intensity"),
        env_rotation=f32("env_rotation"),
    )


def _to_numpy(x) -> Optional[np.ndarray]:
    if x is None:
        return None
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def values_to_numpy(values: Mapping[str, Optional[torch.Tensor]]) -> dict:
    """A dict of tensors keyed by field path (the port's `diff.extract`
    dict, or an optimiser's result) as numpy arrays under the same keys;
    None stays None."""
    return {path: _to_numpy(x) for path, x in values.items()}


def leaves_to_numpy(tree, prefix: str = "") -> dict:
    """Every leaf of a scene or params dataclass tree (or of the gradient
    trees `diff.grads` returns) as numpy, keyed "group.field" as
    `scene_from_numpy` reads them; None leaves stay None."""
    out = {}
    for f in dataclasses.fields(tree):
        value = getattr(tree, f.name)
        path = f"{prefix}{f.name}"
        if dataclasses.is_dataclass(value):
            out.update(leaves_to_numpy(value, path + "."))
        else:
            out[path] = _to_numpy(value)
    return out
