"""Differentiable rendering API: losses and gradients with respect to the
scene and the camera.

The port of `tpu_pathtracer.diff.api`.  The frame runs with
`differentiable=True` (`ops.trace.trace_rays`): the intersector (an MT
kernel, the MT oracle or a BVH walk; `intersector` as in `render_frame`)
picks the triangles on detached inputs and their (t, u, v) are replayed
analytically (`ops.intersect.replay_hit`), so torch autograd differentiates
the frame with the discrete decisions (specular-vs-diffuse, visibility)
held fixed.  The intersectors have no backward pass and need none.  RNG streams are integer
and identical in every evaluation, so the loss is a deterministic function
of the leaves.

Differentiable leaves: every float field of `Materials`, `env.radiance`,
the `Camera` fields, `env_intensity` / `env_rotation`, and the packed
vertex rows `packed.tri_pos`.  The BVH's float leaves (`bvh.node_min`,
`links.node_max`, `packed.nodes`, `packed.fat_nodes`, ...) only steer the
detached walks, so their gradient is zero, as in the JAX package.  Leaves
are named by their attribute path, e.g. "materials.color",
"camera.position".
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Iterable

import torch

from ..ops.trace import render_frame
from ..scene.types import RenderParams, SceneData


def render_frame_diff(scene, params, *, width: int, height: int, aspect: float,
                      samples_per_frame: int = 1, max_bounces: int = 4,
                      env_importance: bool = False, intersector: str = "auto",
                      row_offset: int = 0, full_height: int | None = None,
                      plain: bool = False):
    """`ops.trace.render_frame` with the differentiable intersect path.
    `row_offset` / `full_height` render one row band of a taller image
    (`parallel.diffshard`).  `plain=True` intersects through the MT
    kernels' plain versions."""
    return render_frame(
        scene, params, width=width, height=height, aspect=aspect,
        samples_per_frame=samples_per_frame, max_bounces=max_bounces,
        env_importance=env_importance, differentiable=True, intersector=intersector,
        row_offset=row_offset, full_height=full_height, plain=plain,
    )


def l2_image_loss(img, target):
    return 0.5 * torch.mean((img - target) ** 2)


def make_loss(target, *, width: int, height: int, aspect: float,
              samples_per_frame: int = 1, max_bounces: int = 4,
              loss_fn: Callable = l2_image_loss, intersector: str = "auto",
              plain: bool = False):
    """loss(scene, params) -> scalar tensor, differentiable with respect to
    the float leaves of both."""

    def loss(scene: SceneData, params: RenderParams):
        img = render_frame_diff(
            scene, params, width=width, height=height, aspect=aspect,
            samples_per_frame=samples_per_frame, max_bounces=max_bounces,
            intersector=intersector, plain=plain,
        )
        return loss_fn(img, target)

    return loss


def _map_leaves(obj, fn):
    """A copy of a dataclass tree with `fn` applied to every leaf, in field
    order."""
    if dataclasses.is_dataclass(obj):
        return dataclasses.replace(obj, **{
            f.name: _map_leaves(getattr(obj, f.name), fn) for f in dataclasses.fields(obj)})
    return fn(obj)


def _is_float(x) -> bool:
    return isinstance(x, torch.Tensor) and x.is_floating_point()


def grads(loss, scene, params):
    """(d loss/d scene, d loss/d params): copies of the two dataclass trees
    whose float leaves hold the gradients (zeros for leaves the loss does
    not depend on) and whose integer leaves (material indices, `tri_perm`,
    `frame`) are None, the counterpart of the float0 zeros of the JAX
    package."""
    tracked = []

    def track(x):
        if not _is_float(x):
            return x
        tracked.append(x.detach().requires_grad_(True))
        return tracked[-1]

    value = loss(_map_leaves(scene, track), _map_leaves(params, track))
    found = iter(torch.autograd.grad(value, tracked, allow_unused=True))

    def gradient(x):
        if not _is_float(x):
            return None
        g = next(found)
        return torch.zeros_like(x) if g is None else g

    return _map_leaves(scene, gradient), _map_leaves(params, gradient)


# --------------------------------------------------------------------------
# Named-leaf optimisation helpers: optimise a flat {path: tensor} dict of
# scene / param leaves (e.g. "materials.color", "env.radiance",
# "camera.position") without dragging integer leaves through the optimiser.
# --------------------------------------------------------------------------


def get_leaf(obj, path: str):
    for part in path.split("."):
        obj = getattr(obj, part)
    return obj


def set_leaf(obj, path: str, value):
    """Functional deep-replace along a dataclass attribute path."""
    parts = path.split(".")
    if len(parts) == 1:
        return dataclasses.replace(obj, **{parts[0]: value})
    child = getattr(obj, parts[0])
    return dataclasses.replace(obj, **{parts[0]: set_leaf(child, ".".join(parts[1:]), value)})


_PARAM_PATHS = ("camera", "env_intensity", "env_rotation", "frame")


def _is_param_path(path: str) -> bool:
    return path.split(".")[0] in _PARAM_PATHS


def extract(scene: SceneData, params: RenderParams, paths: Iterable[str]) -> dict:
    """Pull the named leaves into a flat dict."""
    return {p: get_leaf(params if _is_param_path(p) else scene, p) for p in paths}


def insert(scene: SceneData, params: RenderParams, values: dict):
    """Write a flat dict of leaves back into (scene, params)."""
    for p, v in values.items():
        if _is_param_path(p):
            params = set_leaf(params, p, v)
        else:
            scene = set_leaf(scene, p, v)
    return scene, params


def make_param_loss(loss, scene: SceneData, params: RenderParams, paths: Iterable[str]):
    """Close `loss(scene, params)` over everything except the named leaves:
    returns loss_p(values_dict), whose gradient with respect to the dict's
    tensors autograd computes."""
    def loss_p(values: dict):
        s, p = insert(scene, params, values)
        return loss(s, p)

    return loss_p
