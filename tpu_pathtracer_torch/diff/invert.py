"""Inverse rendering: recover scene or camera parameters from a target
image by gradient descent on the differentiable render (BASELINE.json
configs[4]).  The port of `tpu_pathtracer.diff.invert`, with
`torch.optim.Adam` in place of `optax.adam` (the same defaults: betas
0.9 / 0.999, eps 1e-8)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, Iterable, List, Optional

import torch

from ..scene.types import RenderParams, SceneData
from . import api


@dataclass
class InvertResult:
    values: Dict[str, torch.Tensor]
    losses: List[float] = field(default_factory=list)

    @property
    def final_loss(self) -> float:
        return self.losses[-1]


def invert(
    scene: SceneData,
    params: RenderParams,
    target,
    paths: Iterable[str],
    *,
    width: int,
    height: int,
    aspect: float,
    samples_per_frame: int = 1,
    max_bounces: int = 2,
    steps: int = 100,
    learning_rate: float = 5e-2,
    optimizer: Optional[Callable[[list], torch.optim.Optimizer]] = None,
    plain: bool = False,
) -> InvertResult:
    """Gradient-descent recovery of the named leaves (e.g. 'materials.color',
    'env.radiance', 'camera.position') from `target` (H, W, 3).

    `optimizer` is a factory from the list of leaf tensors to a
    `torch.optim.Optimizer`; the default is Adam at `learning_rate`.  The
    per-frame RNG stream is fixed by `params.frame`, so the loss is
    deterministic.  `losses[i]` is the loss before update i, read on the
    host once per step.  `plain=True` intersects through the kernels'
    plain versions."""
    loss = api.make_loss(
        target, width=width, height=height, aspect=aspect,
        samples_per_frame=samples_per_frame, max_bounces=max_bounces, plain=plain,
    )
    loss_p = api.make_param_loss(loss, scene, params, paths)
    values = {k: v.detach().clone().requires_grad_(True)
              for k, v in api.extract(scene, params, paths).items()}
    make_opt = optimizer if optimizer is not None else (
        lambda leaves: torch.optim.Adam(leaves, lr=learning_rate))
    opt = make_opt(list(values.values()))

    losses = []
    for _ in range(steps):
        opt.zero_grad(set_to_none=True)
        value = loss_p(values)
        value.backward()
        opt.step()
        losses.append(float(value.detach()))
    return InvertResult(values={k: v.detach() for k, v in values.items()}, losses=losses)
