"""Sharded differentiable rendering: data-parallel gradients over the mesh.

The port of `tpu_pathtracer.parallel.diffshard` on `torch.distributed`.
The image loss shards by row bands over the 'tiles' axis: each rank renders
its band through the differentiable frame, takes its share of the global
loss, 0.5 * sum((band - target_band)^2) / (W * H * 3), and runs the backward
on it; then one all-reduce (sum) over the tiles, of the loss and every
gradient packed into one buffer, gives each rank the global loss and
gradients.  That is the one reduction: DDP would average over the ranks, and
a second reduction would count every gradient `tiles` times (the double
count JAX caught, docs/DESIGN_NOTES.md:124-128).

The sums decompose exactly over the bands (global pixel coordinates and
seeds), so the sharded loss and gradients equal the unsharded ones up to
the order of the float sums, and an optimizer behaves the same at any mesh
size.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from ..diff import api as diff_api
from .sharded import acc_sharding


def target_sharding(mesh, height: int) -> slice:
    """The rows of the (H, W, 3) target that this rank's tile renders."""
    return acc_sharding(mesh, height)


def make_sharded_value_and_grad(mesh, scene, params, *, width: int, height: int, aspect: float,
                                samples_per_frame: int = 1, max_bounces: int = 2):
    """Build f(values, target) -> (loss, grads): `values` is a flat {path:
    tensor} dict (`diff.api.extract`), whose keys name the leaves
    differentiated; `target` is the whole (H, W, 3) image or this rank's
    rows of it (`target_sharding`).  The loss is 0.5 * mean((img -
    target)^2), as `diff.api.l2_image_loss`; loss and grads are the global
    ones, the same on every rank."""
    tiles = mesh.tiles
    if height % tiles != 0:
        raise ValueError(f"height {height} must divide by tile axis {tiles}")
    if not mesh.in_mesh:
        raise ValueError(f"rank {mesh.rank} is outside the {tiles}x{mesh.samples} mesh")
    rows = height // tiles
    band = target_sharding(mesh, height)
    denom = float(np.float32(width * height * 3))

    def f(values: dict, target: torch.Tensor):
        target_band = target[band] if target.shape[0] == height else target
        leaves = {k: v.detach().requires_grad_(True) for k, v in values.items()}
        s, p = diff_api.insert(scene, params, leaves)
        img = diff_api.render_frame_diff(
            s, p, width=width, height=rows, aspect=aspect, samples_per_frame=samples_per_frame,
            max_bounces=max_bounces, row_offset=band.start, full_height=height)
        loss = 0.5 * torch.sum((img - target_band.detach()) ** 2) / denom
        found = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
        grads = [torch.zeros_like(v) if g is None else g for v, g in zip(leaves.values(), found)]
        flat = torch.cat([loss.detach().reshape(1)] + [g.reshape(-1) for g in grads])
        if tiles > 1:
            dist.all_reduce(flat, group=mesh.tile_group)
        out, at = {}, 1
        for k, g in zip(leaves, grads):
            out[k] = flat[at:at + g.numel()].view_as(g)
            at += g.numel()
        return flat[0], out

    return f


def invert_sharded(mesh, scene, params, target, paths, *, width: int, height: int,
                   aspect: float, samples_per_frame: int = 1, max_bounces: int = 2,
                   steps: int = 100, learning_rate: float = 5e-2):
    """`diff.invert` with the render and backward sharded over the mesh:
    torch.optim.Adam at `learning_rate` on the reduced gradients, the same
    on every rank, so the ranks' values stay equal."""
    from ..diff.invert import InvertResult

    vg = make_sharded_value_and_grad(
        mesh, scene, params, width=width, height=height, aspect=aspect,
        samples_per_frame=samples_per_frame, max_bounces=max_bounces)
    target = torch.as_tensor(target).to(mesh.device)[target_sharding(mesh, height)]
    values = {k: v.detach().clone().requires_grad_(True)
              for k, v in diff_api.extract(scene, params, paths).items()}
    opt = torch.optim.Adam(list(values.values()), lr=learning_rate)
    losses = []
    for _ in range(steps):
        loss, grads = vg(values, target)
        for k, v in values.items():
            v.grad = grads[k]
        opt.step()
        losses.append(float(loss))
    return InvertResult(values={k: v.detach() for k, v in values.items()}, losses=losses)
