"""Sharded progressive rendering over the ('tiles', 'samples') mesh.

The port of `tpu_pathtracer.parallel.sharded` on `torch.distributed`: each
rank renders its row band (`tiles`) of its share of the frame's samples
(`samples`) through `ops.trace.render_frame`, so every kernel of the frame
runs on its band; the sample shards' radiance is averaged by an all-reduce
over the sample axis, and each rank folds the result into its band of the
accumulation, which stays where it is across frames.  `assemble` builds
the whole image when it is read.

Exactness, as in JAX:
  * tile sharding gives the unsharded frame: pixel seeds, uv and the AA
    resolution are taken in global coordinates (`render_frame`'s
    `row_offset`, `full_height`).  Through the plain loop the bands put
    together equal the unsharded frame bit for bit; through the fused loop
    too, except where a near-tie in t (`ops/pallas/mt_shade.py:29-33` of
    the JAX package) falls another way because other rays share a ray
    tile;
  * sample shard 0 keeps the unsharded RNG stream, shards 1..S-1 add the
    Weyl salt si * 0x9E3779B9 to every pixel seed: an equally valid
    Monte Carlo estimate with the same samples a frame, not the
    sequential one bit for bit.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from ..ops.trace import accumulate as accumulate_op
from ..ops.trace import render_frame

# Weyl sequence increment (2^32 / golden ratio, odd): decorrelates the
# sample axis's RNG streams and leaves shard 0 on the reference stream.
_SALT = 0x9E3779B9


def acc_sharding(mesh, height: int) -> slice:
    """The rows of an (H, W, 3) image that this rank's tile holds (every
    sample shard of a tile holds the same rows); none outside the mesh."""
    if not mesh.in_mesh:
        return slice(0, 0)
    rows = height // mesh.tiles
    return slice(mesh.tile_index * rows, (mesh.tile_index + 1) * rows)


def zeros_acc(mesh, height: int, width: int) -> torch.Tensor:
    """This rank's band of a zero accumulation: (height / tiles, W, 3)."""
    return torch.zeros((height // mesh.tiles, width, 3), dtype=torch.float32,
                       device=mesh.device)


def assemble(mesh, band: torch.Tensor, height: int) -> torch.Tensor:
    """The whole (H, W, 3) image on every rank of the mesh, from each
    tile's band: an all-reduce (sum) of a zero image into which only sample
    shard 0 of each tile writes its band, exact since x + 0 == x."""
    full = torch.zeros((height,) + tuple(band.shape[1:]), dtype=band.dtype, device=band.device)
    if mesh.sample_index == 0:
        full[acc_sharding(mesh, height)] = band
    if mesh.size > 1:
        dist.all_reduce(full, group=mesh.group)
    return full


def _check(mesh, height: int, samples_per_frame: int) -> None:
    if height % mesh.tiles != 0:
        raise ValueError(f"height {height} must divide by tile axis {mesh.tiles}")
    if samples_per_frame % mesh.samples != 0:
        raise ValueError(f"samples_per_frame {samples_per_frame} must divide by sample "
                         f"axis {mesh.samples}")
    if not mesh.in_mesh:
        raise ValueError(f"rank {mesh.rank} is outside the {mesh.tiles}x{mesh.samples} mesh")


def shard_frame(scene, params, *, tile: int, sample: int, tiles: int, samples: int,
                width: int, height: int, aspect: float, samples_per_frame: int = 1,
                max_bounces: int = 4, env_importance: bool = False,
                intersector: str = "auto", blue_noise=None) -> torch.Tensor:
    """What mesh position (tile, sample) renders before the sample axis is
    reduced: rows [tile * rows, (tile + 1) * rows) of the frame, rows =
    height / tiles, at samples_per_frame / samples samples, with sample
    shard `sample`'s seed salt (none on a mesh of one sample shard)."""
    rows = height // tiles
    salt = (sample * _SALT) & 0xFFFFFFFF if samples > 1 else None
    return render_frame(
        scene, params, width=width, height=rows, aspect=aspect,
        samples_per_frame=samples_per_frame // samples, max_bounces=max_bounces,
        env_importance=env_importance, intersector=intersector, blue_noise=blue_noise,
        row_offset=tile * rows, full_height=height, seed_salt=salt,
    )


def make_sharded_passes(mesh, *, width: int, height: int, aspect: float,
                        samples_per_frame: int = 1, max_bounces: int = 4,
                        accumulate: bool = True, env_importance: bool = False,
                        intersector: str = "auto", blue_noise=None):
    """The sharded frame's two passes, for per-pass timing:
    raytrace(scene, params) -> this rank's band of the frame (the mean over
    the sample axis), and acc(acc, img, frame) -> acc, folding the band into
    this rank's band of the accumulation in place."""
    _check(mesh, height, samples_per_frame)

    def raytrace(scene, params) -> torch.Tensor:
        img = shard_frame(
            scene, params, tile=mesh.tile_index, sample=mesh.sample_index, tiles=mesh.tiles,
            samples=mesh.samples, width=width, height=height, aspect=aspect,
            samples_per_frame=samples_per_frame, max_bounces=max_bounces,
            env_importance=env_importance, intersector=intersector, blue_noise=blue_noise)
        if mesh.samples > 1:
            # each shard holds the mean of its samples: the mean of the
            # shards is their sum over the sample axis / S
            dist.all_reduce(img, group=mesh.sample_group)
            img = img / float(np.float32(mesh.samples))
        return img

    def acc_fn(acc: torch.Tensor, img: torch.Tensor, frame: int) -> torch.Tensor:
        return accumulate_op(acc, img, frame, enabled=accumulate, out=acc)

    return raytrace, acc_fn


def make_sharded_frame_step(mesh, *, width: int, height: int, aspect: float,
                            samples_per_frame: int = 1, max_bounces: int = 4,
                            accumulate: bool = True, env_importance: bool = False,
                            intersector: str = "auto", blue_noise=None):
    """The sharded progressive step: step(scene, params, acc) -> acc, where
    acc is this rank's band (`zeros_acc`), updated in place; scene and
    params are the same on every rank (`multihost.replicate`)."""
    raytrace, acc_fn = make_sharded_passes(
        mesh, width=width, height=height, aspect=aspect, samples_per_frame=samples_per_frame,
        max_bounces=max_bounces, accumulate=accumulate, env_importance=env_importance,
        intersector=intersector, blue_noise=blue_noise)

    def step(scene, params, acc: torch.Tensor) -> torch.Tensor:
        return acc_fn(acc, raytrace(scene, params), params.frame)

    return step


def make_sharded_render_all(mesh, *, width: int, height: int, aspect: float,
                            frames: int = 64, samples_per_frame: int = 1,
                            max_bounces: int = 4, accumulate: bool = True,
                            env_importance: bool = False, intersector: str = "auto",
                            blue_noise=None):
    """The whole progressive budget: render_all(scene, params0,
    n_frames=frames) -> this rank's band of the accumulation of frames
    1..n_frames (params0's frame is ignored, as in JAX).  The frames run one
    by one: the port has no fori_loop to put them in."""
    step = make_sharded_frame_step(
        mesh, width=width, height=height, aspect=aspect, samples_per_frame=samples_per_frame,
        max_bounces=max_bounces, accumulate=accumulate, env_importance=env_importance,
        intersector=intersector, blue_noise=blue_noise)

    def render_all(scene, params0, n_frames=None) -> torch.Tensor:
        acc = zeros_acc(mesh, height, width)
        for f in range(frames if n_frames is None else int(n_frames)):
            step(scene, dataclasses.replace(params0, frame=f + 1), acc)
        return acc

    return render_all
