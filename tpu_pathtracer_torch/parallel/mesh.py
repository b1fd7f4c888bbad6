"""The ('tiles', 'samples') mesh of the sharded render and training steps.

The port of `tpu_pathtracer.parallel.mesh` on `torch.distributed`, one rank
per mesh position (SPMD): where JAX lays a `Mesh` over devices and runs one
`shard_map` program, every rank of the default process group runs the same
Python and talks to the others by collectives.  The axes are

  * ``tiles``   -- the image's row bands: rank r renders band r // samples;
  * ``samples`` -- the per-frame sample budget: rank r renders sample shard
    r % samples with a decorrelated RNG stream, and the shards' radiance is
    averaged by an all-reduce,

the grid of JAX's ``devices.reshape(tiles, samples)``.  A mesh covers the
first tiles * samples ranks; the ranks above it are outside and do no work.
Only `all_reduce` and `broadcast` run over its groups, the two collectives
gloo also runs on CUDA tensors, so one code path serves gloo on the CPU,
gloo with several ranks sharing one card, and NCCL with a rank a card.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
import torch.distributed as dist

from .multihost import rank_device

AXIS_TILES = "tiles"
AXIS_SAMPLES = "samples"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's view of a (tiles, samples) mesh.  `group` holds every
    rank of the mesh, `tile_group` the ranks of this rank's sample index
    (one a tile), `sample_group` those of its tile index (one a sample
    shard); a group is None where its axis has one rank and nothing is
    reduced over it."""

    tiles: int
    samples: int
    rank: int = 0
    device: torch.device = torch.device("cpu")
    group: Any = None
    tile_group: Any = None
    sample_group: Any = None

    @property
    def shape(self) -> dict:
        return {AXIS_TILES: self.tiles, AXIS_SAMPLES: self.samples}

    @property
    def size(self) -> int:
        return self.tiles * self.samples

    @property
    def in_mesh(self) -> bool:
        return self.rank < self.size

    @property
    def tile_index(self) -> int:
        return self.rank // self.samples

    @property
    def sample_index(self) -> int:
        return self.rank % self.samples


def _world() -> tuple:
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def make_mesh(tiles: Optional[int] = None, samples: int = 1, device=None) -> Mesh:
    """Build a (tiles, samples) mesh over the first tiles * samples ranks
    of the default process group; every rank must call it, in the same
    order as its other `make_mesh` calls, since it creates the axes' groups
    (`dist.new_group`).  With `tiles=None` the whole world goes to the tile
    axis.  A (1, 1) mesh needs no process group: every sharded function on
    it is the unsharded one.  `device` is the rank's device
    (`multihost.rank_device`: the card `LOCAL_RANK % device_count` unless
    the caller names another)."""
    world, rank = _world()
    if tiles is None:
        if world % samples != 0:
            raise ValueError(f"{world} ranks do not divide into samples={samples}")
        tiles = world // samples
    n = tiles * samples
    if n > world:
        raise ValueError(f"mesh ({tiles}x{samples}) needs {n} ranks, have {world}"
                         + ("" if world > 1 else ": start the ranks under torchrun and call "
                            "parallel.multihost.initialize()"))
    device = rank_device(device)
    if n == 1:
        return Mesh(1, 1, rank, device)
    group = dist.group.WORLD if n == world else dist.new_group(list(range(n)))
    tile_group = sample_group = None
    if tiles > 1:
        for s in range(samples):
            g = dist.new_group([t * samples + s for t in range(tiles)])
            if rank < n and rank % samples == s:
                tile_group = g
    if samples > 1:
        for t in range(tiles):
            g = dist.new_group([t * samples + s for s in range(samples)])
            if rank < n and rank // samples == t:
                sample_group = g
    return Mesh(tiles, samples, rank, device, group, tile_group, sample_group)


def single_device_mesh(device=None) -> Mesh:
    return make_mesh(tiles=1, samples=1, device=device)
