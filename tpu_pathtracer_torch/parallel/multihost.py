"""Process-group set-up and host-side IO helpers for the sharded steps.

The port of `tpu_pathtracer.parallel.multihost` on `torch.distributed`.
Every rank must

  1. call `initialize()` (under torchrun its arguments come from the
     environment: WORLD_SIZE, RANK, MASTER_ADDR, MASTER_PORT),
  2. build the same meshes in the same order (`mesh.make_mesh`),
  3. hold the same scene and parameters (`replicate` broadcasts rank 0's),
  4. take its rows of a full-size target (`host_local_target`) and hand
     back its rows of a result (`fetch_rows`).

A rank's device is the card `LOCAL_RANK % device_count`, so several ranks
may share one card; `initialize` then picks gloo, since NCCL refuses two
ranks on one device.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist


def rank_device(device=None) -> torch.device:
    """The device this rank renders on: `device` as given, except that a
    CUDA device without an index (the default, "cuda") becomes the card
    `LOCAL_RANK % torch.cuda.device_count()`."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and device.index is None and torch.cuda.is_available():
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0"))
                              % torch.cuda.device_count())
    return device


def initialize(backend: Optional[str] = None, init_method: Optional[str] = None,
               world_size: Optional[int] = None, rank: Optional[int] = None,
               device=None) -> None:
    """Join the default process group; a no-op once it exists.  Arguments
    not given come from torchrun's environment (WORLD_SIZE, RANK, and
    init_method "env://", which reads MASTER_ADDR and MASTER_PORT).  The
    back end follows the rank's `device` (`rank_device`): NCCL on a card
    of its own, gloo on the CPU or where this host's ranks
    (LOCAL_WORLD_SIZE) outnumber its cards, since NCCL refuses two ranks on
    one device.  An explicit `backend` is used as given.  A failed init
    raises: nothing retries on another back end."""
    if dist.is_initialized():
        return
    if world_size is None:
        if "WORLD_SIZE" not in os.environ:
            raise RuntimeError("no process group to join: run the ranks under torchrun, or "
                               "pass world_size, rank and init_method")
        world_size = int(os.environ["WORLD_SIZE"])
    if rank is None:
        rank = int(os.environ.get("RANK", "0"))
    if backend is None:
        backend = "nccl" if _own_card(device) else "gloo"
    kwargs = {}
    if backend == "nccl":
        device = rank_device(device)
        torch.cuda.set_device(device)
        kwargs["device_id"] = device  # set up the communicator now, so a failure raises here
    dist.init_process_group(backend, init_method=init_method or "env://",
                            world_size=world_size, rank=rank, **kwargs)


def _own_card(device) -> bool:
    """Whether the rank renders on a card that no other rank of this host shares."""
    local_ranks = int(os.environ.get("LOCAL_WORLD_SIZE", "1"))
    return (torch.device("cuda" if device is None else device).type == "cuda"
            and torch.cuda.is_available() and local_ranks <= torch.cuda.device_count())


def is_multihost() -> bool:
    return dist.is_initialized() and dist.get_world_size() > 1


def replicate(mesh, tree):
    """Rank 0's copy of every tensor leaf of a dataclass tree (SceneData,
    RenderParams, Camera), broadcast over the mesh and placed on its
    device; other leaves (the frame number) are kept.  Every rank of the
    mesh passes a tree of the same shapes."""
    from ..diff.api import _map_leaves

    def one(x):
        if not torch.is_tensor(x):
            return x
        x = x.to(mesh.device).contiguous().clone()
        if mesh.group is not None:
            dist.broadcast(x, src=0, group=mesh.group)
        return x

    return _map_leaves(tree, one)


def host_local_target(mesh, target, sharding: Optional[slice] = None) -> torch.Tensor:
    """This rank's rows (`sharding`, default `diffshard.target_sharding`)
    of a full-size (H, W, 3) numpy target, on the mesh's device: only they
    are uploaded."""
    from .diffshard import target_sharding

    target = np.asarray(target)
    rows = sharding if sharding is not None else target_sharding(mesh, target.shape[0])
    return torch.from_numpy(np.ascontiguousarray(target[rows])).to(mesh.device)


def fetch_rows(mesh, band: torch.Tensor) -> tuple:
    """This rank's band of a row-sharded (H, W, 3) array, on the host:
    (present, a bool mask over H of the rows it owns; data, (H, W, 3) with
    every other row zero)."""
    from .sharded import acc_sharding

    band = band.detach().cpu().numpy()
    height = band.shape[0] * mesh.tiles
    rows = acc_sharding(mesh, height)
    present = np.zeros((height,), bool)
    data = np.zeros((height,) + band.shape[1:], band.dtype)
    present[rows] = True
    data[rows] = band
    return present, data
