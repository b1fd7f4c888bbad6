"""Multi-rank runs of the sharded steps on one machine.

`dryrun_multichip(n)` is the twin of the JAX package's
`__graft_entry__.dryrun_multichip`: it spawns n gloo ranks on the CPU; each
runs one sharded progressive step over a (n / 2, 2) mesh (samples 2 when n
is even) and one sharded `value_and_grad` over n tiles:

    python -m tpu_pathtracer_torch.parallel.dryrun 4

`run` spawns the ranks of any suite (a module-level function spec -> dict
of arrays) through `worker`, with a time limit, and returns each rank's
results.  Nothing here imports JAX, so a spawned rank imports only torch,
numpy, this package and the suite's own module.
"""

from __future__ import annotations

import math
import os
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from . import multihost
from .diffshard import make_sharded_value_and_grad
from .mesh import make_mesh
from .sharded import assemble, make_sharded_frame_step, zeros_acc

CAMERA = dict(position=(0.0, 1.0, 4.0), look_at=(0.0, 0.5, 0.0), fov=45.0)


def worker(rank: int, world: int, store: str, out: str, suite, spec: dict) -> None:
    """One rank: join a gloo (or `spec["backend"]`) group of `world` ranks
    through the file `store`, run `suite(spec)` and save its arrays as
    `out`/rank<rank>.npz.  `spec["env"]` is set in the environment first
    (e.g. TPT_SORT_WINDOW)."""
    os.environ.update(spec.get("env", {}))
    torch.set_num_threads(1)
    multihost.initialize(spec.get("backend", "gloo"), f"file://{store}", world, rank)
    try:
        np.savez(os.path.join(out, f"rank{rank}.npz"), **suite(spec))
    finally:
        dist.destroy_process_group()


def run(suite, world: int, spec: dict, out, timeout: float = 120.0) -> list:
    """Spawn `world` ranks of `suite` (see `worker`) and wait at most
    `timeout` seconds; returns each rank's results, rank 0 first.  A rank
    that raises, dies or outlasts the limit raises here, and every rank
    still running is killed."""
    out = Path(out)
    out.mkdir(parents=True, exist_ok=True)
    store = out / "store"
    if store.exists():
        store.unlink()
    ctx = torch.multiprocessing.start_processes(
        worker, args=(world, str(store), str(out), suite, spec), nprocs=world, join=False,
        start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=max(0.1, deadline - time.monotonic())):
            if time.monotonic() >= deadline:
                raise TimeoutError(f"{world} ranks did not finish within {timeout:.0f} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join(10)
    return [dict(np.load(out / f"rank{r}.npz")) for r in range(world)]


def tiny_scene(device="cpu"):
    """The default scene under a 16x32 gradient sky, compiled, and the
    default camera (the JAX twin's `_tiny_scene`)."""
    import tpu_pathtracer_torch as pt
    from tpu_pathtracer_torch.scene.envmap import gradient_sky

    return (pt.default_scene(gradient_sky(16, 32)).compile(device=device),
            pt.Camera.create(**CAMERA, device=device))


def dryrun_body(n: int, device="cpu") -> dict:
    """What each rank of `dryrun_multichip(n)` runs: one sharded step over
    a (n / samples, samples) mesh and one sharded value_and_grad over n
    tiles, each checked finite."""
    from tpu_pathtracer_torch import diff
    from tpu_pathtracer_torch.scene.types import RenderParams

    samples = 2 if n % 2 == 0 and n > 1 else 1
    tiles = n // samples
    mesh = make_mesh(tiles=tiles, samples=samples, device=device)
    height, width = 4 * tiles, 16
    scene, cam = tiny_scene(device)
    step = make_sharded_frame_step(mesh, width=width, height=height, aspect=width / height,
                                   samples_per_frame=samples, max_bounces=2)
    params = RenderParams.create(cam, frame=1)
    img = assemble(mesh, step(scene, params, zeros_acc(mesh, height, width)), height)
    if img.shape != (height, width, 3) or not bool(torch.isfinite(img).all()):
        raise RuntimeError(f"sharded step gave {tuple(img.shape)}, finite "
                           f"{bool(torch.isfinite(img).all())}")
    tile_mesh = make_mesh(tiles=n, samples=1, device=device)
    vg = make_sharded_value_and_grad(tile_mesh, scene, params, width=width, height=height,
                                     aspect=width / height, samples_per_frame=1, max_bounces=2)
    loss, grads = vg(diff.extract(scene, params, ["materials.color"]), img)
    g = grads["materials.color"]
    if not (math.isfinite(float(loss)) and bool(torch.isfinite(g).all())):
        raise RuntimeError(f"sharded value_and_grad not finite: loss {float(loss)}")
    return {"dryrun_mesh": np.array([tiles, samples]), "dryrun_image": img.cpu().numpy(),
            "dryrun_loss": np.float32(float(loss)), "dryrun_grad": g.cpu().numpy()}


def dryrun_suite(spec: dict) -> dict:
    return dryrun_body(dist.get_world_size(), spec.get("device", "cpu"))


def dryrun_multichip(n_devices: int, timeout: float = 300.0) -> None:
    """Spawn `n_devices` gloo ranks on the CPU and run `dryrun_body` on
    each; prints rank 0's summary."""
    with tempfile.TemporaryDirectory() as tmp:
        r0 = run(dryrun_suite, n_devices, {"device": "cpu"}, tmp, timeout)[0]
    tiles, samples = (int(x) for x in r0["dryrun_mesh"])
    img = r0["dryrun_image"]
    print(f"dryrun_multichip ok: mesh=({tiles}x{samples}) image={img.shape} "
          f"mean={img.mean():.4f} train_loss={float(r0['dryrun_loss']):.5f} "
          f"grad_norm={np.linalg.norm(r0['dryrun_grad']):.3e}")


if __name__ == "__main__":
    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 4)
