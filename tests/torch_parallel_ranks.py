"""The rank side of tests/test_torch_parallel_dist.py: the suite that each
of the 4 spawned gloo ranks runs (`parallel.dryrun.run` pickles
`checks_suite` by its module's name).  It imports no JAX, so a spawned rank
imports only torch, numpy and the port."""

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

import tpu_pathtracer_torch as pt
from tpu_pathtracer_torch import diff
from tpu_pathtracer_torch.parallel import dryrun, multihost
from tpu_pathtracer_torch.parallel.diffshard import (
    invert_sharded,
    make_sharded_value_and_grad,
    target_sharding,
)
from tpu_pathtracer_torch.parallel.mesh import make_mesh
from tpu_pathtracer_torch.parallel.sharded import (
    assemble,
    make_sharded_frame_step,
    make_sharded_render_all,
    zeros_acc,
)
from tpu_pathtracer_torch.render.benchmark import bench_scaling
from tpu_pathtracer_torch.scene.envmap import gradient_sky

GRAD_PATHS = ("materials.color", "env.radiance")
INVERT = dict(steps=3, learning_rate=8e-2)


def wrong_colors(scene):
    """The scene with its material colors drawn from a seeded generator:
    the start of the inverse-rendering check."""
    color = np.random.default_rng(0).random(tuple(scene.materials.color.shape))
    color = torch.from_numpy(color.astype(np.float32)).to(scene.materials.color.device)
    return dataclasses.replace(scene, materials=dataclasses.replace(scene.materials, color=color))


def checks_suite(spec: dict) -> dict:
    """The sharded paths at a small size on a world of 4 ranks, each result
    saved for the parent to hold against the unsharded functions:
    `spec` has device, width, height, bounces, env and checkpoint (the
    path rank 0 writes a checkpoint to)."""
    device, width, height = spec["device"], spec["width"], spec["height"]
    kw = dict(width=width, height=height, aspect=width / height, max_bounces=spec["bounces"])
    scene, cam = dryrun.tiny_scene(device)
    params = pt.RenderParams.create(cam, frame=1)
    res = {"rank": np.int64(dist.get_rank())}

    mesh41 = make_mesh(tiles=4, samples=1, device=device)
    errors = []
    for bad in (lambda: make_mesh(tiles=5, samples=1, device=device),
                lambda: make_sharded_frame_step(mesh41, width=width, height=6, aspect=1.0)):
        try:
            bad()
        except ValueError as e:
            errors.append(str(e))
    res["validation_errors"] = np.array(errors)

    mesh22 = make_mesh(tiles=2, samples=2, device=device)
    step = make_sharded_frame_step(mesh22, samples_per_frame=2, **kw)
    res["step_2x2"] = assemble(mesh22, step(scene, params, zeros_acc(mesh22, height, width)),
                               height).cpu().numpy()
    step = make_sharded_frame_step(mesh41, **kw)
    res["step_4x1"] = assemble(mesh41, step(scene, params, zeros_acc(mesh41, height, width)),
                               height).cpu().numpy()

    # value_and_grad over 4 tiles, against a target every rank renders alike
    target = diff.render_frame_diff(scene, params, **kw).detach() * 0.7
    vg = make_sharded_value_and_grad(mesh41, scene, params, **kw)
    loss, grads = vg(diff.extract(scene, params, GRAD_PATHS), target)
    res["vg_target"] = target.cpu().numpy()
    res["vg_loss"] = np.float32(float(loss))
    for path in GRAD_PATHS:
        res[f"vg_grad:{path}"] = grads[path].cpu().numpy()

    # a few sharded Adam steps from wrong colors back toward the true scene's frame
    inv = invert_sharded(mesh41, wrong_colors(scene), params,
                         diff.render_frame_diff(scene, params, **kw).detach(),
                         ["materials.color"], **INVERT, **kw)
    res["invert_losses"] = np.array(inv.losses)
    res["invert_color"] = inv.values["materials.color"].cpu().numpy()

    # the whole budget against the frames stepped one by one
    render_all = make_sharded_render_all(mesh22, frames=3, samples_per_frame=2, **kw)
    res["render_all"] = assemble(mesh22, render_all(scene, params), height).cpu().numpy()
    step = make_sharded_frame_step(mesh22, samples_per_frame=2, **kw)
    acc = zeros_acc(mesh22, height, width)
    for f in range(1, 4):
        step(scene, dataclasses.replace(params, frame=f), acc)
    res["stepwise"] = assemble(mesh22, acc, height).cpu().numpy()

    # the Renderer on a 2x2 mesh
    r = pt.Renderer(pt.default_scene(gradient_sky(16, 32)), cam,
                    pt.RenderConfig(width=width, height=height, frames=2, samples_per_frame=2,
                                    max_bounces=spec["bounces"]),
                    pt.PostConfig(denoise=False), device=device,
                    shard=pt.ShardConfig(tiles=2, samples=2))
    progress = []
    r.on("progress", progress.append)
    res["renderer_acc"] = r.render_all().cpu().numpy()
    res["renderer_progress"] = np.array(progress)
    res["renderer_display"] = r.display().cpu().numpy()

    # JAX's sharded schedule: a progress event and a checkpoint after
    # chunks of min(remaining, checkpoint_every) frames, and one at the end
    r = pt.Renderer(pt.default_scene(gradient_sky(16, 32)), cam,
                    pt.RenderConfig(width=width, height=height, frames=5, max_bounces=1),
                    pt.PostConfig(denoise=False), device=device, shard=pt.ShardConfig(tiles=4))
    progress, saved, save = [], [], r.save_state
    r.on("progress", progress.append)
    r.save_state = lambda path: (saved.append(r.frame), save(path))
    res["chunked_acc"] = r.render_all(checkpoint_path=spec["checkpoint"],
                                      checkpoint_every=2).cpu().numpy()
    res["chunked_progress"], res["chunked_saves"] = np.array(progress), np.array(saved)

    # host-side IO over the 4 tiles
    full = np.arange(height * width * 3, dtype=np.float32).reshape(height, width, 3)
    band = multihost.host_local_target(mesh41, full)
    res["fetch_present"], res["fetch_data"] = multihost.fetch_rows(mesh41, band)
    res["target_rows"] = np.array([target_sharding(mesh41, height).start,
                                   target_sharding(mesh41, height).stop])
    # each rank's own camera; replicate hands every rank rank 0's
    own = pt.Camera.create(**dict(dryrun.CAMERA, position=(float(res["rank"]), 1.0, 4.0)))
    rep = multihost.replicate(mesh41, pt.RenderParams.create(own, frame=1))
    res["replicated_position"] = rep.camera.position.cpu().numpy()

    rows = bench_scaling(scene, cam, width=16, height=16, spp=1, bounces=1,
                         tile_counts=(1, 2, 4, 8), reps=1, target_seconds=0.02, max_frames=8)
    res["scaling"] = np.array([[r["tiles"], r["per_frame_s"], r["efficiency"], r["ok"]]
                               for r in rows], np.float64)

    res.update(dryrun.dryrun_body(dist.get_world_size(), device))
    return res
