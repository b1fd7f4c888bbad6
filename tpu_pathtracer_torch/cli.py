"""Command-line harness of the port: `python -m tpu_pathtracer_torch.cli`.

The port of `tpu_pathtracer.cli`, with the same commands, flags and
defaults, plus `--device` (default 'cuda'; 'cpu' runs every kernel's plain
PyTorch version):

  render     scene -> PNG (or linear .hdr), with checkpoint/resume,
             `--timing` (per-pass meters), `--metrics` (JSONL events) and
             `--profile DIR` (a torch.profiler trace of the render).
  benchmark  rays/s measurement (one JSON line, render/benchmark.py).
  invert     inverse-rendering demo: recover the material colors from a
             rendered target.
  info       torch, CUDA and device diagnostic.

`render` takes `--env-importance` (CDF importance sampling of the
environment) and `--blue-noise` (blue-noise AA jitter), as the JAX CLI's
does.  `--shard-tiles` / `--shard-samples` above 1 render on a mesh of
`torch.distributed` ranks (`render`; `invert` shards its tiles): start one
process a rank under torchrun, e.g.

    torchrun --nproc-per-node 2 -m tpu_pathtracer_torch.cli render --shard-tiles 2

(NCCL with a card a rank; gloo on the CPU, or where the ranks outnumber
the cards and share them).  Rank 0 writes the outputs.  Not ported yet
(ROADMAP.md), and raising NotImplementedError: `view`, `export` and a glTF
`--scene`.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def _not_ported(what: str):
    return NotImplementedError(f"{what} is not ported yet (ROADMAP.md)")


def _add_render_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--scene", default="default",
                   help="'default' (plane+box+sphere, src/main.ts:49-75); a .glb/.gltf path "
                        "is not ported yet")
    p.add_argument("--env", default="gradient",
                   help="'gradient', 'black', 'sky[:elevation=30,azimuth=90,"
                        "turbidity=3]' (Preetham sun-sky), or a .hdr path")
    p.add_argument("--width", type=int, default=256)
    p.add_argument("--height", type=int, default=256)
    p.add_argument("--scale", type=float, default=1.0,
                   help="internal resolution scaling factor (renderer.ts:39)")
    p.add_argument("--frames", type=int, default=64)
    p.add_argument("--spp", type=int, default=1, help="samples per frame")
    p.add_argument("--bounces", type=int, default=4)
    p.add_argument("--tonemap", choices=["none", "aces", "reinhard"], default="aces")
    p.add_argument("--denoise", action=argparse.BooleanOptionalAction, default=True)
    p.add_argument("--env-intensity", type=float, default=1.0)
    p.add_argument("--env-rotation", type=float, default=0.0, help="degrees")
    p.add_argument("--camera-position", type=float, nargs=3, default=(0.0, 1.0, 4.0))
    p.add_argument("--look-at", type=float, nargs=3, default=(0.0, 0.5, 0.0))
    p.add_argument("--fov", type=float, default=45.0)
    p.add_argument("--focal-distance", type=float, default=1.0)
    p.add_argument("--aperture", type=float, default=0.0)
    p.add_argument("--env-importance", action="store_true",
                   help="CDF importance sampling of the environment")
    p.add_argument("--intersector", choices=["auto", "mt", "mt_pallas", "mt_stream", "bvh", "bvh8"],
                   default="auto",
                   help="intersection backend: Möller–Trumbore (mt / the MT kernels mt_pallas "
                        "and mt_stream) or BVH traversal; auto picks by scene size")
    p.add_argument("--blue-noise", action="store_true",
                   help="blue-noise low-discrepancy AA jitter")
    p.add_argument("--shard-tiles", type=int, default=1,
                   help="shard image rows over this many ranks (run under torchrun)")
    p.add_argument("--shard-samples", type=int, default=1,
                   help="shard the per-frame sample budget over this many ranks "
                        "(run under torchrun)")
    p.add_argument("--device", default="cuda",
                   help="torch device: 'cuda' (the kernels) or 'cpu' (their plain versions)")


def _build_scene(args):
    import numpy as np

    from .io.hdr import read_hdr
    from .scene.envmap import gradient_sky
    from .scene.host import default_scene

    if args.scene != "default":
        raise _not_ported("loading a glTF scene (--scene PATH)")
    if args.env == "gradient":
        env = gradient_sky(512, 1024)
    elif args.env == "black":
        env = np.zeros((8, 16, 3), np.float32)
    elif args.env == "sky" or args.env.startswith("sky:"):
        from .scene.sky import parse_sky_spec, sun_sky

        env = sun_sky(512, 1024, **parse_sky_spec(args.env))
    else:
        env = read_hdr(args.env)
    return default_scene(env)


def _build_renderer(args):
    import math

    from . import PostConfig, RenderConfig, Renderer, ShardConfig, Tonemap
    from .scene.types import Camera

    shard = None
    if args.shard_tiles * args.shard_samples > 1:
        import torch.distributed as dist

        from .parallel import multihost

        multihost.initialize(device=args.device)
        print(f"rank {dist.get_rank()} of {dist.get_world_size()} ({dist.get_backend()})",
              file=sys.stderr)
        shard = ShardConfig(tiles=args.shard_tiles, samples=args.shard_samples)
    scene = _build_scene(args)
    cam = Camera.create(
        position=tuple(args.camera_position),
        look_at=tuple(args.look_at),
        fov=args.fov,
        focal_distance=args.focal_distance,
        aperture=args.aperture,
    )
    cfg = RenderConfig(
        width=args.width, height=args.height, scaling_factor=args.scale,
        frames=args.frames, samples_per_frame=args.spp, max_bounces=args.bounces,
        intersector=args.intersector, blue_noise=args.blue_noise,
    )
    post = PostConfig(denoise=args.denoise, tonemap=Tonemap[args.tonemap.upper()])
    r = Renderer(scene, cam, cfg, post, device=args.device, env_importance=args.env_importance,
                 enable_timing=getattr(args, "timing", False), shard=shard)
    r.env_intensity = args.env_intensity
    r.env_rotation = math.radians(args.env_rotation)
    return r


def _sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def cmd_render(args) -> int:
    if not args.profile:
        return _render_body(args)
    from pathlib import Path

    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if args.device.startswith("cuda"):
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        rc = _render_body(args)
    out = Path(args.profile)
    out.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(out / "render_trace.json"))
    print(f"profile -> {out / 'render_trace.json'}", file=sys.stderr)
    return rc


def _render_body(args) -> int:
    r = _build_renderer(args)
    metrics = None
    if args.metrics:
        from .render.metrics import MetricsLogger

        metrics = MetricsLogger(r, path=None if args.metrics == "-" else args.metrics)
    if args.resume:
        r.load_state(args.resume)
        print(f"resumed at frame {r.frame}/{args.frames}", file=sys.stderr)
    else:
        r.reset()

    last_pct = [-1]

    def on_progress(progress):
        pct = int(progress * 100)
        if pct != last_pct[0] and pct % 10 == 0:
            print(f"  {pct:3d}%  frame {r.frame - 1}/{args.frames} ({r.samples} spp)",
                  file=sys.stderr)
            last_pct[0] = pct

    unsub = r.on("progress", on_progress)
    t0 = time.perf_counter()
    ck_every = args.checkpoint_every or 0
    r.render_all(checkpoint_path=args.checkpoint if ck_every else None,
                 checkpoint_every=ck_every)
    _sync(r.device)
    unsub()
    if metrics is not None:
        metrics.close()
    dt = time.perf_counter() - t0

    if args.checkpoint:
        r.save_state(args.checkpoint)
        print(f"checkpoint -> {args.checkpoint}", file=sys.stderr)
    if args.output.endswith(".hdr"):
        # linear radiance at render resolution (no tonemap, no denoise)
        from .io.hdr import write_hdr

        acc = r.accumulation.cpu().numpy()
        if r._writes_files:
            write_hdr(args.output, acc[::-1])
    else:
        r.screenshot(args.output)
    spp = args.frames * args.spp
    print(f"{args.output}: {args.width}x{args.height} {spp}spp in {dt:.2f}s "
          f"({r.config.scaled_width * r.config.scaled_height * spp / dt / 1e6:.3f} "
          f"Mpixel-samples/s)", file=sys.stderr)
    if args.timing:
        for name, timer in r.timings.items():
            print(f"  {name:11s} {timer.value:10.1f} us/frame", file=sys.stderr)
    return 0


def cmd_benchmark(args) -> int:
    import torch

    from .render.benchmark import bench_config, headline_record

    r = _build_renderer(args)
    w, h = r.config.scaled_width, r.config.scaled_height
    res = bench_config(
        r.scene_data, r.camera, width=w, height=h, spp=args.spp, bounces=args.bounces,
        aspect=args.width / args.height, reps=args.reps,
        log=lambda s: print(s, file=sys.stderr),
    )
    print(json.dumps(headline_record(res, torch.device(args.device).type)))
    return 0


def cmd_invert(args) -> int:
    import dataclasses

    import numpy as np
    import torch

    from . import diff
    from .scene.types import RenderParams

    r = _build_renderer(args)
    scene_data = r.scene_data
    params = RenderParams.create(r.camera, frame=1)
    kw = dict(width=r.config.scaled_width, height=r.config.scaled_height,
              aspect=args.width / args.height, samples_per_frame=args.spp,
              max_bounces=args.bounces)

    target = diff.render_frame_diff(scene_data, params, **kw).detach()
    rng = np.random.default_rng(args.seed)
    n_mat = scene_data.materials.color.shape[0]
    wrong = torch.from_numpy(rng.random((n_mat, 3)).astype(np.float32)).to(r.device)
    bad = dataclasses.replace(
        scene_data, materials=dataclasses.replace(scene_data.materials, color=wrong))
    print(f"optimizing materials.color from random init, {args.steps} steps...",
          file=sys.stderr)
    if args.shard_tiles > 1:
        from .parallel import invert_sharded, make_mesh

        res = invert_sharded(make_mesh(tiles=args.shard_tiles, samples=1, device=r.device), bad,
                             params, target, ["materials.color"], steps=args.steps,
                             learning_rate=args.lr, **kw)
    else:
        res = diff.invert(bad, params, target, ["materials.color"], steps=args.steps,
                          learning_rate=args.lr, **kw)
    err = float((res.values["materials.color"] - scene_data.materials.color).abs().max())
    print(json.dumps({
        "metric": "invert_final_loss",
        "value": res.final_loss,
        "loss_start": res.losses[0],
        "color_max_abs_err": err,
    }))
    return 0 if res.final_loss < res.losses[0] * 0.5 else 1


def cmd_not_ported(args) -> int:
    raise _not_ported(f"the {args.command!r} command")


def cmd_info(args) -> int:
    import torch

    print(f"torch {torch.__version__} (CUDA {torch.version.cuda})")
    print(f"cuda available: {torch.cuda.is_available()}")
    for i in range(torch.cuda.device_count()):
        print(f"  {i}: {torch.cuda.get_device_name(i)} (cuda)")
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="tpu_pathtracer_torch",
        description="progressive path tracer (PyTorch + CUDA port)",
    )
    sub = parser.add_subparsers(dest="command", required=True)

    p = sub.add_parser("render", help="render a scene to PNG")
    _add_render_args(p)
    p.add_argument("--output", "-o", default="render.png")
    p.add_argument("--checkpoint", default=None,
                   help="save accumulation state to this .npz after rendering")
    p.add_argument("--resume", default=None,
                   help="resume accumulation state from this .npz")
    p.add_argument("--timing", action="store_true",
                   help="per-pass timing meters (reference: src/timing.ts)")
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="write a torch.profiler trace of the render to DIR")
    p.add_argument("--metrics", default=None, metavar="PATH",
                   help="emit JSONL metrics to PATH ('-' for stderr)")
    p.add_argument("--checkpoint-every", type=int, default=0, metavar="N",
                   help="with --checkpoint: persist state every N frames "
                        "(preemption-safe progressive render)")
    p.set_defaults(fn=cmd_render)

    p = sub.add_parser("benchmark", help="measure rays/s (one JSON line)")
    _add_render_args(p)
    p.add_argument("--reps", type=int, default=3)
    p.set_defaults(fn=cmd_benchmark)

    p = sub.add_parser("invert", help="inverse-rendering demo (recover colors)")
    _add_render_args(p)
    p.add_argument("--steps", type=int, default=60)
    p.add_argument("--lr", type=float, default=5e-2)
    p.add_argument("--seed", type=int, default=0)
    p.set_defaults(fn=cmd_invert)

    p = sub.add_parser("view", help="interactive viewer (not ported yet)")
    _add_render_args(p)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8790)
    p.set_defaults(fn=cmd_not_ported)

    p = sub.add_parser("export", help="convert/compress a scene to .glb (not ported yet)")
    p.add_argument("--scene", default="default")
    p.add_argument("--output", "-o", required=True)
    p.add_argument("--draco", action="store_true")
    p.add_argument("--draco-bits", type=int, default=14, metavar="N")
    p.add_argument("--draco-normal-bits", type=int, default=10, metavar="N")
    p.add_argument("--no-normalize", action="store_true")
    p.set_defaults(fn=cmd_not_ported)

    p = sub.add_parser("info", help="device diagnostic")
    p.set_defaults(fn=cmd_info)

    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
