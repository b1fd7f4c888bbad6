"""Smoke run of tpu_pathtracer_torch on one CUDA card.

    python3 chip_smoke.py [--profile] [--out DIR]

Builds the port's CUDA kernels from csrc/, holds each against its plain
PyTorch version on the card, then drives three paths once each through the
public entry points:

  * headline: `Renderer(...).render_all()` and `display()` on the default
    scene (1,998 triangles) at 512x512, 1 sample per pixel, 4 bounces, 16
    frames, with denoise and ACES; its intersections go through the
    near-to-far MT kernel (csrc/mt_shade.cu);
  * stress: the same on the JAX sweep's stress100K_512 scene (a
    101,760-triangle sphere and a plane, padded to 131,072) at 512x512, 1
    sample per pixel, 6 bounces, 4 frames; its intersections go through
    the streamed MT kernel (csrc/mt_stream.cu);
  * training: `diff.invert` with the JAX CLI's `invert` defaults (the
    default scene under a 512x1024 gradient sky, 256x256, 1 sample per
    pixel, 4 bounces, materials.color from np.random.default_rng(0), Adam
    at 5e-2, 60 steps), through the near-to-far kernel and torch autograd;
    then the loss gradient at the initial colors with TPT_CULL=list and
    =cond, through the list and cond kernels (csrc/mt_shade.cu).

For each path it checks that the path's kernels were launched in that run
(and the other MT kernels not), that what comes out is right (images
finite and in [0, 1], a frame through the kernels matching the same frame
through the plain versions; the CLI's rule final loss < 0.5 x first loss;
list and cond gradients matching nf's), and times it with CUDA events
against the plain versions.  Every culling variant (nf, list, cond) is
held bit for bit to its plain version at sub-treelets of 32, 64 and 128
triangles on the headline rays; the cond and streamed kernels also to
their plain versions' per-tile walk counts, so they made the same culling
decisions.

The line before the last is a JSON object with one entry per kernel; the
last line is {"ok": true, "device": {...}}.  Any failed check raises, so
the exit code is not 0 and no result line is printed.  Without a CUDA
device the script exits with code 2.  `--profile` adds a torch.profiler
table of one kernel-path frame of the render paths and of one training
step; `--out DIR` writes the full results there as chip_smoke.json.
"""

from __future__ import annotations

import argparse
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
WIDTH = HEIGHT = 512
FRAMES = 16
BOUNCES = 4
STRESS_FRAMES = 4
STRESS_BOUNCES = 6
STRESS_SPHERE = (0.5, 320, 160)  # bench.py:105, mesh_scene(320): 101,760 triangles
CAMERA = dict(position=(0.0, 1.0, 4.0), look_at=(0.0, 0.5, 0.0), fov=45.0)
DENOISE_TOL = dict(atol=2e-5, rtol=1e-4)  # tests/test_pallas_denoise.py
MT_TOL = 0.0  # kernel and plain version share every rounding step
INVERT_SIZE = 256  # the JAX CLI's `invert` defaults (cli.py:27-62, 398-402)
INVERT_STEPS = 60
INVERT_LR = 5e-2


def _card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0].strip()


def _time_ms(fn, warmup: int, reps: int) -> float:
    """Median milliseconds of `fn()` over `reps` runs, by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def _outlier_rule(a, b, mean_tol=1e-4, outlier_frac=0.01, outlier_tol=0.05):
    """tests/test_trace_golden.py:60-70: a bounded fraction of pixels may
    take another random branch; every other pixel agrees closely."""
    diff = (a.double() - b.double()).abs()
    outlier = diff.amax(dim=-1) > outlier_tol
    frac = float(outlier.double().mean())
    agree = float(diff[~outlier].mean()) if bool((~outlier).any()) else 0.0
    _check(frac < outlier_frac, f"outlier fraction {frac}")
    _check(agree < mean_tol, f"non-outlier mean abs diff {agree}")
    return frac, agree


def _hit_diff(hk, hp):
    """(mismatched hit/tri rays, max |t,u,v| difference over hit rays)."""
    import torch

    bad = int(((hk.hit != hp.hit) | (hk.tri != hp.tri)).sum())
    m = hk.hit & hp.hit
    err = max(float((a[m] - b[m]).abs().max()) if bool(m.any()) else 0.0
              for a, b in ((hk.t, hp.t), (hk.u, hp.u), (hk.v, hp.v)))
    _check(torch.isfinite(hk.t[hk.hit]).all().item(), "non-finite t on a hit")
    return bad, err


def _mt_rays(data, cam, intersect):
    """Ray features of the headline camera's primary rays and of their
    first bounce (terminated rays parked), as render_frame builds them."""
    import torch

    from tpu_pathtracer_torch.ops import camera as camera_ops
    from tpu_pathtracer_torch.ops import rng, trace
    from tpu_pathtracer_torch.scene.types import RenderParams

    dev = data.packed.tri_pos.device
    xs, ys = trace.blocked_pixel_grid(HEIGHT, WIDTH, dev)
    uv = torch.stack([xs.float() / WIDTH, ys.float() / HEIGHT], dim=-1)
    seed = rng.pixel_seed(xs + ys * WIDTH, 1)
    o, d = camera_ops.camera_rays(cam, uv, WIDTH / HEIGHT)
    resolution = torch.tensor([WIDTH, HEIGHT], dtype=torch.float32, device=dev)
    seed, o, d = camera_ops.apply_dof(seed, o, d, cam, resolution)
    ro, rd = o.T.contiguous(), d.T.contiguous()
    phi_primary = trace._ray_features_t(ro, rd)
    h1 = intersect(data.packed.tri_pos, phi_primary)
    carry = (ro, rd, torch.zeros_like(ro), torch.ones_like(ro), seed,
             torch.ones_like(seed, dtype=torch.bool))
    ro2, rd2, _, _, _, active = trace.bounce_shade_t(
        data, RenderParams.create(cam, frame=1), h1, carry,
        shade_mat=trace.pack_shade_material_rows(data))
    am = active[None, :]
    phi_bounce = trace._ray_features_t(torch.where(am, ro2, 1e30), torch.where(am, rd2, 0.0))
    return {"primary": (phi_primary, 0), "bounce1": (phi_bounce, int((~active).sum()))}


def _kernel_vs_plain(name, tri_pos, rays, kernel, plain, results) -> float:
    """Hold `kernel` to `plain` on each ray set: 0 hit/tri mismatches and
    max |t,u,v| difference within MT_TOL.  Returns the largest difference."""
    import torch

    worst = 0.0
    for what, (phi, parked) in rays.items():
        hk = kernel(tri_pos, phi)
        hp = plain(tri_pos, phi)
        torch.cuda.synchronize()
        bad, err = _hit_diff(hk, hp)
        hits = int(hk.hit.sum())
        print(f"{name} {what}: rays {phi.shape[1]}, hits {hits}, parked {parked}, "
              f"hit/tri mismatches {bad}, max |t,u,v| diff {err:.3g} (tolerance {MT_TOL})")
        _check(bad == 0, f"{name} {what}: {bad} rays differ in hit or triangle")
        _check(err <= MT_TOL, f"{name} {what}: t/u/v differ by {err}")
        _check(hits > 0, f"{name} {what}: no ray hit the scene")
        worst = max(worst, err)
        results[f"{name}_{what}"] = dict(hits=hits, mismatches=bad, max_abs_err=err,
                                         parked=parked)
    return worst


def _drive(pt, scene, config, counters, png: Path):
    """The main path: Renderer(...).render_all() + display() with every
    launch count set to 0 just before and read just after.  Checks the
    image and writes it as PNG; returns (launches, seconds, renderer,
    image mean)."""
    import torch

    renderer = pt.Renderer(scene, pt.Camera.create(**CAMERA), config, pt.PostConfig(),
                           device="cuda")
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    renderer.render_all()
    image = renderer.display()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counters.items()}
    _check(image.shape == (config.height, config.width, 3), f"display shape {tuple(image.shape)}")
    _check(bool(torch.isfinite(image).all()), "display image has non-finite values")
    _check(float(image.min()) >= 0.0 and float(image.max()) <= 1.0, "display outside [0, 1]")
    _check(float(image.mean()) > 0.05, "display image is black")
    png.parent.mkdir(parents=True, exist_ok=True)
    renderer.screenshot(str(png))
    print(f"  {config.frames} frames + display in {seconds:.2f} s (first call included); "
          f"launches {launches}; image mean {float(image.mean()):.4f}, written to "
          f"{png.relative_to(ROOT)}")
    return launches, seconds, renderer, float(image.mean())


def _profile(fn, tag, results, key, what="frame"):
    """A torch.profiler table of one run of `fn` after one warm-up run."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    table = prof.key_averages().table(sort_by="cuda_time_total", row_limit=30)
    print(f"profiled {key} {what} {tag}: wall {wall_ms:.3f} ms under the profiler")
    print(table)
    results[f"{key}_profile_wall_ms"] = wall_ms
    results[f"{key}_profile_table"] = table


# The whole-scene MT wrapper's culling variants and the sub-treelet sizes
# at which each is held to its plain version.
CULLS = ("nf", "list", "cond")
SUBS = (32, 64, 128)


def _cull_phase(mt_shade, tri_pos, rays, results, tag):
    """Every culling variant at every sub-treelet size against its plain
    version on the headline rays: 0 hit/tri mismatches, t/u/v within MT_TOL,
    and for cond equal per-tile walk counts.  Prints the hit/tri
    mismatches against nf (information: exact-t ties may resolve to
    another triangle) and times the kernel and plain walks on the primary
    rays.  Returns {cull: (worst difference, wrapper ms, plain wrapper ms)}
    at the default sub."""
    import functools

    import torch

    walks = {
        "nf": (mt_shade._prepare, mt_shade._walk_cuda, mt_shade._walk_plain),
        "list": (mt_shade._prepare_list, mt_shade._walk_list_cuda, mt_shade._walk_list_plain),
        "cond": (mt_shade._prepare_cond, mt_shade._walk_cond_cuda, mt_shade._walk_cond_plain),
    }
    nf_hits = {what: mt_shade.mt_intersect_nf_phi_plain(tri_pos, phi) for what, (phi, _) in
               rays.items()}
    out = {}
    for cull in CULLS:
        kernel, plain = mt_shade._ROUTES[cull]
        worst = 0.0
        for sub in SUBS:
            name = f"mt_{cull}_sub{sub}"
            worst = max(worst, _kernel_vs_plain(
                name, tri_pos, rays, functools.partial(kernel, sub=sub),
                functools.partial(plain, sub=sub), results))
            for what, (phi, _) in rays.items():
                hk = kernel(tri_pos, phi, sub=sub)
                vs_nf = int(((hk.hit != nf_hits[what].hit) | (hk.tri != nf_hits[what].tri)).sum())
                results[f"{name}_{what}"]["mismatches_vs_nf"] = vs_nf
                line = f"{name} {what}: hit/tri mismatches against nf {vs_nf} (information)"
                if cull == "cond":
                    sk = mt_shade.cond_walk_stats(tri_pos, phi, sub=sub)
                    sp = mt_shade.cond_walk_stats(tri_pos, phi, sub=sub, plain=True)
                    _check(torch.equal(sk, sp), f"{name} {what}: walk counts differ from plain")
                    live, evaluated = (int(x) for x in sk.sum(dim=0))
                    results[f"{name}_{what}"].update(chunks_live=live, subs_evaluated=evaluated)
                    line += (f"; walk counts equal to the plain walk's over {sk.shape[0]} tiles: "
                             f"{live} chunks live, {evaluated} subs evaluated")
                print(line)
            phi = rays["primary"][0]
            prepare, walk_k, walk_p = walks[cull]
            prep = prepare(tri_pos, phi, None, sub)
            walk_ms = _time_ms(lambda: walk_k(*prep), 3, 20)
            walk_plain_ms = _time_ms(lambda: walk_p(*prep), 1, 3)
            results[f"{name}_walk_ms"], results[f"{name}_walk_plain_ms"] = walk_ms, walk_plain_ms
            print(f"timing {tag}: {name} primary kernel walk {walk_ms:.3f} ms, plain walk "
                  f"{walk_plain_ms:.3f} ms")
            del prep
        phi = rays["primary"][0]
        ms = _time_ms(lambda: kernel(tri_pos, phi), 3, 20)
        plain_ms = _time_ms(lambda: plain(tri_pos, phi), 1, 3)
        print(f"timing {tag}: mt_{cull} primary wrapper (sub 64) {ms:.3f} ms, plain wrapper "
              f"{plain_ms:.3f} ms")
        results[f"mt_{cull}_ms"], results[f"mt_{cull}_plain_ms"] = ms, plain_ms
        out[cull] = (worst, ms, plain_ms)
    return out


def _training_phase(pt, counters, results, tag, profile: bool):
    """The training path: the JAX CLI's `invert` defaults through
    `diff.invert` on the card, with every launch count set to 0 just before
    and read just after; then the loss gradient at the initial colors under
    TPT_CULL=list and =cond against nf's.  Returns {cull: launches of the
    list and cond kernels in their gradient runs}."""
    import dataclasses
    import os

    import numpy as np
    import torch

    from tpu_pathtracer_torch import diff
    from tpu_pathtracer_torch.scene.envmap import gradient_sky

    dev = torch.device("cuda")
    data = pt.default_scene(gradient_sky(512, 1024)).compile(device=dev)
    params = pt.RenderParams.create(pt.Camera.create(**CAMERA, device=dev), frame=1)
    kw = dict(width=INVERT_SIZE, height=INVERT_SIZE, aspect=1.0, samples_per_frame=1,
              max_bounces=BOUNCES)
    target = diff.render_frame_diff(data, params, **kw).detach()
    true_color = data.materials.color
    n_mat = true_color.shape[0]
    wrong = torch.from_numpy(np.random.default_rng(0).random((n_mat, 3)).astype(np.float32))
    bad = dataclasses.replace(data, materials=dataclasses.replace(data.materials,
                                                                  color=wrong.to(dev)))
    run = dict(steps=INVERT_STEPS, learning_rate=INVERT_LR, **kw)

    print(f"training main path: diff.invert, {n_mat} materials, {INVERT_SIZE}x{INVERT_SIZE}, "
          f"{BOUNCES} bounces, {INVERT_STEPS} Adam steps at lr {INVERT_LR}")
    for fn in counters.values():
        fn.launches = 0
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    res = diff.invert(bad, params, target, ["materials.color"], **run)
    end.record()
    end.synchronize()
    seconds = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counters.items()}
    step_ms = start.elapsed_time(end) / INVERT_STEPS
    losses = res.losses
    err = float((res.values["materials.color"] - true_color).abs().max())
    print(f"  {INVERT_STEPS} steps in {seconds:.2f} s (first step included); launches {launches}; "
          f"loss {losses[0]:.6g} -> {losses[-1]:.6g} (rule: < 0.5 x first); "
          f"color_max_abs_err {err:.4f}")
    _check(all(math.isfinite(x) for x in losses), "non-finite loss")
    _check(losses[-1] < 0.5 * losses[0], f"invert: final loss {losses[-1]} >= 0.5 x {losses[0]}")
    _check(launches["mt_nf"] >= INVERT_STEPS, f"mt_nf launches {launches}")
    for other in ("mt_list", "mt_cond", "mt_stream"):
        _check(launches[other] == 0, f"{other} launched on the training path: {launches}")

    # the same problem through the plain versions: the first loss is the
    # same forward frame
    res_p = diff.invert(bad, params, target, ["materials.color"], plain=True,
                        **{**run, "steps": 1})
    _check(abs(res_p.losses[0] - losses[0]) <= 1e-6 * losses[0],
           f"first loss through the plain versions {res_p.losses[0]} != {losses[0]}")

    # warm steps, as `invert` takes them: median of 10 on the kernel path, of
    # 3 on the plain path
    loss_p = {}
    for plain in (False, True):
        loss = diff.make_loss(target, plain=plain, **kw)
        loss_p[plain] = diff.make_param_loss(loss, bad, params, ["materials.color"])
    steps = {}
    for plain in (False, True):
        leaf = wrong.to(dev).requires_grad_(True)
        opt = torch.optim.Adam([leaf], lr=INVERT_LR)

        def step(plain=plain, leaf=leaf, opt=opt):
            opt.zero_grad(set_to_none=True)
            value = loss_p[plain]({"materials.color": leaf})
            value.backward()
            opt.step()
            float(value.detach())

        steps[plain] = step
    warm_ms = _time_ms(steps[False], 2, 10)
    plain_ms = _time_ms(steps[True], 1, 3)
    print(f"timing {tag}: training step kernel path {warm_ms:.3f} ms (median of 10 warm steps; "
          f"{step_ms:.3f} ms mean over the {INVERT_STEPS} steps of invert, first included), "
          f"plain path {plain_ms:.3f} ms (median of 3 warm steps)")
    results.update(invert_launches=launches, invert_seconds=seconds, invert_step_ms=step_ms,
                   step_ms=warm_ms, step_plain_ms=plain_ms, invert_losses=losses,
                   invert_color_max_abs_err=err)

    # the loss gradient at the initial colors through each culling kernel
    def color_grad():
        leaf = wrong.to(dev).requires_grad_(True)
        return torch.autograd.grad(loss_p[False]({"materials.color": leaf}), leaf)[0]

    saved = os.environ.get("TPT_CULL")
    grads, cull_launches = {}, {}
    try:
        for cull in CULLS:
            os.environ["TPT_CULL"] = cull
            for fn in counters.values():
                fn.launches = 0
            grads[cull] = color_grad()
            torch.cuda.synchronize()
            cull_launches[cull] = {name: fn.launches for name, fn in counters.items()}
            _check(cull_launches[cull][f"mt_{cull}"] >= 1,
                   f"TPT_CULL={cull}: launches {cull_launches[cull]}")
    finally:
        if saved is None:
            os.environ.pop("TPT_CULL", None)
        else:
            os.environ["TPT_CULL"] = saved
    for cull in ("list", "cond"):
        diff_max = float((grads[cull] - grads["nf"]).abs().max())
        torch.testing.assert_close(grads[cull], grads["nf"], rtol=1e-3, atol=1e-5)
        print(f"TPT_CULL={cull} loss gradient vs nf: max abs diff {diff_max:.3g} "
              f"(rtol 1e-3, atol 1e-5); launches {cull_launches[cull]}")
        results[f"grad_{cull}_vs_nf_max_abs_diff"] = diff_max
    results["grad_cull_launches"] = cull_launches
    if profile:
        _profile(steps[False], tag, results, "training", what="step")
    return {cull: cull_launches[cull][f"mt_{cull}"] for cull in ("list", "cond")}


def main(argv=None) -> int:
    args = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    args.add_argument("--profile", action="store_true")
    args.add_argument("--out", default=None)
    opts = args.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; nothing run", file=sys.stderr)
        return 2

    import numpy as np

    import tpu_pathtracer_torch as pt
    from tpu_pathtracer_torch import _build
    from tpu_pathtracer_torch.ops import trace
    from tpu_pathtracer_torch.ops.kernels import denoise as kdenoise
    from tpu_pathtracer_torch.ops.kernels import mt_shade, mt_stream
    from tpu_pathtracer_torch.scene import primitives
    from tpu_pathtracer_torch.scene.envmap import gradient_sky
    from tpu_pathtracer_torch.scene.host import rotation_x

    dev = torch.device("cuda")
    card = _card()
    kind = torch.cuda.get_device_name(0)
    tag = f"[{card}]"
    print(card)  # nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    results: dict = {"card": card}
    counters = {"mt_nf": mt_shade.mt_intersect_nf_phi,
                "mt_list": mt_shade.mt_intersect_list_phi,
                "mt_cond": mt_shade.mt_intersect_cond_phi,
                "mt_stream": mt_stream.mt_intersect_stream2_phi,
                "denoise": kdenoise.smart_denoise}

    # --- build --------------------------------------------------------------
    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.load()
    build_s = time.perf_counter() - t0
    print(f"kernel build: {build_s:.1f} s -> build/tpu_pathtracer_torch/{lib_path.name}")
    for line in lib_path.with_suffix(".log").read_text().splitlines():
        if "registers" in line or "Compiling entry" in line or "spill" in line:
            print("  ptxas:", line.split("ptxas info    :")[-1].strip())
    results["build_s"] = build_s

    # --- headline: near-to-far MT kernel vs plain on the headline rays ------
    scene = pt.default_scene(gradient_sky(64, 128))
    data = scene.compile(device=dev)
    cam = pt.Camera.create(**CAMERA, device=dev)
    tri_pos = data.packed.tri_pos
    rays = _mt_rays(data, cam, mt_shade.mt_intersect_nf_phi)
    phi_primary = rays["primary"][0]
    mt_err = _kernel_vs_plain("mt", tri_pos, rays, mt_shade.mt_intersect_nf_phi,
                              mt_shade.mt_intersect_nf_phi_plain, results)

    # --- cull phase: nf, list and cond at sub 32/64/128 vs plain ---------------
    culls = _cull_phase(mt_shade, tri_pos, rays, results, tag)

    # --- denoise phase ------------------------------------------------------
    den_err = 0.0
    for h, w in ((512, 512), (1080, 1920), (300, 517)):
        img = torch.from_numpy(np.random.default_rng(h + w).random((h, w, 3), np.float32)).to(dev)
        out_k = kdenoise.smart_denoise(img)
        out_p = kdenoise.smart_denoise_plain(img)
        torch.cuda.synchronize()
        err = float((out_k - out_p).abs().max())
        torch.testing.assert_close(out_k, out_p, **DENOISE_TOL)
        print(f"denoise {h}x{w}: max abs diff {err:.3g} (atol 2e-5, rtol 1e-4)")
        den_err = max(den_err, err)
        results[f"denoise_{h}x{w}_max_abs_err"] = err

    # --- headline main path: Renderer.render_all() + display() ---------------
    config = pt.RenderConfig(width=WIDTH, height=HEIGHT, frames=FRAMES,
                             samples_per_frame=1, max_bounces=BOUNCES)
    print("headline main path:")
    launches, main_s, renderer, mean = _drive(pt, scene, config, counters,
                                              ROOT / "build" / "chip_smoke_headline.png")
    _check(FRAMES <= launches["mt_nf"] <= FRAMES * BOUNCES, f"mt_nf launches {launches}")
    for other in ("mt_list", "mt_cond", "mt_stream"):
        _check(launches[other] == 0, f"{other} launched on the headline path: {launches}")
    _check(launches["denoise"] >= 1, "denoise kernel not launched")
    results.update(main_path_s=main_s, launches=launches, image_mean=mean)

    # one frame through the kernels vs the same frame through the plain versions
    kw = dict(width=WIDTH, height=HEIGHT, aspect=WIDTH / HEIGHT, max_bounces=BOUNCES)
    frame_params = pt.RenderParams.create(cam, frame=3)
    img_k = trace.render_frame(data, frame_params, **kw)
    img_p = trace.render_frame(data, frame_params, plain=True, **kw)
    frac, agree = _outlier_rule(img_k, img_p)
    print(f"frame kernel vs plain: outlier fraction {frac:.2e}, non-outlier mean diff {agree:.2e}")
    results.update(frame_outlier_frac=frac, frame_mean_diff=agree)

    paths = WIDTH * HEIGHT
    ms_k = _time_ms(lambda: trace.render_frame(data, frame_params, **kw), 3, 15)
    ms_p = _time_ms(lambda: trace.render_frame(data, frame_params, plain=True, **kw), 0, 3)
    mt_ms = _time_ms(lambda: mt_shade.mt_intersect_nf_phi(tri_pos, phi_primary), 3, 30)
    mt_plain_ms = _time_ms(lambda: mt_shade.mt_intersect_nf_phi_plain(tri_pos, phi_primary), 1, 5)
    prep = mt_shade._prepare(tri_pos, phi_primary, None)
    walk_ms = _time_ms(lambda: mt_shade._walk_cuda(*prep), 3, 30)
    walk_plain_ms = _time_ms(lambda: mt_shade._walk_plain(*prep), 1, 5)
    prep_ms = _time_ms(lambda: mt_shade._prepare(tri_pos, phi_primary, None), 3, 30)
    img512 = torch.from_numpy(
        np.random.default_rng(0).random((HEIGHT, WIDTH, 3), np.float32)).to(dev)
    den_ms = _time_ms(lambda: kdenoise.smart_denoise(img512), 3, 30)
    den_plain_ms = _time_ms(lambda: kdenoise.smart_denoise_plain(img512), 1, 5)
    display_ms = _time_ms(renderer.display, 2, 10)
    print(f"timing {tag}: headline frame kernel path {ms_k:.3f} ms "
          f"({paths / ms_k / 1e3:.2f} Mpaths/s), plain path {ms_p:.3f} ms "
          f"({paths / ms_p / 1e3:.2f} Mpaths/s)")
    print(f"timing {tag}: mt primary wrapper {mt_ms:.3f} ms (precull {prep_ms:.3f} ms, kernel "
          f"walk {walk_ms:.3f} ms), plain wrapper {mt_plain_ms:.3f} ms (plain walk "
          f"{walk_plain_ms:.3f} ms)")
    print(f"timing {tag}: denoise 512x512 kernel {den_ms:.3f} ms, plain {den_plain_ms:.3f} ms; "
          f"display() {display_ms:.3f} ms")
    results.update(frame_ms=ms_k, frame_plain_ms=ms_p, mt_ms=mt_ms, mt_plain_ms=mt_plain_ms,
                   mt_walk_ms=walk_ms, mt_walk_plain_ms=walk_plain_ms, mt_prepare_ms=prep_ms,
                   denoise_ms=den_ms, denoise_plain_ms=den_plain_ms, display_ms=display_ms)
    if opts.profile:
        _profile(lambda: trace.render_frame(data, frame_params, **kw), tag, results, "headline")
    del renderer, img_k, img_p, prep

    # --- stress: streamed MT kernel vs plain on the stress scene's rays ------
    stress = pt.Scene()
    stress.add(pt.Mesh(*primitives.sphere(*STRESS_SPHERE), pt.Material(color=(0.8, 0.7, 0.6))))
    stress.add(pt.Mesh(*primitives.plane(4, 4), pt.Material(),
                       transform=rotation_x(-math.pi / 2)))
    stress.set_environment(gradient_sky(512, 1024))
    t0 = time.perf_counter()
    sdata = stress.compile(device=dev)
    compile_s = time.perf_counter() - t0
    s_tri = sdata.packed.tri_pos
    print(f"stress scene: {s_tri.shape[0]} padded triangles, compiled in {compile_s:.2f} s; "
          f"intersector {trace.resolve_intersector('auto', s_tri.shape[0])}")
    _check(s_tri.shape[0] == 131072, f"stress scene padded to {s_tri.shape[0]}")
    s_rays = _mt_rays(sdata, cam, mt_stream.mt_intersect_stream2_phi)
    s_primary = s_rays["primary"][0]
    stream_err = _kernel_vs_plain("mt_stream", s_tri, s_rays, mt_stream.mt_intersect_stream2_phi,
                                  mt_stream.mt_intersect_stream2_phi_plain, results)
    for what, (phi, _) in s_rays.items():
        # the same liveness decisions, not only the same hits
        sk = mt_stream.walk_stats(s_tri, phi)
        sp = mt_stream.walk_stats(s_tri, phi, plain=True)
        _check(torch.equal(sk, sp), f"mt_stream {what}: walk counts differ from the plain walk")
        walked, staged, evaluated = (int(x) for x in sk.sum(dim=0))
        print(f"mt_stream {what}: walk counts equal to the plain walk's over {sk.shape[0]} tiles: "
              f"{walked} supers walked, {staged} chunks staged, {evaluated} subs evaluated")
        results[f"mt_stream_{what}"].update(supers_walked=walked, chunks_staged=staged,
                                            subs_evaluated=evaluated)
    results["stress_compile_s"] = compile_s

    # --- stress main path: Renderer.render_all() + display() -----------------
    s_config = pt.RenderConfig(width=WIDTH, height=HEIGHT, frames=STRESS_FRAMES,
                               samples_per_frame=1, max_bounces=STRESS_BOUNCES)
    print("stress main path:")
    s_launches, s_main_s, s_renderer, s_mean = _drive(pt, stress, s_config, counters,
                                                      ROOT / "build" / "chip_smoke_stress.png")
    _check(STRESS_FRAMES <= s_launches["mt_stream"] <= STRESS_FRAMES * STRESS_BOUNCES,
           f"mt_stream launches {s_launches}")
    for other in ("mt_nf", "mt_list", "mt_cond"):
        _check(s_launches[other] == 0, f"{other} launched on the stress path: {s_launches}")
    results.update(stress_main_path_s=s_main_s, stress_launches=s_launches,
                   stress_image_mean=s_mean)
    del s_renderer

    s_kw = dict(width=WIDTH, height=HEIGHT, aspect=WIDTH / HEIGHT, max_bounces=STRESS_BOUNCES)
    img_k = trace.render_frame(sdata, frame_params, **s_kw)
    img_p = trace.render_frame(sdata, frame_params, plain=True, **s_kw)
    frac, agree = _outlier_rule(img_k, img_p)
    print(f"stress frame kernel vs plain: outlier fraction {frac:.2e}, "
          f"non-outlier mean diff {agree:.2e}")
    results.update(stress_frame_outlier_frac=frac, stress_frame_mean_diff=agree)
    del img_k, img_p

    s_ms = _time_ms(lambda: trace.render_frame(sdata, frame_params, **s_kw), 1, 5)
    s_ms_p = _time_ms(lambda: trace.render_frame(sdata, frame_params, plain=True, **s_kw), 0, 2)
    st_ms = _time_ms(lambda: mt_stream.mt_intersect_stream2_phi(s_tri, s_primary), 2, 10)
    st_plain_ms = _time_ms(
        lambda: mt_stream.mt_intersect_stream2_phi_plain(s_tri, s_primary), 1, 2)
    s_prep = mt_stream._prepare(s_tri, s_primary, None)
    st_walk_ms = _time_ms(lambda: mt_stream._walk_cuda(*s_prep), 2, 10)
    st_walk_plain_ms = _time_ms(lambda: mt_stream._walk_plain(*s_prep), 1, 2)
    st_prep_ms = _time_ms(lambda: mt_stream._prepare(s_tri, s_primary, None), 2, 10)
    print(f"timing {tag}: stress frame kernel path {s_ms:.3f} ms "
          f"({paths / s_ms / 1e3:.3f} Mpaths/s), plain path {s_ms_p:.3f} ms "
          f"({paths / s_ms_p / 1e3:.3f} Mpaths/s)")
    print(f"timing {tag}: mt_stream primary wrapper {st_ms:.3f} ms (precull {st_prep_ms:.3f} ms, "
          f"kernel walk {st_walk_ms:.3f} ms), plain wrapper {st_plain_ms:.3f} ms (plain walk "
          f"{st_walk_plain_ms:.3f} ms)")
    results.update(stress_frame_ms=s_ms, stress_frame_plain_ms=s_ms_p, stream_ms=st_ms,
                   stream_plain_ms=st_plain_ms, stream_walk_ms=st_walk_ms,
                   stream_walk_plain_ms=st_walk_plain_ms, stream_prepare_ms=st_prep_ms)
    if opts.profile:
        _profile(lambda: trace.render_frame(sdata, frame_params, **s_kw), tag, results, "stress")

    del s_prep

    # --- training main path: diff.invert, then list/cond gradients ------------
    cull_launches = _training_phase(pt, counters, results, tag, opts.profile)

    kernels = [
        {"name": "mt_nf", "route": "cuda", "source": "tpu_pathtracer_torch/csrc/mt_shade.cu",
         "replaces": "tpu_pathtracer/ops/pallas/mt_shade.py:308", "launches": launches["mt_nf"],
         "max_abs_err": max(mt_err, culls["nf"][0]), "ms": mt_ms, "plain_ms": mt_plain_ms},
        {"name": "denoise", "route": "cuda", "source": "tpu_pathtracer_torch/csrc/denoise.cu",
         "replaces": "tpu_pathtracer/ops/pallas/denoise.py:33",
         "launches": launches["denoise"], "max_abs_err": den_err, "ms": den_ms,
         "plain_ms": den_plain_ms},
        {"name": "mt_stream", "route": "cuda", "source": "tpu_pathtracer_torch/csrc/mt_stream.cu",
         "replaces": "tpu_pathtracer/ops/pallas/mt_shade.py:628",
         "launches": s_launches["mt_stream"], "max_abs_err": stream_err, "ms": st_ms,
         "plain_ms": st_plain_ms},
        *({"name": f"mt_{cull}", "route": "cuda", "source": "tpu_pathtracer_torch/csrc/mt_shade.cu",
           "replaces": f"tpu_pathtracer/ops/pallas/mt_shade.py:{line}",
           "launches": cull_launches[cull], "max_abs_err": culls[cull][0], "ms": culls[cull][1],
           "plain_ms": culls[cull][2]} for cull, line in (("list", 255), ("cond", 183))),
    ]
    results["kernels"] = kernels
    if opts.out:
        out_dir = Path(opts.out)
        out_dir.mkdir(parents=True, exist_ok=True)
        (out_dir / "chip_smoke.json").write_text(json.dumps(results, indent=1))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
