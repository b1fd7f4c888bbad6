"""Smoke run of tpu_pathtracer_torch on one CUDA card.

    python3 chip_smoke.py [--profile] [--out DIR]

Builds the port's CUDA kernels from csrc/, holds each against its plain
PyTorch version on the card, then drives the main path once through the
public entry points: `Renderer(...).render_all()` and `display()` on the
default scene (1,998 triangles) at 512x512, 1 sample per pixel, 4 bounces,
16 frames, with denoise and ACES.  It checks that the kernels were launched
on that path, that the image is finite and in [0, 1], and that a frame
rendered through the kernels matches the same frame through the plain
versions; then it times both paths with CUDA events.

The line before the last is a JSON object with one entry per kernel; the
last line is {"ok": true, "device": {...}}.  Any failed check raises, so
the exit code is not 0 and no result line is printed.  Without a CUDA
device the script exits with code 2.  `--profile` adds a torch.profiler
table of one kernel-path frame; `--out DIR` writes the full results there
as chip_smoke.json.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
WIDTH = HEIGHT = 512
FRAMES = 16
BOUNCES = 4
CAMERA = dict(position=(0.0, 1.0, 4.0), look_at=(0.0, 0.5, 0.0), fov=45.0)
DENOISE_TOL = dict(atol=2e-5, rtol=1e-4)  # tests/test_pallas_denoise.py
MT_TOL = 0.0  # kernel and plain version share every rounding step


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
    from tpu_pathtracer_torch.ops import camera as camera_ops
    from tpu_pathtracer_torch.ops import rng
    from tpu_pathtracer_torch.ops import trace
    from tpu_pathtracer_torch.ops.kernels import denoise as kdenoise
    from tpu_pathtracer_torch.ops.kernels import mt_shade
    from tpu_pathtracer_torch.scene.envmap import gradient_sky

    dev = torch.device("cuda")
    card = _card()
    kind = torch.cuda.get_device_name(0)
    print(card)  # nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    results: dict = {"card": card}

    # --- build --------------------------------------------------------------
    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.load()
    build_s = time.perf_counter() - t0
    print(f"kernel build: {build_s:.1f} s -> build/tpu_pathtracer_torch/{lib_path.name}")
    for line in lib_path.with_suffix(".log").read_text().splitlines():
        if "registers" in line or "Compiling entry" in line:
            print("  ptxas:", line.split("ptxas info    :")[-1].strip())
    results["build_s"] = build_s

    # --- MT phase: kernel vs plain on the headline rays -----------------------
    scene = pt.default_scene(gradient_sky(64, 128))
    data = scene.compile(device=dev)
    cam = pt.Camera.create(**CAMERA, device=dev)
    params = pt.RenderParams.create(cam, frame=1)
    tri_pos = data.packed.tri_pos
    xs, ys = trace.blocked_pixel_grid(HEIGHT, WIDTH, dev)
    uv = torch.stack([xs.float() / WIDTH, ys.float() / HEIGHT], dim=-1)
    seed = rng.pixel_seed(xs + ys * WIDTH, 1)
    o, d = camera_ops.camera_rays(cam, uv, WIDTH / HEIGHT)
    resolution = torch.tensor([WIDTH, HEIGHT], dtype=torch.float32, device=dev)
    seed, o, d = camera_ops.apply_dof(seed, o, d, cam, resolution)
    ro, rd = o.T.contiguous(), d.T.contiguous()
    phi_primary = trace._ray_features_t(ro, rd)
    h1 = mt_shade.mt_intersect_nf_phi(tri_pos, phi_primary)
    shade_mat = trace.pack_shade_material_rows(data)
    ones = torch.ones_like(ro)
    carry = (ro, rd, torch.zeros_like(ro), ones, seed, torch.ones_like(seed, dtype=torch.bool))
    ro2, rd2, _, _, _, active = trace.bounce_shade_t(data, params, h1, carry, shade_mat=shade_mat)
    am = active[None, :]
    phi_bounce = trace._ray_features_t(torch.where(am, ro2, 1e30), torch.where(am, rd2, 0.0))
    mt_err = 0.0
    for name, phi in (("primary", phi_primary), ("bounce1", phi_bounce)):
        hk = mt_shade.mt_intersect_nf_phi(tri_pos, phi)
        hp = mt_shade.mt_intersect_nf_phi_plain(tri_pos, phi)
        torch.cuda.synchronize()
        bad, err = _hit_diff(hk, hp)
        parked = int((~active).sum()) if name == "bounce1" else 0
        print(f"mt {name}: rays {phi.shape[1]}, hits {int(hk.hit.sum())}, parked {parked}, "
              f"hit/tri mismatches {bad}, max |t,u,v| diff {err:.3g} (tolerance {MT_TOL})")
        _check(bad == 0, f"mt {name}: {bad} rays differ in hit or triangle")
        _check(err <= MT_TOL, f"mt {name}: t/u/v differ by {err}")
        _check(int(hk.hit.sum()) > 0, f"mt {name}: no ray hit the scene")
        mt_err = max(mt_err, err)
        results[f"mt_{name}"] = dict(hits=int(hk.hit.sum()), mismatches=bad, max_abs_err=err,
                                    parked=parked)

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

    # --- main path: Renderer.render_all() + display() -------------------------
    config = pt.RenderConfig(width=WIDTH, height=HEIGHT, frames=FRAMES,
                             samples_per_frame=1, max_bounces=BOUNCES)
    renderer = pt.Renderer(scene, pt.Camera.create(**CAMERA), config, pt.PostConfig(),
                           device="cuda")
    mt_shade.mt_intersect_nf_phi.launches = 0
    kdenoise.smart_denoise.launches = 0
    t0 = time.perf_counter()
    renderer.render_all()
    image = renderer.display()
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t0
    launches = {"mt_nf": mt_shade.mt_intersect_nf_phi.launches,
                "denoise": kdenoise.smart_denoise.launches}
    print(f"main path: {FRAMES} frames + display in {main_s:.2f} s (first call included); "
          f"launches {launches}")
    _check(image.shape == (HEIGHT, WIDTH, 3), f"display shape {tuple(image.shape)}")
    _check(bool(torch.isfinite(image).all()), "display image has non-finite values")
    _check(float(image.min()) >= 0.0 and float(image.max()) <= 1.0, "display outside [0, 1]")
    _check(float(image.mean()) > 0.05, "display image is black")
    _check(FRAMES <= launches["mt_nf"] <= FRAMES * BOUNCES, f"MT launches {launches['mt_nf']}")
    _check(launches["denoise"] >= 1, "denoise kernel not launched")
    png = ROOT / "build" / "chip_smoke_headline.png"
    png.parent.mkdir(parents=True, exist_ok=True)
    renderer.screenshot(str(png))
    print(f"image mean {float(image.mean()):.4f}, written to {png.relative_to(ROOT)}")
    results.update(main_path_s=main_s, launches=launches, image_mean=float(image.mean()))

    # one frame through the kernels vs the same frame through the plain versions
    kw = dict(width=WIDTH, height=HEIGHT, aspect=WIDTH / HEIGHT, max_bounces=BOUNCES)
    frame_params = pt.RenderParams.create(cam, frame=3)
    img_k = trace.render_frame(data, frame_params, **kw)
    img_p = trace.render_frame(data, frame_params, plain=True, **kw)
    frac, agree = _outlier_rule(img_k, img_p)
    print(f"frame kernel vs plain: outlier fraction {frac:.2e}, non-outlier mean diff {agree:.2e}")
    results.update(frame_outlier_frac=frac, frame_mean_diff=agree)

    # --- timing ---------------------------------------------------------------
    paths = WIDTH * HEIGHT
    ms_k = _time_ms(lambda: trace.render_frame(data, frame_params, **kw), 3, 15)
    ms_p = _time_ms(lambda: trace.render_frame(data, frame_params, plain=True, **kw), 1, 5)
    ms_k2 = _time_ms(lambda: trace.render_frame(data, frame_params, **kw), 1, 15)
    mt_ms = _time_ms(lambda: mt_shade.mt_intersect_nf_phi(tri_pos, phi_primary), 3, 30)
    mt_plain_ms = _time_ms(lambda: mt_shade.mt_intersect_nf_phi_plain(tri_pos, phi_primary), 1, 10)
    prep = mt_shade._prepare(tri_pos, phi_primary, None)
    walk_ms = _time_ms(lambda: mt_shade._walk_cuda(*prep), 3, 30)
    walk_plain_ms = _time_ms(lambda: mt_shade._walk_plain(*prep), 1, 10)
    prep_ms = _time_ms(lambda: mt_shade._prepare(tri_pos, phi_primary, None), 3, 30)
    img512 = torch.from_numpy(
        np.random.default_rng(0).random((HEIGHT, WIDTH, 3), np.float32)).to(dev)
    den_ms = _time_ms(lambda: kdenoise.smart_denoise(img512), 3, 30)
    den_plain_ms = _time_ms(lambda: kdenoise.smart_denoise_plain(img512), 1, 10)
    display_ms = _time_ms(renderer.display, 2, 10)
    tag = f"[{card}]"
    print(f"timing {tag}: frame kernel path {ms_k:.3f} ms ({paths / ms_k / 1e3:.2f} Mpaths/s; "
          f"repeat {ms_k2:.3f} ms), plain path {ms_p:.3f} ms ({paths / ms_p / 1e3:.2f} Mpaths/s)")
    print(f"timing {tag}: mt primary wrapper {mt_ms:.3f} ms (precull {prep_ms:.3f} ms, kernel "
          f"walk {walk_ms:.3f} ms), plain wrapper {mt_plain_ms:.3f} ms (plain walk "
          f"{walk_plain_ms:.3f} ms)")
    print(f"timing {tag}: denoise 512x512 kernel {den_ms:.3f} ms, plain {den_plain_ms:.3f} ms; "
          f"display() {display_ms:.3f} ms")
    results.update(frame_ms=ms_k, frame_ms_repeat=ms_k2, frame_plain_ms=ms_p, mt_ms=mt_ms,
                   mt_plain_ms=mt_plain_ms, mt_walk_ms=walk_ms, mt_walk_plain_ms=walk_plain_ms,
                   mt_prepare_ms=prep_ms, denoise_ms=den_ms, denoise_plain_ms=den_plain_ms,
                   display_ms=display_ms)

    if opts.profile:
        from torch.profiler import ProfilerActivity, profile

        trace.render_frame(data, frame_params, **kw)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            trace.render_frame(data, frame_params, **kw)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        table = prof.key_averages().table(sort_by="cuda_time_total", row_limit=30)
        print(f"profiled frame {tag}: wall {wall_ms:.3f} ms under the profiler")
        print(table)
        results.update(profile_wall_ms=wall_ms, profile_table=table)

    kernels = [
        {"name": "mt_nf", "route": "cuda", "source": "tpu_pathtracer_torch/csrc/mt_shade.cu",
         "replaces": "tpu_pathtracer/ops/pallas/mt_shade.py:308", "launches": launches["mt_nf"],
         "max_abs_err": mt_err, "ms": mt_ms, "plain_ms": mt_plain_ms},
        {"name": "denoise", "route": "cuda", "source": "tpu_pathtracer_torch/csrc/denoise.cu",
         "replaces": "tpu_pathtracer/ops/pallas/denoise.py:33",
         "launches": launches["denoise"], "max_abs_err": den_err, "ms": den_ms,
         "plain_ms": den_plain_ms},
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
