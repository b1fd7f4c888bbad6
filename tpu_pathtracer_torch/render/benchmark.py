"""The benchmark harness: the rays/s measurement behind `cli benchmark`
(one definition of the headline metric).

The port of `tpu_pathtracer.render.benchmark`, with its records and gates.
One "ray" is one ray-vs-scene intersection: W*H pixels x spp x max_bounces
intersections per frame.

Methodology, as in the JAX package:

  1. The whole budget of n frames runs as one call (`make_budget`: a Python
     loop of progressive frames folded into one accumulation), and every
     timed repetition ends with `torch.cuda.synchronize()` (on the CPU the
     work is done when the call returns).
  2. Two budget sizes n and 2n are timed (medians over reps); the SLOPE
     (T(2n) - T(n)) / n is the per-frame time, so the fixed cost of a call
     cancels.
  3. Linearity gate: the slope must match T(2n)/2n within `linearity_tol`;
     if doubling the work does not roughly double the time, the number is
     refused or the slower estimate published.
  4. Device-time cross-check: the budgets of n and 2n frames once each
     under torch.profiler (`utils.devtime.device_time`); the slope of their
     summed CUDA activity, (D(2n) - D(n)) / n, is reported beside the wall
     slope, the fixed device cost of a call cancelled as in the wall slope
     (the JAX package divides one run's device time by n).  Device time
     above twice the wall slope means the wall clock missed the work, and
     the number is refused.
  5. Physics gate: the throughput the slope implies, at a minimal cost per
     ray, must stay under the H100 SXM data sheet's peaks.

`bench_scaling` is the sharded mesh-size table: the same slope method over
`parallel.sharded.make_sharded_render_all` at growing tile counts.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

# Ceilings of the physics gate: the H100 SXM data sheet's dense tensor-core
# peak (989 TFLOP/s, bf16) and its HBM3 rate (3.35 TB/s).  Generous on
# purpose: the gate catches orders-of-magnitude artifacts, not 10% noise.
HW_PEAK_FLOPS = 989e12
HW_PEAK_HBM_BPS = 3.35e12
# Minimum honest per-ray-bounce cost model: one node/triangle fetch (32 B)
# and ~60 flops of intersection math.
MIN_BYTES_PER_RAY = 32.0
MIN_FLOPS_PER_RAY = 60.0


@dataclasses.dataclass
class BenchResult:
    rays_per_s: float
    per_frame_s: float  # slope-based
    t_n1_s: float
    t_n2_s: float
    n1: int
    n2: int
    spread_rel: float  # (max-min)/median at n2
    linearity: float  # slope vs T(n2)/n2 agreement ratio (1.0 = perfect)
    device_per_frame_s: Optional[float]  # profiler-backed, None if unavailable
    compile_s: float  # the first budget call: kernel build and warm-up
    ok: bool
    reasons: list

    @property
    def rays_per_frame(self) -> int:
        return self._rays_per_frame

    _rays_per_frame: int = 0


def make_budget(width: int, height: int, spp: int, bounces: int, aspect=None,
                intersector: str = "auto", post=None):
    """Build fn(scene, params0, n_frames) rendering n progressive frames
    (frames 1..n) into one accumulation, folded in place, as `Renderer`
    does; returns the accumulated (H, W, 3) image.  With `post` (a
    PostConfig) every frame also runs the fullscreen pass (denoise and
    tonemap) on the accumulation, as the reference draws it every frame, and
    the display image is returned."""
    import torch

    from ..post.pipeline import postprocess
    from .renderer import make_frame_step

    aspect = aspect if aspect is not None else width / height
    step = make_frame_step(width, height, aspect, spp, bounces, True, intersector=intersector)

    def budget(scene_d, params0, n_frames: int):
        acc = torch.zeros((height, width, 3), dtype=torch.float32,
                          device=scene_d.packed.tri_pos.device)
        disp = acc
        for f in range(int(n_frames)):
            step(scene_d, dataclasses.replace(params0, frame=f + 1), acc)
            if post is not None:
                disp = postprocess(acc, post)
        return disp if post is not None else acc

    return budget


def _sync(out) -> None:
    """Wait for the device work behind `out` (a tensor)."""
    import torch

    if out.is_cuda:
        torch.cuda.synchronize(out.device)


def _timed(fn, reps: int, clock) -> list:
    """Times of fn() until its device work is done, `reps` of them."""
    ts = []
    for _ in range(reps):
        t0 = clock()
        _sync(fn())
        ts.append(clock() - t0)
    return ts


def measure_budget(
    budget,
    scene_data,
    cam,
    *,
    width: int,
    height: int,
    spp: int,
    bounces: int,
    reps: int = 3,
    target_seconds: float = 1.5,
    max_frames: int = 512,
    linearity_tol: float = 0.15,
    profile: bool = True,
    deadline: Optional[float] = None,
    log: Callable[[str], None] = lambda s: None,
    clock: Callable[[], float] = time.perf_counter,
    device_time=None,
) -> BenchResult:
    """Measure the per-frame time of `budget` with the slope method (see
    the module docstring).  `ok=False` means the number failed a gate and
    must not be published as a headline.

    n1 is sized so that the fixed cost of a call (estimated from T(1) and
    T(2)) is at most 10% of T(n1).  `deadline` (a `clock()` value) skips
    the profiler cross-check once more than 120 s past it.  `clock` and
    `device_time` (default `utils.devtime.device_time`) can be replaced,
    for tests of the gates."""
    import numpy as np

    from ..scene.types import RenderParams

    if device_time is None:
        from ..utils.devtime import device_time
    params = RenderParams.create(cam, frame=1)
    device = scene_data.packed.tri_pos.device

    def run(n):
        return lambda: budget(scene_data, params, n)

    # --- first call (kernel build) + calibrate n1 ---------------------------
    t0 = clock()
    _sync(budget(scene_data, params, 1))
    compile_s = clock() - t0
    t1 = min(_timed(run(1), 2, clock))
    t2 = min(_timed(run(2), 2, clock))
    # T(n) ~= latency + n * frame; require T(n1) >= 10x latency.
    frame_est = max(t2 - t1, 1e-5)
    latency_est = max(2 * t1 - t2, 0.0)
    n1 = int(max(1, min(max_frames // 2,
                        max(round(target_seconds / frame_est),
                            np.ceil(9.0 * latency_est / frame_est)))))
    n2 = 2 * n1
    log(f"calibrate: T(1)={t1*1e3:.1f}ms T(2)={t2*1e3:.1f}ms "
        f"(frame~{frame_est*1e3:.1f}ms latency~{latency_est*1e3:.1f}ms) -> n1={n1}, n2={n2}")

    # --- timed points (medians) -------------------------------------------
    ts1 = sorted(_timed(run(n1), reps, clock))
    ts2 = sorted(_timed(run(n2), reps, clock))
    t_n1 = ts1[len(ts1) // 2]
    t_n2 = ts2[len(ts2) // 2]
    spread = (ts2[-1] - ts2[0]) / t_n2
    slope = (t_n2 - t_n1) / (n2 - n1)

    reasons = []
    ok = True
    if slope <= 0:
        ok = False
        reasons.append(f"non-increasing time: T({n1})={t_n1:.3f}s T({n2})={t_n2:.3f}s")
        slope = t_n2 / n2  # fall back to the most conservative estimate

    # --- linearity gate -------------------------------------------------------
    linearity = slope / (t_n2 / n2) if t_n2 > 0 else 0.0
    if abs(1.0 - linearity) > linearity_tol:
        if t_n2 < 1.5 * t_n1:
            # Doubling the work barely moved the time: the measurement is
            # bound by the fixed cost of a call, not by the work; refuse it.
            ok = False
            reasons.append(
                f"linearity fail: T({n1})={t_n1:.3f}s vs T({n2})={t_n2:.3f}s "
                f"(slope {slope*1e3:.2f}ms, T(n2)/n2 {t_n2/n2*1e3:.2f}ms, ratio {linearity:.2f})")
        # Publish the conservative (slower) of the two estimates.
        slope = max(slope, t_n2 / n2)

    # --- device-time cross-check ------------------------------------------------
    device_per_frame = None
    if profile and deadline is not None and clock() > deadline + 120.0:
        log("profiler cross-check skipped: past deadline grace")
        profile = False
    if profile:
        # the device time's own slope over the same two budgets, so a fixed
        # device cost of a call cancels as it does in the wall slope
        d1 = device_time(run(n1), device=device)
        d2 = device_time(run(n2), device=device) if d1["ok"] else d1
        if d2["ok"] and d2["total_s"] > d1["total_s"] > 0:
            device_per_frame = (d2["total_s"] - d1["total_s"]) / (n2 - n1)
            log(f"profiler device time: {device_per_frame*1e3:.2f} ms/frame "
                f"(wall slope {slope*1e3:.2f} ms/frame)")
            if device_per_frame > 2.0 * slope:
                ok = False
                reasons.append(
                    f"device time {device_per_frame*1e3:.2f}ms/frame exceeds wall slope "
                    f"{slope*1e3:.2f}ms/frame by >2x: wall timing did not capture execution")
                slope = device_per_frame
        elif d2["ok"]:
            log(f"profiler device time not increasing: {d1['total_s']:.6f} s at {n1} frames, "
                f"{d2['total_s']:.6f} s at {n2}")
        else:
            log(f"profiler unavailable: {d2.get('error', 'no device events')}")

    # --- physics gate -----------------------------------------------------------
    rays_per_frame = width * height * spp * bounces
    rays_per_s = rays_per_frame / slope if slope > 0 else 0.0
    implied_flops = rays_per_s * MIN_FLOPS_PER_RAY
    implied_bps = rays_per_s * MIN_BYTES_PER_RAY
    log(f"physics: implied {implied_flops/1e12:.2f} TFLOP/s (peak {HW_PEAK_FLOPS/1e12:.0f}), "
        f"{implied_bps/1e9:.1f} GB/s (peak {HW_PEAK_HBM_BPS/1e9:.0f})")
    if implied_flops > HW_PEAK_FLOPS or implied_bps > HW_PEAK_HBM_BPS:
        ok = False
        reasons.append(
            f"exceeds hardware: {implied_flops/1e12:.1f} TFLOP/s or "
            f"{implied_bps/1e9:.0f} GB/s implied at {rays_per_s:.2e} rays/s")

    res = BenchResult(
        rays_per_s=rays_per_s, per_frame_s=slope, t_n1_s=t_n1, t_n2_s=t_n2, n1=n1, n2=n2,
        spread_rel=spread, linearity=linearity, device_per_frame_s=device_per_frame,
        compile_s=compile_s, ok=ok, reasons=reasons,
    )
    res._rays_per_frame = rays_per_frame
    return res


def bench_config(
    scene_data,
    cam,
    *,
    width: int,
    height: int,
    spp: int,
    bounces: int,
    aspect: Optional[float] = None,
    reps: int = 3,
    target_seconds: float = 1.5,
    intersector: str = "auto",
    post=None,
    deadline: Optional[float] = None,
    log: Callable[[str], None] = lambda s: None,
) -> BenchResult:
    """Convenience: build the budget and measure it."""
    budget = make_budget(width, height, spp, bounces, aspect, intersector, post=post)
    return measure_budget(
        budget, scene_data, cam, width=width, height=height, spp=spp, bounces=bounces,
        reps=reps, target_seconds=target_seconds, deadline=deadline, log=log,
    )


def bench_scaling(
    scene_data,
    cam,
    *,
    width: int = 256,
    height: int = 256,
    spp: int = 1,
    bounces: int = 4,
    tile_counts=(1, 2, 4, 8),
    reps: int = 3,
    target_seconds: float = 1.0,
    max_frames: int = 512,
    log: Callable[[str], None] = lambda s: None,
) -> list:
    """Mesh-size scaling table: the slope-timed per-frame cost of the
    sharded whole-budget render (`make_sharded_render_all`) at growing tile
    counts, with parallel efficiency against tiles=1.  Every rank of the
    process group calls it (one process without a group: tiles=1 only); a
    tile count above the world size, or not dividing `height`, is skipped
    and logged.  Each tile count's ranks time their own budgets (no
    profiler cross-check, as in JAX); the row holds the slowest rank's
    slope, the same on every rank.  Ranks outside a count's mesh do no
    work.  `max_frames` caps the calibrated budget (`measure_budget`).
    Returns [{tiles, per_frame_s, efficiency, ok}, ...]."""
    import torch
    import torch.distributed as dist

    from ..parallel import sharded
    from ..parallel.mesh import make_mesh

    grouped = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if grouped else 1
    device = scene_data.packed.tri_pos.device
    rows = []
    base = None
    for tiles in tile_counts:
        if tiles > world or height % tiles:
            log(f"scaling: skip tiles={tiles} (ranks={world}, height={height})")
            continue
        mesh = make_mesh(tiles=tiles, samples=1, device=device)
        # [slope, not ok]: outside ranks add zeros to the max
        res = torch.zeros(2, dtype=torch.float64, device=device)
        if mesh.in_mesh:
            render_all = sharded.make_sharded_render_all(
                mesh, width=width, height=height, aspect=width / height,
                samples_per_frame=spp, max_bounces=bounces,
            )
            r = measure_budget(
                lambda scene, params, n: render_all(scene, params, n), scene_data, cam,
                width=width, height=height, spp=spp, bounces=bounces, reps=reps,
                target_seconds=target_seconds, max_frames=max_frames, profile=False, log=log,
            )
            res[0], res[1] = r.per_frame_s, float(not r.ok)
        if grouped:
            dist.all_reduce(res, op=dist.ReduceOp.MAX)
        per_frame, ok = float(res[0]), not bool(res[1])
        if base is None:
            base = per_frame
        eff = base / (per_frame * tiles) if per_frame > 0 else 0.0
        rows.append({"tiles": tiles, "per_frame_s": per_frame, "efficiency": eff, "ok": ok})
        log(f"scaling tiles={tiles}: {per_frame*1e3:.2f} ms/frame, "
            f"efficiency {eff*100:.0f}% (ok={ok})")
    return rows


def headline_record(result: BenchResult, backend: str,
                    paths_per_s: Optional[float] = None) -> dict:
    """The one-line JSON record of `cli benchmark`, with the JAX package's
    keys (the value against 1e9 rays/s a chip).  `paths_per_s` is the
    useful-work companion metric (completed camera paths per second =
    W*H*spp / frame time)."""
    rec = {
        "metric": f"ray_scene_intersections_per_s_{backend}",
        "value": result.rays_per_s,
        "unit": "rays/s",
        "vs_baseline": result.rays_per_s / 1e9,
        "per_frame_ms": result.per_frame_s * 1e3,
        "compile_s": result.compile_s,
        "linearity": result.linearity,
    }
    if result.device_per_frame_s is not None:
        rec["device_per_frame_ms"] = result.device_per_frame_s * 1e3
        rec["device_ms_source"] = "profiler"
    if paths_per_s is not None:
        rec["paths_per_s"] = paths_per_s
    if not result.ok:
        rec["suspect"] = True
        rec["reasons"] = result.reasons
    return rec
