"""The interactive, progressive view, and its check.

Views of `frames_per_view` frames; a frame is `Renderer.render()`, then
`display()` (resize, denoise, tone map), then the displayed image copied to
the host.  After each view one orbit step of `orbit_step_deg` about the
configuration's look-at point and `reset()`, as a user orbiting a converged
image.  The seed picks the first view of the orbit.  Set-up builds the
scene and warms a few frames, a display, a readback and an orbit step.

The check judges displayed images kept in the window where they are shown:
`check_images` of them, the first at the end of a view (the longest
accumulation), the second the first frame of a view (one sample a pixel,
where a pixel that shows another pixel's paths stands out), the rest at
frames drawn from the seed; in each, `check_blocks` blocks of
`check_block`^2 pixels at places drawn from the seed.  The reference traces
every frame of the view up to that image for the block and its denoise
halo, folds the frames into the running mean, denoises and tone-maps the
block.  `median_abs_diff` is the largest over the images of the median
|shown - reference| of the image's values (every checked pixel and
channel).  A path that takes another branch in the two (a hit on a shared
edge, where the two Moller-Trumbore forms round apart) is another Monte
Carlo sample: it moves a few values by up to the whole range, so an
image's mean and maximum are the noise of such paths, while its median
stays at rounding.  The denoise and the running mean blur a fault that
moves samples between pixels, so the radiance the timed path accumulated
at the first frame of that view (`Renderer.accumulation`, copied on the
device when the frame completes) is judged too, before any blur:
`first_frame_gap_share` is the share of its values at the blocks and their
halos off from the reference's by more than `GAP`.  Only the pixels whose
paths branch apart count there.
"""

from __future__ import annotations

import math
import sys
import time

import numpy as np
import torch

from .. import scenes, stats
from ..check import DTYPES, reference_scene
from ..faults import half
from ..reference import post, tracer
from . import Orbit, Outcome, program_camera

GAP = 1e-3  # a radiance or displayed value off by more than this counts in a share


def run(run) -> Outcome:
    pt = run.pt
    cfg, mix = run.cell.config, run.cell.traffic
    width, height, per_view = mix["width"], mix["height"], mix["frames_per_view"]
    rng = np.random.default_rng([run.seed_key, 0])
    step = mix["orbit_step_deg"]
    start = int(rng.integers(round(360.0 / step)))
    orbit = Orbit(cfg["camera"], math.radians(start * step), step)
    picks = np.random.default_rng([run.seed_key, 1])
    probe: list = []  # per view, the frame below the last whose display is kept

    def probe_at(view):
        while len(probe) <= view:
            probe.append(int(picks.integers(1, per_view)))
        return probe[view]

    run.mark("imports")
    renderer = pt.Renderer(
        scenes.program_scene(pt, cfg), program_camera(pt, orbit.view(0), run.device),
        pt.RenderConfig(width=width, height=height, frames=per_view,
                        samples_per_frame=cfg["samples_per_frame"],
                        max_bounces=cfg["max_bounces"], intersector=cfg["intersector"]),
        pt.PostConfig(), device=run.device)
    renderer.scene_data  # compiles the scene
    run.mark("scene")
    for j in (-1, 0):  # warm-up: frames, displays, readbacks, an orbit step
        renderer.camera = program_camera(pt, orbit.view(j), run.device)
        renderer.reset()
        for _ in range(mix["warm_frames"]):
            renderer.render()
            renderer.display().cpu()
    run.sync()
    setup_s = run.mark("warm-up")

    span = run.tracer.span
    latencies, kept, first_hdr = [], [], {}
    view, frame = -1, per_view  # the window's first frame starts view 0 afresh
    with run.tracer:
        with span("window"):
            t_start = t_prev = time.perf_counter()
            while True:
                if frame == per_view:
                    with span("reset"):
                        view += 1
                        renderer.camera = program_camera(pt, orbit.view(view), run.device)
                        renderer.reset()
                        frame = 0
                with span("render"):
                    renderer.render()
                with span("display", timed=True):
                    img = renderer.display()
                    with span("readback"):
                        host = img.cpu().numpy()
                frame += 1
                now = time.perf_counter()
                latencies.append(now - t_prev)
                t_prev = now
                if frame in (1, per_view, probe_at(view)):
                    kept.append((view, frame, host))
                if frame == 1:
                    first_hdr[view] = renderer.accumulation.clone()
                if now - t_start >= run.seconds:
                    break
    if not kept or kept[-1][:2] != (view, frame):
        kept.append((view, frame, host))  # the display at the close is due too
    window = t_prev - t_start
    first_hdr = {v: t.cpu().numpy() for v, t in first_hdr.items()}
    n = len(latencies)
    p95 = stats.percentile(latencies, 95)
    run.log(f"frame_p95_ms: {n} frame latencies in the window, {stats.beyond(latencies, 95)} "
            f"beyond the 95th percentile")
    return Outcome(
        end_to_end={"frame_ms": 1e3 * window / n, "frame_p95_ms": 1e3 * p95, "setup_s": setup_s},
        counts={"frames": n, "display": (height, width)},
        answers={"kept": kept, "first_hdr": first_hdr, "orbit": orbit, "width": width,
                 "height": height})


def _block_pixels(by, bx, block, height, width, device):
    """Pixel coordinates (flat xs, ys) of a block and its denoise halo, and of
    the block alone, with wrap."""
    r = post.RADIUS
    rows = (by - r + torch.arange(block + 2 * r, device=device)) % height
    cols = (bx - r + torch.arange(block + 2 * r, device=device)) % width
    ys, xs = torch.meshgrid(rows, cols, indexing="ij")
    return xs.reshape(-1), ys.reshape(-1), rows[r:r + block], cols[r:r + block]


def _shown(scene, view, frames: int, blocks, block, width, height, bounces, device):
    """What the reference shows at the blocks after `frames` frames of
    `view`, (n_blocks, block, block, 3), and its accumulated radiance at the
    blocks and their halos, (n_blocks * side^2, 3)."""
    tiles = []
    xs, ys = [], []
    for by, bx in blocks:
        x, y, _, _ = _block_pixels(by, bx, block, height, width, device)
        xs.append(x)
        ys.append(y)
    light = tracer.render(scene, view, torch.cat(xs), torch.cat(ys), range(1, frames + 1),
                          width, height, bounces)
    acc = post.running_mean(light)
    side = block + 2 * post.RADIUS
    for i in range(len(blocks)):
        tile = acc[i * side * side:(i + 1) * side * side].reshape(side, side, 3)
        tiles.append(post.aces(post.denoise_block(tile, block)))
    return torch.stack(tiles), acc


def _choose(kept, mix, rng):
    """The kept displays to judge: the end of a view, the first frame of a
    view, then others, each drawn from the seed among its kind."""
    def draw(pool):
        return pool[int(rng.integers(len(pool)))] if pool else None

    ends = [k for k in kept if k[1] == mix["frames_per_view"]]
    picks = [draw(ends) or max(kept, key=lambda k: k[1])]
    first = draw([k for k in kept if k[1] == 1 and k is not picks[0]])
    if first is not None and mix["check_images"] > 1:
        picks.append(first)
    others = [k for k in kept if all(k is not p for p in picks)]
    more = min(len(others), mix["check_images"] - len(picks))
    return picks + [others[i] for i in sorted(rng.choice(len(others), size=more, replace=False))]


def check(config: dict, mix: dict, answers: dict, seed_key: int, device,
          control: str | None = None) -> dict:
    kept = answers["kept"]
    width, height, block = answers["width"], answers["height"], mix["check_block"]
    if (height, width) != (mix["height"], mix["width"]):
        raise ValueError("the check reads displays at render resolution only")
    rng = np.random.default_rng([seed_key, 3])
    ref = reference_scene(config, device, torch.float32)
    low = reference_scene(config, device, DTYPES[control]) if control else None
    medians, first_share = [], float("nan")
    as_host = lambda t: t.float().cpu().numpy()
    for view, frames, host in _choose(kept, mix, rng):
        blocks = [(int(rng.integers(height)), int(rng.integers(width)))
                  for _ in range(mix["check_blocks"])]
        cam = answers["orbit"].view(view)
        shown = lambda scene: _shown(scene, cam, frames, blocks, block, width, height,
                                     config["max_bounces"], device)
        want, want_hdr = map(as_host, shown(ref))
        if low is not None:
            got, got_hdr = map(as_host, shown(low))
        else:
            got, got_hdr = [], []
            for by, bx in blocks:
                xs, ys, rows, cols = _block_pixels(by, bx, block, height, width, "cpu")
                got.append(host[rows.numpy()[:, None], cols.numpy()[None, :]])
                if frames == 1:
                    got_hdr.append(answers["first_hdr"][view][ys.numpy(), xs.numpy()])
            got = np.stack(got)
            got_hdr = np.concatenate(got_hdr) if got_hdr else None
        gap = np.abs(got - want).reshape(-1)
        medians.append(float(np.median(gap)))
        print(f"display gaps: view {view} frame {frames}: {gap.size} values, median "
              f"{medians[-1]!r} mean {float(gap.mean())!r} over {GAP} {float((gap > GAP).mean())!r} "
              f"max {float(gap.max())!r}", file=sys.stderr)
        if frames == 1:
            hdr = np.abs(got_hdr - want_hdr).reshape(-1)
            first_share = float((hdr > GAP).mean())
            print(f"first-frame radiance gaps: view {view}: {hdr.size} values, over {GAP} "
                  f"{first_share!r}, median {float(np.median(hdr))!r} max {float(hdr.max())!r}",
                  file=sys.stderr)
    return {"median_abs_diff": max(medians), "first_frame_gap_share": first_share}


def fault(name: str) -> list:
    from tpu_pathtracer_torch.render import renderer

    if name == "frozen_state":  # the accumulation is never updated
        return [(renderer, "accumulate_op", lambda orig: lambda prev, *a, **k: prev)]
    if name == "half_batch":  # every odd row of each frame copies the row below it
        return [(renderer, "render_frame", lambda orig: lambda *a, **k: half(orig(*a, **k)))]
    if name == "altered_answer":  # the display's red and blue swapped
        return [(renderer, "postprocess", lambda orig: lambda *a, **k: orig(*a, **k)[..., [2, 1, 0]])]
    raise ValueError(f"unknown fault {name!r}")
