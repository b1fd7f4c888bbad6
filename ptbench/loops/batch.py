"""An offline still rendered frame after frame, and its check.

One client renders one view of the scene to convergence, as `cli render
--frames N` does (`Renderer.render_all`): `Renderer.render()` a frame, one
call after another so that the window can close between two frames, up to
the mix's `frames` budget, which no window finishes.  The seed picks the
view among `views` views spaced evenly about the configuration's look-at
point.  Nothing is displayed or read back inside the window: the still is
displayed and copied to the host once, after the window, as `cli render`
writes it.  Set-up builds the scene (its BVH and packing), warms
`warm_frames` frames, a display and a readback, then `reset()`.

A traced window lasts at most `TRACED_SECONDS`: the program's walk runs
as CUDA graphs of small kernels, about 200,000 a second under the
profiler, and the harness takes about 8 s a traced second to reduce them
after the window, so a traced 40 s window would make a run of over six
minutes.  Its per-layer metrics are per frame, as in a full window.

The check judges the still and the radiance the timed path accumulated at
frame 1 (`Renderer.accumulation`, copied on the device when the frame
completes) at `check_blocks` blocks of `check_block`^2 pixels drawn from
the seed, against the reference traced over the same frames, by the two
numbers of `progressive`'s check: `median_abs_diff`, the median |shown -
reference| of the still's values at the blocks, and
`first_frame_gap_share`, the share of frame 1's radiance at the blocks and
their denoise halos off from the reference's by more than `GAP`.
"""

from __future__ import annotations

import math
import sys
import time

import numpy as np
import torch

from .. import scenes
from ..check import DTYPES, reference_scene
from ..reference import post, tracer
from . import Orbit, Outcome, program_camera
from .progressive import GAP, _block_pixels, fault  # noqa: F401  (fault: this loop's faults)

TRACED_SECONDS = 15.0  # the longest traced window


def run(run) -> Outcome:
    pt = run.pt
    cfg, mix = run.cell.config, run.cell.traffic
    width, height, budget = mix["width"], mix["height"], mix["frames"]
    step = 360.0 / mix["views"]
    pick = int(np.random.default_rng([run.seed_key, 0]).integers(mix["views"]))
    view = Orbit(cfg["camera"], math.radians(pick * step), step).view(0)

    run.mark("imports")
    renderer = pt.Renderer(
        scenes.program_scene(pt, cfg), program_camera(pt, view, run.device),
        pt.RenderConfig(width=width, height=height, frames=budget,
                        samples_per_frame=cfg["samples_per_frame"],
                        max_bounces=cfg["max_bounces"], intersector=cfg["intersector"]),
        pt.PostConfig(), device=run.device)
    renderer.scene_data  # compiles the scene
    run.mark("scene")
    renderer.reset()
    for _ in range(mix["warm_frames"]):  # warm-up: frames, a display, a readback
        renderer.render()
    renderer.display().cpu()
    renderer.reset()
    run.sync()
    setup_s = run.mark("warm-up")

    span = run.tracer.span
    seconds = min(run.seconds, TRACED_SECONDS) if run.tracer.enabled else run.seconds
    ends, first_hdr = [], None  # each frame's host end, from the window's start
    with run.tracer:
        with span("window"):
            t_start = time.perf_counter()
            while renderer.frame <= budget:
                with span("render"):
                    renderer.render()
                ends.append(time.perf_counter() - t_start)
                if len(ends) == 1:
                    first_hdr = renderer.accumulation.clone()
                if ends[-1] >= seconds:
                    break
            with span("drain"):
                run.sync()
            window = time.perf_counter() - t_start
    frames = len(ends)
    enqueue = np.diff(ends, prepend=0.0) * 1e3
    run.log(f"frame_ms: {frames} frames in a window of {window:.3f} s; host ms a frame enqueued: "
            f"min {enqueue.min():.1f} median {np.median(enqueue):.1f} max {enqueue.max():.1f}")
    still = renderer.display().cpu().numpy()  # the still `cli render` writes, untimed
    return Outcome(
        end_to_end={"frame_ms": 1e3 * window / frames, "setup_s": setup_s},
        counts={"frames": frames},
        answers={"still": still, "first_hdr": first_hdr.cpu().numpy(), "frames": frames,
                 "view": view, "width": width, "height": height})


def _traced(scene, view: dict, frames: int, blocks, block, width, height, bounces, device):
    """What the reference shows at the blocks after `frames` frames,
    (n_blocks, block, block, 3), and its radiance at frame 1 at the blocks
    and their halos, (n_blocks * side^2, 3)."""
    xs, ys = [], []
    for by, bx in blocks:
        x, y, _, _ = _block_pixels(by, bx, block, height, width, device)
        xs.append(x)
        ys.append(y)
    light = tracer.render(scene, view, torch.cat(xs), torch.cat(ys), range(1, frames + 1),
                          width, height, bounces)
    acc = post.running_mean(light)
    side = block + 2 * post.RADIUS
    tiles = [post.aces(post.denoise_block(acc[i * side * side:(i + 1) * side * side]
                                          .reshape(side, side, 3), block))
             for i in range(len(blocks))]
    return torch.stack(tiles), light[0]


def check(config: dict, mix: dict, answers: dict, seed_key: int, device,
          control: str | None = None) -> dict:
    width, height, block, frames = (answers["width"], answers["height"], mix["check_block"],
                                    answers["frames"])
    rng = np.random.default_rng([seed_key, 3])
    blocks = [(int(rng.integers(height)), int(rng.integers(width)))
              for _ in range(mix["check_blocks"])]
    traced = lambda scene: [t.float().cpu().numpy() for t in _traced(
        scene, answers["view"], frames, blocks, block, width, height, config["max_bounces"],
        device)]
    want, want_hdr = traced(reference_scene(config, device, torch.float32))
    if control:
        got, got_hdr = traced(reference_scene(config, device, DTYPES[control]))
    else:
        got, got_hdr = [], []
        for by, bx in blocks:
            xs, ys, rows, cols = _block_pixels(by, bx, block, height, width, "cpu")
            got.append(answers["still"][rows.numpy()[:, None], cols.numpy()[None, :]])
            got_hdr.append(answers["first_hdr"][ys.numpy(), xs.numpy()])
        got, got_hdr = np.stack(got), np.concatenate(got_hdr)
    gap = np.abs(got - want).reshape(-1)
    hdr = np.abs(got_hdr - want_hdr).reshape(-1)
    median, share = float(np.median(gap)), float((hdr > GAP).mean())
    print(f"still gaps after {frames} frames: {gap.size} values, median {median!r} mean "
          f"{float(gap.mean())!r} over {GAP} {float((gap > GAP).mean())!r} max "
          f"{float(gap.max())!r}", file=sys.stderr)
    print(f"first-frame radiance gaps: {hdr.size} values, over {GAP} {share!r}, median "
          f"{float(np.median(hdr))!r} max {float(hdr.max())!r}", file=sys.stderr)
    return {"median_abs_diff": median, "first_frame_gap_share": share}
