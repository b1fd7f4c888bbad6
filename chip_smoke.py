"""Smoke run of tpu_pathtracer_torch on one CUDA card.

    python3 chip_smoke.py [--profile] [--out DIR]

Builds the port's CUDA kernels from csrc/, holds each against its plain
PyTorch version on the card, then drives these paths once each through the
public entry points:

  * headline: `Renderer(...).render_all()` and `display()` on the default
    scene (1,998 triangles) at 512x512, 1 sample per pixel, 4 bounces, 16
    frames, with denoise and ACES; its intersections go through the
    near-to-far MT kernel (csrc/nf_walk.cu);
  * stress: the same on the JAX sweep's stress100K_512 scene (a
    101,760-triangle sphere and a plane, padded to 131,072) at 512x512, 1
    sample per pixel, 6 bounces, 4 frames; its intersections go through
    the streamed MT kernel (csrc/stream_walk.cu);
  * training: `diff.invert` with the JAX CLI's `invert` defaults (the
    default scene under a 512x1024 gradient sky, 256x256, 1 sample per
    pixel, 4 bounces, materials.color from np.random.default_rng(0), Adam
    at 5e-2, 60 steps), through the near-to-far kernel and torch autograd;
    then the loss gradient at the initial colors with TPT_CULL=list and
    =cond, through the list and cond kernels (csrc/nf_walk.cu,
    csrc/cond_walk.cu), and with intersector='bvh8' (the fat-leaf BVH
    walk, csrc/fat_walk.cu);
  * cond end to end: the headline frame and the training step under
    TPT_CULL=nf and =cond, in turns, with cond's wrapper split into its
    parts (padding and packing, boxes, table repack, walk);
  * round-2 MT: `mt_intersect_pallas` and `mt_intersect_stream` (both
    launch the Hopper walk of csrc/r2_walk.cu) on the headline camera's
    262,144 primary rays, and the streamed one on the stress scene's; each
    held to its plain version, walk counts included, and its kernel timed
    twice, beside its bound and critical-path bound;
  * intersectors: `render_frame(intersector='mt' | 'bvh' | 'bvh8')` on the
    headline scene at 512x512, 1 sample per pixel, 4 bounces (the plain
    loop, no MT kernel), each against the near-to-far kernel's frame;
  * large scene: `Renderer(...).render_all()` and `display()` on the JAX
    bench's mesh_scene(640) (a 408,322-triangle sphere and a plane, padded
    to 524,288) at 512x512, 1 sample per pixel, 6 bounces, 2 frames: 'auto'
    takes the 'bvh8' walk, past the MT kernels' 262,144-triangle cap, one
    fat walk kernel launch (csrc/fat_walk.cu) a bounce; its primary rays
    also go through 'bvh', which must find the same hits; then the fat
    walk kernel on the primary and first-bounce rays a 'bvh8' frame hands
    it, bit-equal to the torch walk, its node count equal to the torch
    walk's, timed by CUDA events beside its bound and the torch walk;
  * MXU determinants (kernel #5): the headline shape through
    `render.benchmark.make_budget` under TPT_MXU_DETS=0 and =1, timed by
    `utils.devtime.device_time` and the host clock (the JAX package's
    round-5 sweep), and one frame under TPT_MXU_DETS=1 with TPT_CULL=list
    and =cond (csrc/mxu_walk.cu); the MXU variants of nf, list and cond
    are held at sub-treelets of 32, 64 and 128 on the headline rays to
    their plain versions and to the FP32 kernels by
    `mt_shade.hit_agreement`'s rule, nf's and cond's walk counts to within
    1% of tiles of their plain versions'; each profiled make_budget call
    prints the profiler's records of the walk kernel beside the wrapper's
    launches;
  * CLI: `tpu_pathtracer_torch.cli` in this process: `benchmark` at the
    headline shape, `render` with --timing, --checkpoint and --resume
    (equal to a fresh render bit for bit), and `render --env sky:...`;
  * render options, at the headline shape: one `Renderer` frame with
    `env_importance=True` on the default scene under the sun-sky
    environment (elevation 30, azimuth 90, turbidity 3) and one with
    `RenderConfig(blue_noise=True)` on the headline scene, each with
    `display()`, through the nf and denoise kernels, held to the same
    frame through the plain versions (bit-equal, else the outlier rule)
    and timed in turns with the option off (off, on, on, off); the
    headline frame with sort windows 0 and 32,768 (bit-equal images, frame
    times in turns, the sort alone by CUDA events and the profiler's sort
    kernels of one frame); the native BVH builder against numpy's on the
    stress scene's triangles (byte-equal, both host times) and the large
    scene's compile with it; `cli render --env sky --env-importance
    --blue-noise`;
  * sharded (`parallel/`), at the headline shape: in this process the 2
    tile bands and the 2x2 shards through `render_frame`'s band hooks
    (row_offset, full_height, seed_salt), the nf walk launched once a
    bounce a band, the bands' composite against the unsharded frame
    (differing pixels counted, the outlier rule), the plain loop's ('mt')
    bands bit-equal; then two ranks sharing the card, spawned with gloo
    (`parallel.dryrun.run`, `_sharded_rank`): the 2-tile sharded step and
    `Renderer(shard=ShardConfig(2)).render_all()` + `display()` (their nf
    and denoise launches counted in each rank) against the unsharded frame
    and Renderer, a 1x2 mesh against the mean of the unsalted and salted
    frames bit for bit, `make_sharded_value_and_grad` at the training
    step's size against the unsharded gradient (loss rtol 1e-5, gradients
    atol 1e-6 / rtol 1e-4, not doubled), the sharded and unsharded frames
    in turns, the all-reduce of the image on gloo and `bench_scaling` at
    tiles 1 and 2 (two ranks on one card: no claim of scaling), the ranks
    rendering rank 0's scene and camera as `multihost.replicate` broadcasts
    them over gloo (rank 1 starts from a black sky and another camera);
    then `cli render --shard-tiles 2` under torchrun, two ranks on the one
    card (they join with gloo, the ranks outnumbering the cards), its
    accumulation (.hdr) against the unsharded CLI's; then one NCCL rank whose (1, 1) step
    equals the unsharded frame, before and after an all-reduce.  A rank
    that fails or outlasts SHARD_TIMEOUT fails the run;
  * gltf+viewer, at 512x512, 1 sample per pixel, 6 bounces: the default
    scene (`cli export`) and the stress scene's mesh_scene(320)
    (`io.gltf.save_glb`) written to GLB plain, Draco lossless and Draco
    14/10 bits, loaded back with normalize=False and rendered through
    'auto' (the nf kernel for the default scene, the streamed one for the
    mesh): the lossless frame equal to the plain GLB's bit for bit, the
    plain GLB's to the procedural scene's (bit-equal, else the outlier
    rule), the 14-bit positions within one quantisation step, each frame
    timed in turns with the procedural one; `cli render --scene` of the
    Draco mesh GLB (normalized) and `cli export --draco`; a ViewerServer on
    127.0.0.1:0 with its session on the card, which gets the Draco mesh GLB
    through /upload/scene, serves 16 progressive frames, /frame.png
    (display(), so the denoise kernel) and resets on /params;
  * wavefront: `ops.wavefront.render_frame_wavefront` (torch ops, no
    kernel) at 512x512, 4 bounces, chunk 2048, with sort_rays True and
    False and at 500x500 (padded to the chunk), each bit-equal to
    `render_frame(intersector='bvh')` and within the outlier rule of the
    nf frame, and one stress-scene frame (6 bounces) bit-equal to its bvh
    frame; no MT kernel may launch; wavefront and bvh frames timed in
    turns.  The 500x500 frame takes a camera built on the CPU over the
    CUDA scene, and so does one headline `render_frame`, which must equal
    the card camera's frame bit for bit;
  * precull: the walks' precull kernel (csrc/precull.cu) on the inputs
    the nf wrapper (default scene, 32 sub boxes) and the streamed wrapper
    (stress scene, 64 super boxes) hand it, on primary and first-bounce
    rays, bit-equal to `_precull_live_subs_plain` (counts, lists, emins);
    on the primary rays the kernel alone, one call and the plain version
    timed beside its bound; on both main paths one precull launch a walk;
  * checked render: `utils.debug.checked_render_frame` at the headline
    shape (no error, bit-equal to the unchecked frame, its nf launches
    counted, timed in turns with the unchecked frame); then, in a child
    process (`--fault-child`), a NaN camera position, a zero camera
    direction and a material index past the table, each through the
    checked render, and an out-of-range index given to each index op on
    CUDA tensors, which the mode clamps (no device-side assert).

The near-to-far, list, cond, streamed and MXU walks are Hopper redesigns
(csrc/nf_walk.cu, csrc/cond_walk.cu, csrc/stream_walk.cu,
csrc/mxu_walk.cu).  Their walk phase holds each FP32 walk bit for bit to
the plain walk with equal per-tile walk counts, and each MXU walk to its
plain walk by `hit_agreement` with walk counts within 1% of tiles, on the
headline scene (nf, list, cond and their MXU variants at sub 64, and
streamed) and the stress scene (streamed), primary and first-bounce rays;
prints each case's per-tile walk distribution (mean, max, the five
heaviest tiles), the walk's kernel timed twice, the table repack timed
apart, the walk bound (the walk's own pairs and slab tests)
and the critical-path bound (the heaviest tile's work over the FP32, or
for the MXU walks the TF32 and FP32, share of the SMs it runs on), and
the kept designs' registers, shared memory and CTAs per SM.  The nf, list
and cond walk counts are also held to the plain walk's at every sub of
the cull phase.  The denoise phase holds the tiled kernel
(csrc/denoise.cu) to the plain version at 512x512, 1080x1920, 300x517 and
6x10 and at a second radius, and times the kernel launch alone and the
whole wrapper call apart, each twice, at 512x512 and 1080x1920.  A kernel's
time (`_kernel_ms`) is CUDA events around launches queued back to back
behind a sleep kernel; the profiler only checks which kernel they launch.

For each path it checks that the path's kernels were launched in that run
(and the other MT kernels not), that what comes out is right (images
finite and in [0, 1], a frame through the kernels matching the same frame
through the plain versions; the CLI's rule final loss < 0.5 x first loss;
list and cond gradients matching nf's, bvh8's on the pixels where the
frames agree), and times it with CUDA
events against the plain versions.  Every culling variant (nf, list, cond) is
held bit for bit to its plain version at sub-treelets of 32, 64 and 128
triangles on the headline rays; the cond and streamed kernels also to
their plain versions' per-tile walk counts, so they made the same culling
decisions; so are the round-2 kernels.  Each kernel's entry also gives its
bound: the larger of the FP32 operations its work on these inputs needs
over the H100's non-tensor FP32 peak (for the MXU variants, the
determinants' tensor-core flops over the TF32 peak beside the rest) and
the bytes it must move over the HBM rate (H100 SXM: 3.35 TB/s), and
"library_ms": null, since no one
PyTorch call computes a nearest Möller–Trumbore hit or the bilateral
denoise.

The line before the last is a JSON object with one entry per kernel; the
last line is {"ok": true, "device": {...}}.  Any failed check raises, so
the exit code is not 0 and no result line is printed.  Without a CUDA
device the script exits with code 2.  `--profile` adds a torch.profiler
table of one frame of each render path and of one training step; `--out DIR` writes the full results there as chip_smoke.json.
"""

from __future__ import annotations

import argparse
import json
import math
import re
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
STRESS_SEGMENTS = 320  # bench.py:105 mesh_scene(320): 101,760 triangles, padded to 131,072
CAMERA = dict(position=(0.0, 1.0, 4.0), look_at=(0.0, 0.5, 0.0), fov=45.0)
DENOISE_TOL = dict(atol=2e-5, rtol=1e-4)  # tests/test_pallas_denoise.py
MT_TOL = 0.0  # kernel and plain version share every rounding step
INVERT_SIZE = 256  # the JAX CLI's `invert` defaults (cli.py:27-62, 398-402)
INVERT_STEPS = 60
INVERT_LR = 5e-2
INTERSECTORS = ("mt", "bvh", "bvh8")  # the plain-loop intersectors (torch ops)
LARGE_SEGMENTS = 640  # bench.py:84-91 mesh_scene(640): 408,322 triangles, padded to 524,288
LARGE_FRAMES = 2
LARGE_BOUNCES = 6
# The roofline terms.  FP32 operations per (ray, triangle) pair as each MT
# kernel's source issues them: 19 products and 15 sums for the four
# determinants, then nf: 3 sign products, EPSILON*|a| and us + vs (39);
# round 2: 2 sign products, 1/a, ta*f and us + vs (40).  Compares and
# selects are not counted.  A slab test of one ray and one box: per axis 2
# differences, 2 products, a min and a max (18).
PAIR_OPS_NF = 39
PAIR_OPS_R2 = 40
SLAB_OPS = 18
H100_FP32 = 67e12  # FLOP/s, non-tensor FP32, H100 SXM data sheet
H100_HBM = 3.35e12  # bytes/s, H100 SXM data sheet
H100_TF32 = 495e12  # FLOP/s, dense TF32 tensor cores, H100 SXM data sheet
# The MXU variants' work per (ray, triangle) pair: the four determinants'
# 19 nonzero coefficient terms (a 3, ua 6, va 6, ta 4; the zero padding of
# K to 16 and the zero coefficients are layout, not work) as 3 TF32 passes
# of multiply-adds on the tensor cores (3 x 2 x 19 flops), and the
# epilogue's 5 FP32 operations (3 sign products, EPSILON*|a|, us + vs).
PAIR_FLOPS_MXU = 3 * 2 * 19
PAIR_OPS_MXU_EPILOGUE = 5
# The fat-leaf walk's work (csrc/fat_walk.cu).  A node row visited: its box
# test, per axis 2 differences, 2 quotients, a min and a max (18 in all),
# and 9 floats read (box and links).  A leaf triangle tested: 6 edge
# differences, two cross products (12 products, 6 differences), four dots
# (12 products, 8 sums), 1 / a, three products by it, 3 differences for s
# and u + v (51), and its 9 floats read.
FAT_ROW_OPS = 18
FAT_TRI_OPS = 51
SWEEP_FRAMES = 8  # frames of each timed make_budget call of the sweep phase


def _card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0].strip()


def _ptxas_summary(log: str) -> list:
    """One line per compiled kernel of the build log: its name with the
    template arguments (`<1,64,1>`: RPT 1, SUB 64, ...), registers,
    shared memory and spills, as ptxas -v reports them."""
    import re

    def short(mangled):  # the last <length><name>IL...E of the mangled name
        found = mangled
        for i in range(len(mangled)):
            for k in (1, 2):
                if not mangled[i:i + k].isdigit():
                    continue
                start, end = i + k, i + k + int(mangled[i:i + k])
                args = re.match(r"I((?:L[ib]\d+E)+)E", mangled[end:])
                if args and mangled[start:end].isidentifier():
                    found = (mangled[start:end] + "<"
                             + ",".join(re.findall(r"\d+", args.group(1))) + ">")
        return found

    lines, name = [], None
    for line in log.splitlines():
        if "Compiling entry" in line:
            name = short(line.split("'")[1])
        elif name and "spill" in line:
            spill = line.split(":")[-1].strip()
        elif name and "Used" in line:
            lines.append(f"{name}: {line.split(':')[-1].strip()}; {spill}")
            name = None
    return lines


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


def _device_time(fn, match: str = "", tries: int = 3) -> dict:
    """`utils.devtime.device_time` of one call of `fn`, profiled again (up
    to `tries` calls in all) while the profiler records no device activity
    at all: now and then it returns an empty trace.  A trace that holds any
    activity is returned as it is, so the checks on its kernels still
    apply."""
    from tpu_pathtracer_torch.utils.devtime import device_time

    for _ in range(tries):
        got = device_time(fn, match=match)
        if got["programs"]:
            break
        print(f"the profiler recorded no device activity (match {match!r}); profiling again")
    return got


def _kernel_ms(fn, match: str, n: int = 50, rounds: int = 3) -> float:
    """Milliseconds a call of `fn()`, which launches one kernel whose name
    contains `match` and no other work, by CUDA events.  Each round queues
    n calls between two CUDA events behind a sleep kernel, so the card runs
    them back to back without waiting on the host (checked: the first event
    has not run when the last call is queued); the reading includes the
    gaps between launches.  Median over the rounds.  A profiled batch of n
    calls first checks that `fn` launches that kernel: the profiler must
    record at least one and at most n of them.  Its durations are not
    used: torch.profiler drops kernel records now and then, and its
    kernel durations do not sum to the events' interval (PERF.md)."""
    import torch

    def batch():
        for _ in range(n):
            fn()

    got = _device_time(batch, match=match)
    _check(0 < got["count"] <= n, f"the profiler recorded {got['count']} {match} kernels for "
           f"{n} launches: {got}")
    times = []
    sleep = 2 ** 25  # cycles, about 17 ms at 1.98 GHz
    while len(times) < rounds:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(sleep)  # the card busy while the host queues the calls
        start.record()
        batch()
        ahead = not start.query()
        end.record()
        end.synchronize()
        if not ahead:  # the queue ran dry: sleep longer
            sleep *= 2
            _check(sleep <= 2 ** 30, f"{match}: {n} calls take longer to queue than 0.5 s")
            continue
        times.append(start.elapsed_time(end) / n)
    return statistics.median(times)


def _fmt_ms(xs) -> str:
    """Milliseconds to 4 places."""
    return ", ".join(f"{x:.4f}" for x in xs)


def _clocks() -> str:
    """The card's SM clock, its maximum and its power draw, as nvidia-smi
    reads them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60).stdout.strip()


def _check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def _bound(ops: float, nbytes: float):
    """(least ms, what binds): the larger of ops over the FP32 peak and
    bytes over the HBM rate."""
    ops_ms, bytes_ms = ops / H100_FP32 * 1e3, nbytes / H100_HBM * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def _mt_bytes(n_tris: int, n_rays: int, table_floats: int = 40) -> int:
    """An MT kernel's inputs read once and outputs written once: ten ray
    features a ray, the coefficient table (40 floats a triangle), t, idx,
    u and v a ray."""
    return 4 * (10 * n_rays + table_floats * n_tris + 4 * n_rays)


def _cull_work(mt_shade, tri_pos, phi, cull, mxu=False):
    """The work of one whole-scene MT wrapper call (sub 64) on these rays:
    (ray-triangle pairs of the evaluated subs, slab tests of the precull for
    nf and list, every ray against every sub box, or of cond's chunk and
    sub tests), from the plain walk's counts."""
    import torch

    sub = mt_shade.SUB_TRIS
    n = tri_pos.shape[0]
    if cull == "cond":
        stats = mt_shade.cond_walk_stats(tri_pos, phi, sub=sub, plain=True, mxu=mxu)
        tile = mt_shade._tile_rays(None)
        live, evaluated = (int(x) for x in stats.sum(dim=0))
        n_chunks = -(-n // mt_shade.CHUNK_TRIS)
        slabs = (stats.shape[0] * n_chunks + live * (mt_shade.CHUNK_TRIS // sub)) * tile
    else:
        prep = mt_shade._prepare(tri_pos, phi, None, sub)
        phi_pad, lists, tile = prep[0], prep[3], prep[-1]
        slabs = phi_pad.shape[1] * lists.shape[1]
        if cull == "list":
            evaluated = int(prep[2].sum())
        else:
            stats = torch.zeros((lists.shape[0],), dtype=torch.int32, device=phi.device)
            mt_shade._walk_plain(*prep, stats=stats, mxu=mxu)
            evaluated = int(stats.sum())
    return evaluated * sub * tile, slabs


def _cull_bound(mt_shade, tri_pos, phi, cull):
    """Bound of one FP32 whole-scene MT wrapper call (sub 64): its pairs'
    and slab tests' FP32 operations against the bytes."""
    pairs, slabs = _cull_work(mt_shade, tri_pos, phi, cull)
    return _bound(pairs * PAIR_OPS_NF + slabs * SLAB_OPS, _mt_bytes(tri_pos.shape[0], phi.shape[1]))


def _mxu_bound(mt_shade, tri_pos, phi, cull):
    """Bound of one MXU wrapper call (sub 64) on the pairs and slab tests of
    its own walk: the larger of the determinants' tensor-core flops over the
    TF32 peak, the FP32 operations (epilogue and slab tests) over the FP32
    peak, and the bytes (40 floats a triangle, as the FP32 form) over the
    HBM rate; but never above the same work's bound in the FP32 form, which
    computes the same function."""
    pairs, slabs = _cull_work(mt_shade, tri_pos, phi, cull, mxu=True)
    nbytes = _mt_bytes(tri_pos.shape[0], phi.shape[1])
    terms = {"operations": max(pairs * PAIR_FLOPS_MXU / H100_TF32,
                               (pairs * PAIR_OPS_MXU_EPILOGUE + slabs * SLAB_OPS) / H100_FP32),
             "bytes": nbytes / H100_HBM}
    by = max(terms, key=terms.get)
    return min((terms[by] * 1e3, by), _bound(pairs * PAIR_OPS_NF + slabs * SLAB_OPS, nbytes))


def _denoise_bound(img):
    """Bound of one denoise at img's shape: per pixel and tap a two-row
    lerp (9 operations, fractional taps only), the difference, its squared
    norm, the exponential, the weight and the two sums (17); the final
    division (3); one read and one write of the image."""
    from tpu_pathtracer_torch.post.denoise import tap_table

    taps, _ = tap_table()
    per_pixel = sum(17 + (9 if fy > 0.0 else 0) for fy in taps[:, 2].tolist()) + 3
    h, w, _ = img.shape
    return _bound(h * w * per_pixel, 2 * img.numel() * 4)


# The denoise phase's shapes (height, width, sigma): the headline display,
# the envlit_1080p cell's, an odd shape, one smaller than the halo, and a
# second radius (sigma 3: the tap table read at run time); and the shapes
# it times.
DENOISE_SHAPES = ((512, 512, 5.0), (1080, 1920, 5.0), (300, 517, 5.0), (6, 10, 5.0),
                  (300, 517, 3.0), (6, 10, 3.0))
DENOISE_TIMED = ((512, 512), (1080, 1920))


def _denoise_phase(kdenoise, results, tag):
    """The tiled denoise kernel against the plain version (DENOISE_TOL) at
    every DENOISE_SHAPES entry; then at DENOISE_TIMED the whole wrapper call
    and the kernel launch alone (`_launch`), each twice, the plain version
    and the bound.  The wrapper's time is CUDA events around one call (what
    a display pays); the kernel's, `_kernel_ms`.  Returns (largest
    difference from plain, {(h, w): times})."""
    import numpy as np
    import torch

    dev = torch.device("cuda")
    worst = 0.0
    for h, w, sigma in DENOISE_SHAPES:
        img = torch.from_numpy(np.random.default_rng(h + w).random((h, w, 3), np.float32)).to(dev)
        out_k = kdenoise.smart_denoise(img, sigma=sigma)
        out_p = kdenoise.smart_denoise_plain(img, sigma=sigma)
        torch.cuda.synchronize()
        err = float((out_k - out_p).abs().max())
        torch.testing.assert_close(out_k, out_p, **DENOISE_TOL)
        print(f"denoise {h}x{w} sigma {sigma}: max abs diff vs plain {err:.3g} (atol 2e-5, rtol "
              f"1e-4)")
        worst = max(worst, err)
        results[f"denoise_{h}x{w}_sigma{sigma:g}_max_abs_err"] = err
    timing = {}
    for h, w in DENOISE_TIMED:
        img = torch.from_numpy(np.random.default_rng(0).random((h, w, 3), np.float32)).to(dev)
        img, out, taps = kdenoise._prepare(img, 5.0, 1.0, 0.08)
        got = {"wrapper": [], "kernel": []}
        for _ in range(2):
            got["wrapper"].append(_time_ms(lambda: kdenoise.smart_denoise(img), 3, 20))
            got["kernel"].append(_kernel_ms(lambda: kdenoise._launch(img, out, taps),
                                            "denoise_fixed"))
        plain_ms = _time_ms(lambda: kdenoise.smart_denoise_plain(img), 1, 3)
        bound_ms, bound_by = _denoise_bound(img)
        print(f"timing {tag}: denoise {h}x{w} twice: wrapper "
              + ", ".join(f"{x:.4f}" for x in got["wrapper"])
              + " ms; kernel alone (CUDA events, launches queued back to back) "
              + _fmt_ms(got["kernel"])
              + f" ms; plain {plain_ms:.3f} ms; bound {bound_ms:.5f} ms ({bound_by})")
        timing[(h, w)] = dict(
            ms=statistics.mean(got["wrapper"]), kernel_ms=statistics.mean(got["kernel"]),
            plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, turns=got)
        results[f"denoise_{h}x{w}"] = timing[(h, w)]
    return worst, timing


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


def _primary_rays(cam, dev):
    """The headline camera's primary rays in screen-block order, as
    render_frame builds them: (ro, rd (3, R), seed)."""
    import torch

    from tpu_pathtracer_torch.ops import camera as camera_ops
    from tpu_pathtracer_torch.ops import rng, trace

    xs, ys = trace.blocked_pixel_grid(HEIGHT, WIDTH, dev)
    uv = torch.stack([xs.float() / WIDTH, ys.float() / HEIGHT], dim=-1)
    seed = rng.pixel_seed(xs + ys * WIDTH, 1)
    o, d = camera_ops.camera_rays(cam, uv, WIDTH / HEIGHT)
    resolution = torch.tensor([WIDTH, HEIGHT], dtype=torch.float32, device=dev)
    seed, o, d = camera_ops.apply_dof(seed, o, d, cam, resolution)
    return o.T.contiguous(), d.T.contiguous(), seed


def _mt_rays(data, cam, intersect):
    """Ray features of the headline camera's primary rays and of their
    first bounce (terminated rays parked), as render_frame builds them."""
    import torch

    from tpu_pathtracer_torch.ops import trace
    from tpu_pathtracer_torch.scene.types import RenderParams

    ro, rd, seed = _primary_rays(cam, data.packed.tri_pos.device)
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
    _check_display(renderer, image, config, png)
    print(f"  {config.frames} frames + display in {seconds:.2f} s (first call included); "
          f"launches {launches}; image mean {float(image.mean()):.4f}, written to "
          f"{png.relative_to(ROOT)}")
    return launches, seconds, renderer, float(image.mean())


def _check_display(renderer, image, config, png: Path) -> None:
    """A displayed image: its shape, finite, in [0, 1], not black; written
    as PNG."""
    import torch

    _check(image.shape == (config.height, config.width, 3), f"display shape {tuple(image.shape)}")
    _check(bool(torch.isfinite(image).all()), "display image has non-finite values")
    _check(float(image.min()) >= 0.0 and float(image.max()) <= 1.0, "display outside [0, 1]")
    _check(float(image.mean()) > 0.05, "display image is black")
    png.parent.mkdir(parents=True, exist_ok=True)
    renderer.screenshot(str(png))


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
        kernel, plain = mt_shade._ROUTES[cull, False]
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
                if cull == "nf":
                    sk = mt_shade.nf_walk_stats(tri_pos, phi, sub=sub)
                    sp = mt_shade.nf_walk_stats(tri_pos, phi, sub=sub, plain=True)
                    _check(torch.equal(sk, sp), f"{name} {what}: walk counts differ from plain")
                    results[f"{name}_{what}"].update(subs_evaluated=int(sk.sum()),
                                                     tile_dist=_tile_dist(sk))
                    line += (f"; walk counts equal to the plain walk's over {sk.shape[0]} tiles: "
                             f"{int(sk.sum())} subs evaluated, {_tile_dist(sk)}")
                if cull == "list":
                    prep = mt_shade._prepare_list(tri_pos, phi, None, sub)
                    sk = torch.zeros_like(prep[2])
                    sp = torch.zeros_like(prep[2])
                    hk = mt_shade._walk_list_cuda(*prep, stats=sk)
                    _check(all(torch.equal(a, b) for a, b in
                               zip(hk, mt_shade._walk_list_plain(*prep, stats=sp)))
                           and torch.equal(sk, sp) and torch.equal(sk, prep[2]),
                           f"{name} {what}: walk or walk counts differ from plain")
                    results[f"{name}_{what}"].update(subs_evaluated=int(sk.sum()))
                    line += (f"; walk counts equal to the plain walk's (every listed sub) over "
                             f"{sk.shape[0]} tiles: {int(sk.sum())} subs evaluated")
                    del prep
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
            print(f"timing {tag}: {name} primary kernel walk"
                  " and repack "
                  f"{walk_ms:.3f} ms, plain walk "
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
    TPT_CULL=list and =cond, and with intersector='bvh8' (on the pixels
    where its frame agrees with nf's), against nf's.  Returns {cull:
    launches of the list and cond kernels in their gradient runs}."""
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
    _check(not _mt_launched(launches, ("mt_nf",)),
           f"other MT kernels launched on the training path: {launches}")

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

    # cond end to end: the same warm step under TPT_CULL=nf and =cond, in
    # turns, each launching only its own MT kernel (counts set to 0 just
    # before each turn's first step and read after its last)
    cull_steps = {"nf": [], "cond": []}
    for cull in ("nf", "cond", "cond", "nf"):
        def turn(cull=cull):
            for fn in counters.values():
                fn.launches = 0
            ms = _time_ms(steps[False], 2, 10)
            got = {name: fn.launches for name, fn in counters.items()}
            _check(got[f"mt_{cull}"] >= 12 and not _mt_launched(got, (f"mt_{cull}",)),
                   f"TPT_CULL={cull} training steps: launches {got}")
            return ms

        cull_steps[cull].append(_with_env({"TPT_CULL": cull}, turn))
    print(f"timing {tag}: training step in turns (nf, cond, cond, nf): "
          + ", ".join(f"{x:.3f}" for x in (cull_steps["nf"][0], *cull_steps["cond"],
                                            cull_steps["nf"][1]))
          + " ms (median of 10 warm steps each; each turn launched only its own MT kernel)")
    results["step_cull_ms"] = cull_steps

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

    # The same gradient with the triangles chosen by the fat-leaf BVH walk.
    # The walk's Möller–Trumbore (edge vectors, divided u and v) and the
    # kernels' bilinear form accept different rays at a few shared edges, so
    # a few pixels take another path and move the full gradient (reported).
    # On the pixels where the two forward frames agree, the gradients must.
    img_nf = diff.render_frame_diff(bad, params, **kw).detach()
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    img_b8 = diff.render_frame_diff(bad, params, intersector="bvh8", **kw).detach()
    leaf = wrong.to(dev).requires_grad_(True)
    loss_b8 = diff.make_param_loss(diff.make_loss(target, intersector="bvh8", **kw), bad, params,
                                   ["materials.color"])
    grad_b8 = torch.autograd.grad(loss_b8({"materials.color": leaf}), leaf)[0]
    torch.cuda.synchronize()
    grad_b8_s = time.perf_counter() - t0
    keep = ((img_nf - img_b8).abs().amax(dim=-1) <= 1e-4).to(torch.float32)[..., None]

    def masked_l2(img, tgt):
        return 0.5 * torch.mean(keep * (img - tgt) ** 2)

    masked = {}
    for it in ("auto", "bvh8"):
        loss_m = diff.make_param_loss(diff.make_loss(target, intersector=it, loss_fn=masked_l2,
                                                     **kw), bad, params, ["materials.color"])
        leaf = wrong.to(dev).requires_grad_(True)
        masked[it] = torch.autograd.grad(loss_m({"materials.color": leaf}), leaf)[0]
    launched = _mt_launched({n: fn.launches for n, fn in counters.items()}, ("mt_nf",))
    _check(not launched, f"the bvh8 gradients launched other MT kernels: {launched}")
    n_diff = keep.numel() - int(keep.sum())
    full_diff = float((grad_b8 - grads["nf"]).abs().max())
    diff_max = float((masked["bvh8"] - masked["auto"]).abs().max())
    torch.testing.assert_close(masked["bvh8"], masked["auto"], rtol=1e-3, atol=1e-5)
    print(f"intersector=bvh8 loss gradient vs nf: on the {keep.numel() - n_diff} pixels where the "
          f"frames agree max abs diff {diff_max:.3g} (rtol 1e-3, atol 1e-5); on the full loss "
          f"{full_diff:.3g} ({n_diff} pixels differ by more than 1e-4; information); bvh8 frame "
          f"and gradient {grad_b8_s:.2f} s")
    results.update(grad_bvh8_vs_nf_max_abs_diff=diff_max, grad_bvh8_full_max_abs_diff=full_diff,
                   grad_bvh8_pixels_differ=n_diff, grad_bvh8_s=grad_b8_s)
    if profile:
        _profile(steps[False], tag, results, "training", what="step")
    return {cull: cull_launches[cull][f"mt_{cull}"] for cull in ("list", "cond")}


def _mt_launched(launches, allowed=()):
    """The MT kernels (all but denoise) launched in a run, other than
    `allowed`."""
    return {n: c for n, c in launches.items() if c and n != "denoise" and n not in allowed}


def _r2_check(mt_intersect, name, tri_pos, ro, rd, hk, results, key):
    """Hold one round-2 entry's hits `hk` (the Hopper walk, csrc/r2_walk.cu)
    to its plain version (0 hit/tri mismatches, t/u/v within MT_TOL), and
    its per-tile walk counts to the plain walk's.  Returns (largest t/u/v
    difference, the Hopper walk's counts)."""
    import torch

    stream = name == "mt_stream_r2"
    plain = (mt_intersect.mt_intersect_stream_plain if stream
             else mt_intersect.mt_intersect_pallas_plain)
    t0 = time.perf_counter()
    hp = plain(tri_pos, ro, rd)
    sp = mt_intersect.walk_stats(tri_pos, ro, rd, stream=stream, plain=True)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    bad, err = _hit_diff(hk, hp)
    sk = mt_intersect.walk_stats(tri_pos, ro, rd, stream=stream)
    hits = int(hk.hit.sum())
    evaluated, copied = (int(x) for x in sk.sum(dim=0))
    print(f"{name} {key}: rays {ro.shape[0]}, hits {hits}, hit/tri mismatches {bad}, max |t,u,v| "
          f"diff {err:.3g} (tolerance {MT_TOL}); walk counts equal to the plain walk's over "
          f"{sk.shape[0]} tiles, chunks evaluated {evaluated}, chunks copied {copied} (plain "
          f"version and its walk counts took {plain_s:.1f} s)")
    _check(bad == 0, f"{name} {key}: {bad} rays differ in hit or triangle")
    _check(err <= MT_TOL, f"{name} {key}: t/u/v differ by {err}")
    _check(hits > 0, f"{name} {key}: no ray hit the scene")
    _check(torch.equal(sk, sp), f"{name} {key}: walk counts differ from the plain walk's")
    results[f"{name}_{key}"] = dict(hits=hits, mismatches=bad, max_abs_err=err,
                                    chunks_evaluated=evaluated, chunks_copied=copied,
                                    chunks_per_tile=_tile_dist(sk[:, 0]),
                                    plain_check_s=plain_s)
    return err, sk


def _r2_timing(mt_intersect, mt_shade, name, tri_pos, ro, rd, stats, results, key, tag,
               plain_reps=3):
    """Wrapper, walk and plain times of one round-2 entry on these rays;
    the Hopper walk's kernel (csrc/r2_walk.cu, on a table packed once)
    twice, by `_kernel_ms`; the bound (every ray slab-tests every chunk box,
    the pairs of the evaluated chunks; FP32 operations against bytes) and
    the critical-path bound (the heaviest tile's pairs and slab tests over
    the FP32 share of the C SMs its cluster runs on), beside the kernel on
    the heaviest tile's rays alone (its walk's own time, one cluster)."""
    stream = name == "mt_stream_r2"
    kernel = mt_intersect.mt_intersect_stream if stream else mt_intersect.mt_intersect_pallas
    plain = (mt_intersect.mt_intersect_stream_plain if stream
             else mt_intersect.mt_intersect_pallas_plain)
    prep = (*mt_intersect._prepare(tri_pos, ro, rd, stream), stream)
    phi_pad, rows, boxes, chunk, _ = prep
    table = mt_intersect._r2_table(rows, chunk, stream)
    ms = _time_ms(lambda: kernel(tri_pos, ro, rd), 3, 20)
    walk_ms = _time_ms(lambda: mt_intersect._walk_cuda(*prep), 3, 20)
    times = [_kernel_ms(lambda: mt_intersect._walk_table_cuda(phi_pad, table, boxes, chunk,
                                                              stream), "r2_walk_kernel")
             for _ in range(2)]
    heavy, tile = int(stats[:, 0].argmax()), mt_intersect.TILE_RAYS
    phi_one = phi_pad[:, heavy * tile:(heavy + 1) * tile].contiguous()
    alone_ms = _kernel_ms(lambda: mt_intersect._walk_table_cuda(phi_one, table, boxes, chunk,
                                                                stream), "r2_walk_kernel")
    repack_ms = _time_ms(lambda: mt_intersect._r2_table(rows, chunk, stream), 3, 20)
    plain_ms = _time_ms(lambda: plain(tri_pos, ro, rd), 1, plain_reps)
    walk_plain_ms = _time_ms(lambda: mt_intersect._walk_plain(*prep), 1, plain_reps)
    evaluated = int(stats[:, 0].sum())
    slabs = phi_pad.shape[1] * boxes.shape[0]
    ops = evaluated * chunk * mt_intersect.TILE_RAYS * PAIR_OPS_R2 + slabs * SLAB_OPS
    bound_ms, bound_by = _bound(ops, _mt_bytes(tri_pos.shape[0], ro.shape[0]))
    cluster = mt_shade.walk_shape("tpt_mt_r2_walk_shape")["cluster"]
    heaviest = int(stats[:, 0].max())
    critical_ms = ((heaviest * chunk * PAIR_OPS_R2 + boxes.shape[0] * SLAB_OPS)
                   * mt_intersect.TILE_RAYS / (H100_FP32 / H100_SMS * cluster) * 1e3)
    kernel_ms = statistics.mean(times)
    print(f"timing {tag}: {name} {key} kernel twice: {_fmt_ms(times)} ms (CUDA events, "
          f"launches queued); wrapper {ms:.3f} ms (table repack {repack_ms:.4f} ms; walk call "
          f"{walk_ms:.3f} ms), plain wrapper {plain_ms:.3f} ms (plain walk {walk_plain_ms:.3f} "
          f"ms); bound {bound_ms:.4f} ms ({bound_by}: {ops / 1e9:.3f} GFLOP), critical-path bound "
          f"{critical_ms:.5f} ms (heaviest tile {heaviest} chunks over {cluster} SMs; that "
          f"tile {heavy} alone {alone_ms:.4f} ms)")
    results[f"{name}_{key}"].update(ms=ms, walk_ms=walk_ms, kernel_ms=kernel_ms, times_ms=times,
                                    repack_ms=repack_ms, plain_ms=plain_ms,
                                    walk_plain_ms=walk_plain_ms, bound_ms=bound_ms,
                                    bound_by=bound_by, gflop=ops / 1e9,
                                    critical_path_bound_ms=critical_ms, cluster=cluster,
                                    heaviest_tile_alone_ms=alone_ms)
    return dict(ms=ms, kernel_ms=kernel_ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, critical_path_bound_ms=critical_ms)


def _r2_phase(mt_intersect, mt_shade, counters, tri_pos, phi, nf_hit, results, tag):
    """The round-2 kernels' path: `mt_intersect_pallas` and
    `mt_intersect_stream` once each on these rays with every launch count
    set to 0 just before and read just after; each launches the Hopper walk
    (csrc/r2_walk.cu).  Then each against its plain version (hits and walk
    counts), the two against each other bit for bit,
    the hit/tri mismatches against the near-to-far kernel (information: the
    epilogues differ on borderline t), and their times and bounds."""
    import torch

    ro, rd = phi[1:4].T.contiguous(), phi[4:7].T.contiguous()
    kernels = {"mt_pallas_r2": mt_intersect.mt_intersect_pallas,
               "mt_stream_r2": mt_intersect.mt_intersect_stream}
    shape = mt_shade.walk_shape("tpt_mt_r2_walk_shape")
    print(f"round-2 MT path: mt_intersect_pallas and mt_intersect_stream on the headline primary "
          f"rays; the Hopper walk's kept design {shape}")
    results["walk_r2_shape"] = shape
    for fn in counters.values():
        fn.launches = 0
    hits = {name: fn(tri_pos, ro, rd) for name, fn in kernels.items()}
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in counters.items()}
    print(f"  launches {launches}")
    for name in kernels:
        _check(launches[name] == 1, f"{name} launches {launches}")
    _check(not _mt_launched(launches, kernels), f"other kernels launched: {launches}")
    out = {}
    for name in kernels:
        err, stats = _r2_check(mt_intersect, name, tri_pos, ro, rd, hits[name], results, "headline")
        vs_nf = int(((hits[name].hit != nf_hit.hit) | (hits[name].tri != nf_hit.tri)).sum())
        results[f"{name}_headline"]["mismatches_vs_nf"] = vs_nf
        print(f"{name} headline: hit/tri mismatches against nf {vs_nf} (information)")
        out[name] = dict(launches=launches[name], max_abs_err=err,
                         **_r2_timing(mt_intersect, mt_shade, name, tri_pos, ro, rd, stats,
                                      results, "headline", tag))
    for a, b in zip(*hits.values()):
        _check(torch.equal(a, b), "mt_pallas_r2 and mt_stream_r2 differ")
    print("mt_pallas_r2 and mt_stream_r2 agree bit for bit on the headline primary rays")
    return out


def _intersector_phase(trace, data, frame_params, kw, ref, counters, results, tag):
    """`render_frame` through 'mt', 'bvh' and 'bvh8' (the plain loop over a
    row-major grid, torch ops only) against the near-to-far kernel's frame
    `ref` under the outlier rule; no MT kernel may launch.  Times each."""
    import torch

    paths = WIDTH * HEIGHT
    for it in INTERSECTORS:
        for fn in counters.values():
            fn.launches = 0
        img = trace.render_frame(data, frame_params, intersector=it, **kw)
        torch.cuda.synchronize()
        launched = _mt_launched({n: fn.launches for n, fn in counters.items()})
        _check(not launched, f"intersector {it!r} launched MT kernels: {launched}")
        _check(img.shape == ref.shape and bool(torch.isfinite(img).all()),
               f"{it} frame not finite")
        _check(float(img.min()) >= 0.0, f"{it} frame has negative radiance")
        frac, agree = _outlier_rule(img, ref)
        ms = _time_ms(lambda: trace.render_frame(data, frame_params, intersector=it, **kw), 1, 3)
        print(f"intersector {it}: frame vs nf frame outlier fraction {frac:.2e}, non-outlier mean "
              f"diff {agree:.2e}; MT kernels launched none")
        print(f"timing {tag}: headline frame intersector {it} {ms:.3f} ms "
              f"({paths / ms / 1e3:.3f} Mpaths/s)")
        results[f"frame_{it}"] = dict(ms=ms, outlier_frac=frac, mean_diff=agree)


def _mesh_scene(pt, segments: int):
    """The JAX bench's mesh_scene(segments) (bench.py:84-91): a sphere of
    radius 0.5 and a 4x4 plane under a 512x1024 gradient sky."""
    from tpu_pathtracer_torch.scene import primitives
    from tpu_pathtracer_torch.scene.envmap import gradient_sky
    from tpu_pathtracer_torch.scene.host import rotation_x

    scene = pt.Scene()
    scene.add(pt.Mesh(*primitives.sphere(0.5, segments, segments // 2),
                      pt.Material(color=(0.8, 0.7, 0.6))))
    scene.add(pt.Mesh(*primitives.plane(4, 4), pt.Material(), transform=rotation_x(-math.pi / 2)))
    scene.set_environment(gradient_sky(512, 1024))
    return scene


def _large_phase(pt, trace, intersect, counters, results, tag, profile: bool):
    """The slice's full-width path: Renderer(mesh_scene(640)).render_all()
    and display() with every launch count set to 0 just before and read
    just after ('auto' must take 'bvh8', one fat walk kernel launch a
    bounce, and no MT kernel may launch); then 'bvh8' against 'bvh' on the
    primary rays (the same hits and t; the triangles may differ only on
    exact-t ties), and the times; then `_fat_walk_phase`, whose results it
    returns."""
    import torch

    dev = torch.device("cuda")
    config = pt.RenderConfig(width=WIDTH, height=HEIGHT, frames=LARGE_FRAMES,
                             samples_per_frame=1, max_bounces=LARGE_BOUNCES)
    renderer = pt.Renderer(_mesh_scene(pt, LARGE_SEGMENTS), pt.Camera.create(**CAMERA), config,
                           pt.PostConfig(), device=dev)
    t0 = time.perf_counter()
    data = renderer.scene_data
    torch.cuda.synchronize()
    compile_s = time.perf_counter() - t0
    n_pad, n_real = data.packed.tri_pos.shape[0], int((data.packed.tri_perm >= 0).sum())
    kind = trace.resolve_intersector("auto", n_pad)
    print(f"large scene: {n_real} triangles padded to {n_pad}, {data.packed.nodes.shape[0]} "
          f"skip-link and {data.packed.fat_nodes.shape[0]} fat-leaf node rows; compiled in "
          f"{compile_s:.2f} s; intersector {kind}")
    _check(n_pad == 524288 and kind == "bvh8", f"large scene {n_pad} triangles -> {kind}")

    print("large-scene main path:")
    for fn in counters.values():
        fn.launches = 0
    fat0 = intersect.bvh_fat_intersect.launches
    t0 = time.perf_counter()
    renderer.render_all()
    image = renderer.display()
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counters.items()}
    fat_launches = intersect.bvh_fat_intersect.launches - fat0
    _check(LARGE_FRAMES <= fat_launches <= LARGE_FRAMES * LARGE_BOUNCES,
           f"fat walk kernel launches {fat_launches} for {LARGE_FRAMES} frames")
    png = ROOT / "build" / "chip_smoke_large.png"
    _check_display(renderer, image, config, png)
    print(f"  {LARGE_FRAMES} frames + display in {main_s:.2f} s; launches {launches}, fat walk "
          f"{fat_launches}; image mean {float(image.mean()):.4f}, written to "
          f"{png.relative_to(ROOT)}")
    _check(not _mt_launched(launches), f"MT kernels launched on the bvh8 path: {launches}")
    _check(launches["denoise"] >= 1, "denoise kernel not launched")

    params = pt.RenderParams.create(renderer.camera, frame=3)
    kw = dict(width=WIDTH, height=HEIGHT, aspect=WIDTH / HEIGHT, max_bounces=LARGE_BOUNCES)
    frame_ms = _time_ms(lambda: trace.render_frame(data, params, **kw), 0, 2)
    if profile:
        _profile(lambda: trace.render_frame(data, params, **kw), tag, results, "large")

    o, d, _ = _primary_rays(renderer.camera, dev)
    ro, rd = o.T.contiguous(), d.T.contiguous()
    fat, nodes, tri_pos = data.packed.fat_nodes, data.packed.nodes, data.packed.tri_pos
    h8 = intersect.bvh_fat_intersect(fat, ro, rd, ray_batch=0)
    hb = intersect.bvh_intersect(nodes, tri_pos, ro, rd)
    torch.cuda.synchronize()
    _check(torch.equal(h8.hit, hb.hit), "bvh8 and bvh differ in hits")
    _check(torch.equal(h8.t, hb.t), "bvh8 and bvh differ in t")
    ties = int((h8.tri != hb.tri).sum())
    hits = int(h8.hit.sum())
    bvh8_ms = _time_ms(lambda: intersect.bvh_fat_intersect(fat, ro, rd, ray_batch=0), 1, 3)
    bvh_ms = _time_ms(lambda: intersect.bvh_intersect(nodes, tri_pos, ro, rd), 1, 3)
    print(f"large scene primary rays: bvh8 vs bvh: {hits} hits, equal hits and t, "
          f"{ties} triangles differ on exact-t ties")
    print(f"timing {tag}: large frame (bvh8, {LARGE_BOUNCES} bounces) {frame_ms:.3f} ms "
          f"({WIDTH * HEIGHT / frame_ms / 1e3:.3f} Mpaths/s); primary-ray walk bvh8 "
          f"{bvh8_ms:.3f} ms, bvh {bvh_ms:.3f} ms; scene compile {compile_s:.2f} s")
    results.update(large_compile_s=compile_s, large_main_path_s=main_s, large_launches=launches,
                   large_fat_walk_launches=fat_launches, large_image_mean=float(image.mean()),
                   large_frame_ms=frame_ms, large_bvh8_walk_ms=bvh8_ms, large_bvh_walk_ms=bvh_ms,
                   large_primary_hits=hits, large_bvh8_bvh_ties=ties)
    return _fat_walk_phase(intersect, trace, data, params, kw, results, tag)


def _fat_walk_reads(intersect, fat, ro, rd, max_leaf: int = 8):
    """(node rows visited, leaf triangles tested) by the fat-leaf walk of
    these rays: the torch walk (`_fat_step` under `_walk`), each step's
    entered leaves counted beside it."""
    import torch

    k = fat.shape[0]
    links = intersect._link_columns(fat, 6, 3)
    slots = torch.arange(max_leaf, device=ro.device)[None, :]
    step = intersect._fat_step(fat, links, slots, max_leaf, None)
    rows = torch.zeros((), dtype=torch.int64, device=ro.device)
    tris = torch.zeros((), dtype=torch.int64, device=ro.device)

    def counted(rays, state):
        ptr, best_t = state[0], state[1]
        active = ptr < k
        p = torch.where(active, ptr, 0)
        row = torch.index_select(fat, 0, p)
        hit, tmin = intersect.ray_aabb_t(rays[0], rays[1], row[:, 0:3], row[:, 3:6])
        count = torch.index_select(links, 0, p)[:, 2]
        entered = hit & active & (tmin < best_t) & (count > 0)
        rows.add_(active.sum())
        tris.add_(torch.where(entered, count.clamp(max=max_leaf), 0).sum())
        return step(rays, state)

    ptr = torch.zeros((ro.shape[0],), dtype=torch.int32, device=ro.device)
    intersect._walk(counted, (ro, rd), (ptr, *intersect._start(ro)), lambda s: s[0] < k)
    return int(rows), int(tris)


def _fat_walk_phase(intersect, trace, data, params, kw, results, tag):
    """The fat walk kernel (csrc/fat_walk.cu) on the large scene's 262,144
    primary rays and on its first bounce's rays (the plain loop's, parked
    rays included), as `render_frame` hands them to the walk: bit-equal to
    the torch walk (`_bvh_fat_intersect_plain`), its `walk.fat.nodes`
    equal to the torch walk's count, the kernel timed by `_kernel_ms`
    beside its bound (rows and leaf triangles read a visit, over the HBM
    rate, against their FP32 operations over the FP32 peak) and the torch
    walk's time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from tpu_pathtracer_torch.utils import spans

    fat = data.packed.fat_nodes
    calls = []
    walk = trace.bvh_fat_intersect

    def recorded(f, ro, rd, **kwargs):
        calls.append((ro.clone(), rd.clone()))
        return walk(f, ro, rd, **kwargs)

    trace.bvh_fat_intersect = recorded
    try:
        trace.render_frame(data, params, intersector="bvh8", **kw)
    finally:
        trace.bvh_fat_intersect = walk
    out = {}
    for what, (ro, rd) in zip(("primary", "bounce1"), calls):
        with spans.span("between sessions"):
            pass
        with profile(activities=[ProfilerActivity.CPU]):
            hk = intersect.bvh_fat_intersect(fat, ro, rd, ray_batch=0)
        torch.cuda.synchronize()
        counts = spans.totals()
        hp = intersect._bvh_fat_intersect_plain(fat, ro, rd)
        for name, a, b in zip(hk._fields, hk, hp):
            _check(torch.equal(a, b), f"fat walk {what}: {name} differs from the torch walk's")
        rows, tris = _fat_walk_reads(intersect, fat, ro, rd)
        _check(counts.get("walk.fat.nodes") == rows,
               f"fat walk {what}: walk.fat.nodes {counts.get('walk.fat.nodes')}, torch walk {rows}")
        n = ro.shape[0]
        kernel_ms = _kernel_ms(lambda: intersect._fat_walk_cuda(fat, ro, rd, 8), "fat_walk_kernel")
        plain_ms = _time_ms(lambda: intersect._bvh_fat_intersect_plain(fat, ro, rd), 1, 3)
        bound = _bound(rows * FAT_ROW_OPS + tris * FAT_TRI_OPS,
                       4 * (9 * rows + 9 * tris + 6 * n + 4 * n) + n)
        steps, lane_steps = counts["walk.fat.steps"], counts["walk.fat.lane_steps"]
        print(f"timing {tag}: fat walk {what} ({n} rays, {int(hk.hit.sum())} hits, bit-equal to "
              f"the torch walk): kernel {kernel_ms:.4f} ms, torch walk {plain_ms:.3f} ms; bound "
              f"{bound[0]:.4f} ms ({bound[1]}) from {rows} rows ({rows / n:.3f} a ray) and {tris} "
              f"leaf triangles; longest walk {steps} rows, lanes used "
              f"{100 * rows / lane_steps:.1f}%")
        out[what] = dict(rays=n, kernel_ms=kernel_ms, plain_ms=plain_ms, bound_ms=bound[0],
                         bound_by=bound[1], rows=rows, leaf_triangles=tris, steps=steps,
                         lane_steps=lane_steps)
    _check(len(out) == 2, f"the bvh8 frame made {len(calls)} walk calls")
    results["fat_walk"] = out
    return out


def _same_tri_err(hk, hp) -> float:
    """Largest |t, u, v| difference on the lanes where both hit the same
    triangle."""
    m = hk.hit & hp.hit & (hk.tri == hp.tri)
    if not bool(m.any()):
        return 0.0
    return max(float((a[m] - b[m]).abs().max()) for a, b in ((hk.t, hp.t), (hk.u, hp.u),
                                                               (hk.v, hp.v)))


def _mxu_phase(mt_shade, tri_pos, rays, results, tag):
    """Kernel #5: the MXU variant of nf, list and cond at sub-treelets of 32,
    64 and 128 on the headline rays, each against its plain version (TF32
    off, asserted) and against the FP32 kernel by `hit_agreement`'s rule
    (hit and triangle equal on >= 99.9% of the primary rays' lanes, every
    differing lane a near-tie within 1e-5, an edge or a floor lane, floor
    lanes on the bounce rays counted apart; t, u and v within 1e-4 of the
    magnitude their sums are conditioned by, where the triangle agrees), no
    output NaN, and nf's and cond's walk counts against their plain
    versions' (at most 1% of the tiles may differ: an entry that ties a
    ray's t may be decided the other way when the two t differ by a
    rounding).  Times one call of every walk; returns {cull: (largest
    t/u/v difference against plain, wrapper ms, plain wrapper ms)} at sub
    64."""
    import functools

    import torch

    prepares = {"nf": mt_shade._prepare, "list": mt_shade._prepare_list,
                "cond": mt_shade._prepare_cond}
    fp32 = {what: {sub: {cull: mt_shade._ROUTES[cull, False][0](tri_pos, phi, sub=sub)
                         for cull in CULLS} for sub in SUBS} for what, (phi, _) in rays.items()}
    out = {}
    for cull in CULLS:
        kernel, plain = mt_shade._ROUTES[cull, True]
        _, walk_p, walk_k = mt_shade._MXU_WALKS[cull]
        worst = 0.0
        for sub in SUBS:
            name = f"mt_{cull}_mxu_sub{sub}"
            for what, (phi, parked) in rays.items():
                hk = kernel(tri_pos, phi, sub=sub)
                with mt_shade._full_fp32():
                    _check(not torch.backends.cuda.matmul.allow_tf32, "TF32 is on in the plain MXU")
                    hp = plain(tri_pos, phi, sub=sub)
                torch.cuda.synchronize()
                vs_plain = mt_shade.hit_agreement(tri_pos, phi, hk, hp)
                vs_fp32 = mt_shade.hit_agreement(tri_pos, phi, hk, fp32[what][sub][cull])
                err = _same_tri_err(hk, hp)
                worst = max(worst, err)
                hits = int(hk.hit.sum())
                print(f"{name} {what}: rays {phi.shape[1]}, hits {hits}, parked {parked}; vs plain "
                      f"{vs_plain}; vs the FP32 kernel {vs_fp32}; max |t,u,v| diff vs plain "
                      f"{err:.3g}")
                _check(hits > 0, f"{name} {what}: no ray hit the scene")
                _check(not any(bool(torch.isnan(x).any()) for x in (hk.t, hk.u, hk.v)),
                       f"{name} {what}: NaN in the outputs")
                _check(vs_plain["ok"], f"{name} {what}: disagrees with its plain version")
                _check(vs_fp32["ok"], f"{name} {what}: disagrees with the FP32 kernel")
                results[f"{name}_{what}"] = dict(hits=hits, vs_plain=vs_plain, vs_fp32=vs_fp32,
                                                 max_abs_err=err)
                line = f"{name} {what}"
                if cull != "list":
                    stats = mt_shade.cond_walk_stats if cull == "cond" else mt_shade.nf_walk_stats
                    width = 2 if cull == "cond" else 1
                    sk, sp, sf = (stats(tri_pos, phi, sub=sub, **kw).reshape(-1, width)
                                  for kw in ({"mxu": True}, {"mxu": True, "plain": True}, {}))
                    tiles = int((sk != sp).any(dim=1).sum())
                    ek, ep, ef = (int(x[:, -1].sum()) for x in (sk, sp, sf))
                    print(f"{line}: walk counts: {tiles} of {sk.shape[0]} tiles differ from the "
                          f"plain walk's, subs evaluated {ek} (plain {ep}, FP32 kernel {ef})")
                    _check(tiles <= 0.01 * sk.shape[0] and abs(ek - ep) <= 0.01 * ep,
                           f"{name} {what}: walk counts differ from the plain walk's")
                    results[f"{name}_{what}"].update(tiles_differ=tiles, subs_evaluated=ek,
                                                     subs_evaluated_plain=ep,
                                                     subs_evaluated_fp32=ef)
            phi = rays["primary"][0]
            prep = mt_shade._mma_prepare(prepares[cull])(tri_pos, phi, None, sub)
            prep_p = prepares[cull](tri_pos, phi, None, sub)
            walk_ms = _time_ms(lambda: walk_k(*prep, mxu=True), 3, 20)
            walk_plain_ms = _time_ms(lambda: walk_p(*prep_p, mxu=True), 1, 3)
            pack_ms = _time_ms(lambda: mt_shade._pack_mxu_table(prep_p[1], sub), 3, 20)
            results[f"{name}_walk_ms"], results[f"{name}_walk_plain_ms"] = walk_ms, walk_plain_ms
            results[f"{name}_pack_ms"] = pack_ms
            print(f"timing {tag}: {name} primary walk call {walk_ms:.3f} ms (FP32 walk call "
                  f"{results[f'mt_{cull}_sub{sub}_walk_ms']:.3f} ms), plain walk "
                  f"{walk_plain_ms:.3f} ms; table split (`_pack_mxu_table`) {pack_ms:.3f} ms")
            del prep, prep_p
        phi = rays["primary"][0]
        fp32_kernel = mt_shade._ROUTES[cull, False][0]
        ms = _time_ms(lambda: kernel(tri_pos, phi), 3, 20)
        fp32_ms = _time_ms(lambda: fp32_kernel(tri_pos, phi), 3, 20)
        plain_ms = _time_ms(lambda: plain(tri_pos, phi), 1, 3)
        bound_ms, bound_by = _mxu_bound(mt_shade, tri_pos, phi, cull)
        print(f"timing {tag}: mt_{cull}_mxu primary wrapper (sub 64) {ms:.3f} ms (FP32 wrapper "
              f"just after {fp32_ms:.3f} ms), plain wrapper {plain_ms:.3f} ms; bound "
              f"{bound_ms:.4f} ms ({bound_by})")
        results.update({f"mt_{cull}_mxu_ms": ms, f"mt_{cull}_mxu_plain_ms": plain_ms,
                        f"mt_{cull}_mxu_fp32_ms": fp32_ms, f"mt_{cull}_mxu_bound_ms": bound_ms})
        out[cull] = dict(max_abs_err=worst, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                         bound_by=bound_by)
    return out


H100_SMS = 132  # streaming multiprocessors of the H100 SXM


def _tile_dist(counts):
    """Mean, max and the five heaviest tiles (index, count) of per-tile
    walk counts (T,)."""
    top = counts.double().topk(min(5, counts.numel()))
    return dict(mean=float(counts.double().mean()), max=int(counts.max()),
                tiles_walking=int((counts > 0).sum()), tiles=int(counts.numel()),
                heaviest=[(int(i), int(v)) for v, i in zip(top.values, top.indices)])


def _walk_work(kind, stats, tile_rays, sub, n_chunks=0, alive=None):
    """(pairs, slab tests) of a walk per tile (T,), from its walk counts,
    every lane of the tile: the pairs of the evaluated subs; the slab tests
    of the streamed walk (16 chunk boxes per walked super, 4 sub boxes per
    staged chunk) and of cond (every chunk box of a tile that moves,
    `alive` (T,), and the subs of each live chunk; none at sub 128, where
    the chunk is the sub); nf and list make none."""
    s = stats.double()
    if kind in ("nf", "list"):
        return s * sub * tile_rays, s * 0
    if kind == "cond":
        spc = 128 // sub
        slabs = alive.double() * n_chunks + s[:, 0] * (spc if spc > 1 else 0)
        return s[:, 1] * sub * tile_rays, slabs * tile_rays
    return s[:, 2] * sub * tile_rays, (s[:, 0] * 16 + s[:, 1] * 4) * tile_rays


def _walk_bounds(pairs, slabs, n_tris, n_rays, cluster, mxu=False):
    """(walk bound ms, its binding term, critical-path bound ms) of a walk
    whose per-tile pairs and slab tests are these.  FP32 walks: the whole
    walk's FP32 operations (PAIR_OPS_NF a pair, SLAB_OPS a slab test) over
    the FP32 peak against its bytes (the 20 floats a triangle the function
    needs) over the HBM rate; the heaviest tile's operations over the FP32
    share of the `cluster` SMs it runs on (67 TFLOP/s / 132 SMs each).  MXU
    walks: the determinants' PAIR_FLOPS_MXU a pair over the TF32 peak
    against the epilogue's and slab tests' operations over the FP32 peak
    and the same bytes (not the 80 floats of the kernel's split table); the
    heaviest tile likewise over its SMs' shares."""
    nbytes = _mt_bytes(n_tris, n_rays, 20)
    if not mxu:
        work = pairs * PAIR_OPS_NF + slabs * SLAB_OPS
        walk_ms, by = _bound(float(work.sum()), nbytes)
        critical_ms = float(work.max()) / (H100_FP32 / H100_SMS * cluster) * 1e3
        return walk_ms, by, critical_ms
    tensor = pairs * PAIR_FLOPS_MXU
    fp32 = pairs * PAIR_OPS_MXU_EPILOGUE + slabs * SLAB_OPS
    terms = {"operations": max(float(tensor.sum()) / H100_TF32, float(fp32.sum()) / H100_FP32),
             "bytes": nbytes / H100_HBM}
    by = max(terms, key=terms.get)
    share = cluster / H100_SMS
    critical = (tensor / (H100_TF32 * share)).maximum(fp32 / (H100_FP32 * share))
    return terms[by] * 1e3, by, float(critical.max()) * 1e3


def _sass_loads(lib_path: Path, kernels: dict, dump_dir=None) -> dict:
    """Shared-memory loads of each kernel's pair loop in the built library,
    from `cuobjdump -sass`.  The pair loop is the shortest loop (a branch
    back to an earlier address) that evaluates a pair: each pair takes one
    reciprocal (`__frcp_rn`, one MUFU.RCP), so pairs = MUFU.RCP count.
    Returns the loop's LDS instructions by width and LDS per pair.
    `kernels`: {label: substring of the mangled name}; each kernel's SASS
    is written to `dump_dir` if given."""
    import os
    import re
    import shutil

    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True, text=True,
                          check=True, timeout=300).stdout
    funcs = re.split(r"\n\s*Function : ", sass)[1:]

    def count(pattern, lines):
        return sum(len(re.findall(pattern, line)) for line in lines)

    out = {}
    for label, pattern in kernels.items():
        body = next((f for f in funcs if pattern in f.split("\n", 1)[0]), None)
        _check(body is not None, f"sass: no kernel matching {pattern}")
        if dump_dir is not None:
            dump_dir.mkdir(parents=True, exist_ok=True)
            (dump_dir / f"sass_{label}.txt").write_text(body)
        lines, at, loop = body.splitlines(), {}, None
        for i, line in enumerate(lines):
            here = re.match(r"\s*/\*([0-9a-f]+)\*/", line)
            if not here:
                continue
            at[int(here.group(1), 16)] = i
            back = re.search(r"\bBRA\b[^;]*\b0x([0-9a-f]+)\s*;", line)
            if back and int(back.group(1), 16) in at:  # a branch to an earlier address
                span = lines[at[int(back.group(1), 16)]:i + 1]
                if count(r"\bMUFU\.RCP\b", span) and (loop is None or len(span) < len(loop)):
                    loop = span
        _check(loop is not None, f"sass: no pair loop in {label}")
        widths = {}
        for m in re.finditer(r"\bLDS((?:\.\w+)*)", "\n".join(loop)):
            w = "128" if ".128" in m.group(1) else "64" if ".64" in m.group(1) else "32"
            widths[w] = widths.get(w, 0) + 1
        lds, pairs = sum(widths.values()), count(r"\bMUFU\.RCP\b", loop)
        out[label] = dict(lds=lds, lds_by_bits=widths, pairs=pairs, lds_per_pair=lds / pairs)
    return out


def _precull_args(mt_shade, fn):
    """The (boxes, padded ray features, tile width) that a walk's wrapper
    hands the precull kernel (`_precull_cuda`) in one call of `fn()`."""
    seen = []
    real = mt_shade._precull_cuda
    mt_shade._precull_cuda = lambda *a: seen.append(a) or real(*a)
    try:
        fn()
    finally:
        mt_shade._precull_cuda = real
    return seen[0]


def _precull_bound(ms: int, n_rays: int, n_tiles: int):
    """Bound of one precull: SLAB_OPS FP32 operations a ray-box pair against
    24 bytes a ray read (ro, rd), the boxes (32 bytes each) and 8 bytes a
    tile and box plus 4 a tile written."""
    return _bound(ms * n_rays * SLAB_OPS, 24 * n_rays + 32 * ms + n_tiles * (8 * ms + 4))


def _precull_phase(mt_shade, cases, results, tag):
    """The walks' precull kernel (csrc/precull.cu) against its plain version
    (`_precull_live_subs_plain`) on the inputs the wrappers hand it: the nf
    walk's sub boxes on the default scene (Ms 32) and the streamed walk's
    super boxes on the stress scene (Ms 64), each on its primary and
    bounce-1 rays: counts, lists and emins bit-equal.  On the primary rays
    (512^2) the kernel is timed by `_kernel_ms`, one call of the wrapper
    and of the plain version by CUDA events around it (their host path
    included), beside `_precull_bound`.  Returns the default scene's
    primary readings."""
    import torch

    out = {}
    for scene, wrapper, tri_pos, rays in cases:
        for what, (phi, _) in rays.items():
            boxes, phi_pad, tile = _precull_args(mt_shade, lambda: wrapper(tri_pos, phi))
            got = mt_shade._precull_live_subs(boxes, phi_pad, tile)
            want = mt_shade._precull_live_subs_plain(boxes, phi_pad, tile)
            torch.cuda.synchronize()
            equal = all(torch.equal(a, b) for a, b in zip(got, want))
            ms, n_rays = boxes.shape[0], phi_pad.shape[1]
            n_tiles, live = n_rays // tile, int(got[0].sum())
            print(f"precull {scene} {what}: {n_rays} rays, {n_tiles} tiles of {tile}, Ms {ms}, "
                  f"live {live} of {n_tiles * ms}; bit-equal to the plain version: {equal}")
            _check(equal, f"precull {scene} {what}: the kernel differs from the plain version")
            res = dict(rays=n_rays, tiles=n_tiles, ms=ms, live=live, bit_equal=equal)
            if what == "primary":
                kernel_ms = _kernel_ms(lambda: mt_shade._precull_cuda(boxes, phi_pad, tile),
                                       "precull_kernel")
                call_ms = _time_ms(lambda: mt_shade._precull_live_subs(boxes, phi_pad, tile), 3, 20)
                plain_ms = _time_ms(
                    lambda: mt_shade._precull_live_subs_plain(boxes, phi_pad, tile), 3, 20)
                bound_ms, bound_by = _precull_bound(ms, n_rays, n_tiles)
                print(f"timing {tag}: precull {scene} primary (Ms {ms}): kernel {kernel_ms:.4f} ms, "
                      f"one call {call_ms:.4f} ms, plain version {plain_ms:.4f} ms; bound "
                      f"{bound_ms:.4f} ms ({bound_by})")
                res.update(kernel_ms=kernel_ms, call_ms=call_ms, plain_ms=plain_ms,
                           bound_ms=bound_ms, bound_by=bound_by)
            results[f"precull_{scene}_{what}"] = out[f"{scene}_{what}"] = res
    return out


def _walk_cases(tri_pos, rays, s_tri, s_rays):
    """The walk phase's cases: the nf, list and cond walks, their MXU
    variants and the streamed walk on the headline scene, the streamed walk
    on the stress scene, each on primary and first-bounce rays (nf, list
    and cond cannot take the stress scene's 131,072 triangles)."""
    cases = {}
    for what in ("primary", "bounce1"):
        for kind in ("nf", "list", "cond", "nf_mxu", "list_mxu", "cond_mxu", "stream"):
            cases[f"{kind}_headline_{what}"] = (kind, tri_pos, rays[what][0])
        cases[f"stream_stress_{what}"] = ("stream", s_tri, s_rays[what][0])
    return cases


# Each walk's kernel by name, as the profiler reports it.
WALK_KERNELS = {"nf": "nf_walk_kernel", "list": "nf_walk_kernel", "cond": "cond_walk_kernel",
                "stream": "stream_walk_kernel", "nf_mxu": "mxu_walk_kernel",
                "list_mxu": "mxu_walk_kernel", "cond_mxu": "mxu_cond_kernel"}


def _walk_setup(mt_shade, mt_stream, kind, tri_pos, phi):
    """(prep, sub, plain walk, kept walk, stats shape) of one walk case.
    Both walks take `stats=`; the kept one reads the table
    `_pack_walk_table` (MXU: `_pack_mxu_table`) packed once here; the MXU
    plain walk runs with TF32 off."""
    if kind == "stream":
        sub = mt_stream.SUB_TRIS
        prep = mt_stream._prepare(tri_pos, phi, None)
        table = mt_shade._pack_walk_table(prep[1], sub)
        return (prep, sub, mt_stream._walk_plain,
                lambda stats=None: mt_stream._walk_table_cuda(prep[0], table, *prep[2:7],
                                                              prep[-1], stats=stats),
                (prep[5].shape[0], 3))
    cull = kind.removesuffix("_mxu")
    sub = mt_shade.SUB_TRIS
    prepare, plain, _ = mt_shade._MXU_WALKS[cull]
    prep = prepare(tri_pos, phi, None, sub)
    n_tiles = prep[0].shape[1] // prep[-1]
    stats_shape = (n_tiles, 2) if cull == "cond" else (n_tiles,)
    if kind.endswith("_mxu"):
        table = mt_shade._pack_mxu_table(prep[1], sub)

        def plain_mxu(*args, stats=None):
            with mt_shade._full_fp32():
                return plain(*args, stats=stats, mxu=True)

        _, _, walk = mt_shade._MXU_WALKS[cull]
        return (prep, sub, plain_mxu,
                lambda stats=None: walk(prep[0], table, *prep[2:], mxu=True, stats=stats),
                stats_shape)
    table = mt_shade._pack_walk_table(prep[1], sub)
    if kind == "nf":
        return (prep, sub, mt_shade._walk_plain,
                lambda stats=None: mt_shade._list_launch("mt_nf", prep[0], table, *prep[2:5],
                                                         prep[-1], stats),
                stats_shape)
    if kind == "list":
        return (prep, sub, mt_shade._walk_list_plain,
                lambda stats=None: mt_shade._list_launch("mt_list", prep[0], table, *prep[2:4],
                                                         None, prep[-1], stats),
                stats_shape)
    return (prep, sub, mt_shade._walk_cond_plain,
            lambda stats=None: mt_shade._walk_cond_table_cuda(prep[0], table, *prep[2:],
                                                              stats=stats),
            stats_shape)


def _walk_phase(mt_shade, mt_stream, cases, results, tag):
    """The Hopper walks of #1 and #4a (csrc/nf_walk.cu), #4b
    (csrc/cond_walk.cu), #3 (csrc/stream_walk.cu) and #5 (csrc/mxu_walk.cu)
    on each case (kernel, scene, rays).  The FP32 walks are held bit for
    bit to the plain walk with equal per-tile walk counts; the MXU walks
    to their plain walks by `hit_agreement` (floor lanes at most 0.3%, no
    NaN), with walk counts within 1% of tiles (list: equal).  Prints the
    per-tile walk distribution; the repack (`_pack_walk_table`,
    `_pack_mxu_table`) timed apart; the walk timed twice, as the kernel's
    time by CUDA events around launches queued
    back to back (`_kernel_ms`), and as CUDA events around one call (the
    host launch path included); the walk and critical-path bounds.  Returns
    {case: summary}."""
    import torch

    sub = mt_shade.SUB_TRIS
    shapes = {kind: mt_shade.walk_shape(f"tpt_mt_{kind}_shape", sub, 512)
              for kind in ("nf", "list", "cond", "nf_mxu", "list_mxu", "cond_mxu")}
    shapes["stream"] = mt_shade.walk_shape("tpt_mt_stream_shape", 512)
    for kind, shape in shapes.items():
        print(f"walk {kind} kept design at a 512-ray tile: {shape}")
        results[f"walk_{kind}_shape"] = shape
    out = {}
    for key, (kind, tri_pos, phi) in cases.items():
        mxu = kind.endswith("_mxu")
        prep, sub, plain, kept, stats_shape = _walk_setup(mt_shade, mt_stream, kind, tri_pos, phi)
        tile, r = prep[-1], phi.shape[1]
        sp = torch.zeros(stats_shape, dtype=torch.int32, device=phi.device)
        hp = plain(*prep, stats=sp)

        def as_hit(walk_out):
            t, idx, u, v = (x[:r] for x in walk_out)
            return mt_shade.Hit(idx >= 0, t, idx, u, v)

        agreement = {}
        sk = torch.zeros_like(sp)
        hits = kept(stats=sk)
        if mxu:
            _check(not any(bool(torch.isnan(x).any()) for x in hits),
                   f"walk {key}: NaN in the outputs")
            agreement = mt_shade.hit_agreement(tri_pos, phi, as_hit(hits), as_hit(hp))
            _check(agreement["ok"], f"walk {key}: disagrees with the plain walk: {agreement}")
            sk2, sp2 = (sk, sp) if stats_shape[1:] == (2,) else (sk[:, None], sp[:, None])
            tiles = int((sk2 != sp2).any(dim=1).sum())
            ek, ep = int(sk2[:, -1].sum()), int(sp2[:, -1].sum())
            agreement.update(tiles_differ=tiles, subs_evaluated=ek)
            _check(tiles <= 0.01 * sk2.shape[0] and abs(ek - ep) <= 0.01 * ep
                   and (kind != "list_mxu" or tiles == 0),
                   f"walk {key}: walk counts differ from the plain walk's: {tiles} tiles, subs "
                   f"{ek} against {ep}")
        else:
            _check(all(torch.equal(a, b) for a, b in zip(hits, hp)),
                   f"walk {key}: hits differ from the plain walk's")
            _check(torch.equal(sk, sp), f"walk {key}: walk counts differ from the plain walk's")
        torch.cuda.synchronize()
        evaluated = sp if sp.dim() == 1 else sp[:, -1]  # subs evaluated
        dist = {"subs": _tile_dist(evaluated)}
        if kind in ("cond", "cond_mxu"):
            dist.update(chunks=_tile_dist(sp[:, 0]))
        if kind == "stream":
            dist.update(supers=_tile_dist(sp[:, 0]), chunks=_tile_dist(sp[:, 1]))
        heavy = int(evaluated.argmax())

        times, calls = [], []
        for _ in range(2):
            times.append(_kernel_ms(kept, WALK_KERNELS[kind]))
            calls.append(_time_ms(kept, 3, 20))
        pack = mt_shade._pack_mxu_table if mxu else mt_shade._pack_walk_table
        repack_ms = _time_ms(lambda: pack(prep[1], sub), 3, 20)
        cluster = shapes[kind]["cluster"]
        alive = None
        if kind in ("cond", "cond_mxu"):
            alive = prep[0][4:7].abs().reshape(3, -1, tile).sum(dim=(0, 2)) > 0
        pairs, slabs = _walk_work(kind.removesuffix("_mxu"), sp, tile, sub,
                                  n_chunks=-(-tri_pos.shape[0] // 128), alive=alive)
        walk_bound, walk_by, critical = _walk_bounds(pairs, slabs, tri_pos.shape[0], r, cluster,
                                                     mxu)
        kept_ms = statistics.mean(times)
        held = ("held to the plain walk by hit_agreement " + str(agreement) if mxu else
                "bit-equal to the plain walk with equal walk counts")
        print(f"walk {key}: {r} rays, {sp.shape[0]} tiles of {tile}; {held}; per-tile walk "
              f"{dist}; heaviest tile {heavy} counts {sp[heavy].tolist()}")
        for what, got in (("kernel (CUDA events, launches queued)", times),
                          ("one call (CUDA events)", calls)):
            print(f"timing {tag}: walk {key} {what} twice: {_fmt_ms(got)} ms")
        print(f"timing {tag}: walk {key} repack {repack_ms:.4f} ms; walk bound {walk_bound:.5f} ms "
              f"({walk_by}), critical-path bound {critical:.5f} ms (heaviest tile over {cluster} "
              "SM(s))")
        out[key] = dict(kind=kind, tile_rays=tile, times_ms=times, call_ms=calls, kept_ms=kept_ms,
                        repack_ms=repack_ms, walk_bound_ms=walk_bound,
                        walk_bound_by=walk_by, critical_path_bound_ms=critical,
                        distribution=dist, heaviest_tile=heavy,
                        heaviest_counts=sp[heavy].tolist(), agreement=agreement)
        results[f"walk_{key}"] = out[key]
        del prep, hp, sp
    return out


def _with_env(values: dict, fn):
    """Run fn() with these environment variables set, then restore them."""
    import os

    saved = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        return fn()
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _sweep_phase(pt, data, cam, counters, results, tag):
    """The JAX package's round-5 experiment on the card: the headline shape
    through `make_budget` under TPT_MXU_DETS=0 and =1, in turns (0, 1, 1,
    0), SWEEP_FRAMES frames a call; device ms/frame from `device_time`
    (torch.profiler's CUDA activity), wall ms/frame by CUDA-synchronised host
    clock.  Launch counts are set to 0 just before each timed call and read
    just after: =1 may launch only the MXU nf kernel, =0 only the FP32 one.
    One frame of each must agree by the outlier rule.  Then one frame under
    TPT_MXU_DETS=1 with TPT_CULL=list and =cond, the MXU list and cond
    kernels' main path.  Returns the MXU kernels' launches."""
    import torch

    from tpu_pathtracer_torch.render.benchmark import make_budget

    budget = make_budget(WIDTH, HEIGHT, 1, BOUNCES)
    params = pt.RenderParams.create(cam, frame=1)
    print(f"sweep: make_budget at {WIDTH}x{HEIGHT}, 1 spp, {BOUNCES} bounces, {SWEEP_FRAMES} frames "
          "a call, TPT_MXU_DETS=0 / =1")
    frames, wall, dev, launches = {}, {"0": [], "1": []}, {"0": [], "1": []}, {}
    records = {"0": [], "1": []}
    walks = {"0": ("mt_nf", WALK_KERNELS["nf"]), "1": ("mt_nf_mxu", WALK_KERNELS["nf_mxu"])}
    for flag in ("0", "1", "1", "0"):
        def timed():
            if flag not in frames:
                frames[flag] = budget(data, params, 1).clone()  # also the warm-up
            torch.cuda.synchronize()
            for fn in counters.values():
                fn.launches = 0
            t0 = time.perf_counter()
            budget(data, params, SWEEP_FRAMES)
            torch.cuda.synchronize()
            wall[flag].append((time.perf_counter() - t0) * 1e3 / SWEEP_FRAMES)
            launches[flag] = {n: fn.launches for n, fn in counters.items()}
            # the profiled call: its device time, and the walk kernel's records beside the
            # wrapper's launches in the same call
            wrapper, walk = walks[flag]
            called = []

            def profiled():
                before = counters[wrapper].launches
                budget(data, params, SWEEP_FRAMES)
                called.append(counters[wrapper].launches - before)

            dt = _device_time(profiled, match=walk)
            total = sum(dt["programs"].values())
            _check(dt["ok"] and total > 0, f"no device time from the profiler: {dt}")
            dev[flag].append(total * 1e3 / SWEEP_FRAMES)
            records[flag].append((dt["count"], called[-1]))

        _with_env({"TPT_MXU_DETS": flag}, timed)
    for flag, kernel in (("0", "mt_nf"), ("1", "mt_nf_mxu")):
        got = launches[flag]
        _check(got[kernel] >= SWEEP_FRAMES and not _mt_launched(got, (kernel,)),
               f"TPT_MXU_DETS={flag}: launches {got}")
        dropped = sum(n - c for c, n in records[flag])
        results[f"sweep_mxu{flag}"] = dict(device_ms=dev[flag], wall_ms=wall[flag], launches=got,
                                           walk_records_vs_launches=records[flag])
        print(f"timing {tag}: sweep TPT_MXU_DETS={flag}: device {statistics.mean(dev[flag]):.3f} "
              f"ms/frame ({', '.join(f'{x:.3f}' for x in dev[flag])}"
              + (f"; the profiler dropped {dropped} walk kernel records, so these read low" if dropped
                 else "") + f"), wall {statistics.mean(wall[flag]):.3f} ms/frame "
              f"({', '.join(f'{x:.3f}' for x in wall[flag])}); launches {got}")
        print(f"sweep TPT_MXU_DETS={flag}: profiler records of {walks[flag][1]} against "
              f"{walks[flag][0]}.launches in each profiled make_budget call: "
              + ", ".join(f"{c} of {n}" for c, n in records[flag]))
    frac, agree = _outlier_rule(frames["1"], frames["0"])
    print(f"sweep: frame under TPT_MXU_DETS=1 vs =0: outlier fraction {frac:.2e}, non-outlier mean "
          f"diff {agree:.2e}")
    results.update(sweep_outlier_frac=frac, sweep_mean_diff=agree)
    out = {"mt_nf_mxu": launches["1"]["mt_nf_mxu"]}
    for cull in ("list", "cond"):
        def frame():
            for fn in counters.values():
                fn.launches = 0
            img = budget(data, params, 1)
            torch.cuda.synchronize()
            return img, {n: fn.launches for n, fn in counters.items()}

        img, got = _with_env({"TPT_MXU_DETS": "1", "TPT_CULL": cull}, frame)
        name = f"mt_{cull}_mxu"
        _check(got[name] >= 1 and not _mt_launched(got, (name,)),
               f"TPT_MXU_DETS=1 TPT_CULL={cull}: launches {got}")
        frac, agree = _outlier_rule(img, frames["0"])
        print(f"sweep: frame under TPT_MXU_DETS=1 TPT_CULL={cull} vs the FP32 nf frame: outlier "
              f"fraction {frac:.2e}, non-outlier mean diff {agree:.2e}; launches {got}")
        results[f"sweep_{cull}_mxu"] = dict(outlier_frac=frac, mean_diff=agree, launches=got)
        out[name] = got[name]
    return out


def _cond_e2e_phase(mt_shade, trace, data, frame_params, kw, phi, counters, results, tag):
    """Cond end to end: the headline frame under TPT_CULL=nf and =cond in
    turns (nf, cond, cond, nf; CUDA-event median of 10 frames each, after 2
    warm-up frames), each selecting only its own MT kernel (launch counts
    set to 0 just before the first frame of each and read just after),
    cond's frame held to nf's by the outlier rule; then cond's wrapper on
    the primary rays `phi` at sub 64 split into its parts: padding and
    packing (`_pad_scene`, `_pad_rays`), boxes (`treelet_boxes` at 128 and
    64), table repack (`_pack_walk_table`) and walk (one call by CUDA
    events, and the kernel's device time), beside nf's whole wrapper.
    Returns the cond frame's launches of the cond kernel."""
    import torch

    from tpu_pathtracer_torch.ops.kernels.mt_intersect import treelet_boxes

    frames, times, launches = {}, {"nf": [], "cond": []}, {}
    for cull in ("nf", "cond", "cond", "nf"):
        def run(cull=cull):
            if cull not in frames:
                for fn in counters.values():
                    fn.launches = 0
                frames[cull] = trace.render_frame(data, frame_params, **kw)
                torch.cuda.synchronize()
                launches[cull] = {n: fn.launches for n, fn in counters.items()}
            times[cull].append(_time_ms(lambda: trace.render_frame(data, frame_params, **kw), 2,
                                        10))

        _with_env({"TPT_CULL": cull}, run)
    for cull in ("nf", "cond"):
        got = launches[cull]
        _check(got[f"mt_{cull}"] >= 1 and not _mt_launched(got, (f"mt_{cull}",)),
               f"TPT_CULL={cull} frame: launches {got}")
    frac, agree = _outlier_rule(frames["cond"], frames["nf"])
    paths = WIDTH * HEIGHT
    print(f"cond end to end: the headline frame under TPT_CULL=cond vs =nf: outlier fraction "
          f"{frac:.2e}, non-outlier mean diff {agree:.2e}; launches nf {launches['nf']}, cond "
          f"{launches['cond']}")
    print(f"timing {tag}: headline frame in turns (nf, cond, cond, nf): "
          + ", ".join(f"{x:.3f}" for x in (times["nf"][0], *times["cond"], times["nf"][1]))
          + f" ms; nf {paths / statistics.mean(times['nf']) / 1e3:.3f} Mpaths/s, cond "
          f"{paths / statistics.mean(times['cond']) / 1e3:.3f} Mpaths/s")

    tri = data.packed.tri_pos
    sub, tile = mt_shade.SUB_TRIS, mt_shade._tile_rays(None)
    tri_padded, cols_rows = mt_shade._pad_scene(tri, sub)
    prep = mt_shade._prepare_cond(tri, phi, None, sub)
    table = mt_shade._pack_walk_table(prep[1], sub)
    parts = {
        "pad_and_pack": lambda: (mt_shade._pad_scene(tri, sub), mt_shade._pad_rays(phi, tile)),
        "boxes": lambda: (treelet_boxes(tri_padded, mt_shade.CHUNK_TRIS),
                          treelet_boxes(tri_padded, sub)),
        "repack": lambda: mt_shade._pack_walk_table(prep[1], sub),
        "walk": lambda: mt_shade._walk_cond_table_cuda(prep[0], table, *prep[2:]),
        "wrapper": lambda: mt_shade.mt_intersect_cond_phi(tri, phi),
        "nf_wrapper": lambda: mt_shade.mt_intersect_nf_phi(tri, phi),
    }
    split = {name: _time_ms(fn, 3, 20) for name, fn in parts.items()}
    split["walk_kernel"] = _kernel_ms(parts["walk"], WALK_KERNELS["cond"])
    print(f"timing {tag}: mt_cond primary wrapper (sub 64) {split['wrapper']:.4f} ms: padding and "
          f"packing {split['pad_and_pack']:.4f}, boxes {split['boxes']:.4f}, table repack "
          f"{split['repack']:.4f}, walk {split['walk']:.4f} ms (its kernel "
          f"{split['walk_kernel']:.4f} ms by CUDA events); mt_nf wrapper "
          f"{split['nf_wrapper']:.4f} ms")
    results["cond_e2e"] = dict(frame_ms=times, outlier_frac=frac, mean_diff=agree,
                               launches=launches, wrapper_split_ms=split)
    return launches["cond"]["mt_cond"]


def _cli_quiet(argv):
    """`tpu_pathtracer_torch.cli.main(argv)` in this process with its output
    kept; checks the exit code; (stdout, stderr, seconds)."""
    import contextlib
    import io

    from tpu_pathtracer_torch.cli import main as cli

    out, err = io.StringIO(), io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli(argv)
    _check(rc == 0, f"cli {argv}: exit {rc}\n{err.getvalue()}")
    return out.getvalue(), err.getvalue(), time.perf_counter() - t0


def _cli_phase(results, tag):
    """The port's CLI in this process, on the card: `benchmark` at the
    headline shape (its record must hold: no 'suspect', a device time);
    `render` of 16 frames with --timing and --checkpoint, then --resume to
    32 frames, whose accumulation must equal a fresh 32-frame render's bit
    for bit, with nonzero pass timings; `render --env sky:elevation=30`."""
    import numpy as np

    out, err, sec = _cli_quiet(["benchmark", "--width", str(WIDTH), "--height", str(HEIGHT),
                         "--bounces", str(BOUNCES)])
    rec = json.loads(out.strip().splitlines()[-1])
    print(f"cli benchmark ({sec:.1f} s): {json.dumps(rec)}")
    _check("suspect" not in rec and "device_per_frame_ms" in rec, f"cli benchmark record {rec}")
    results["cli_benchmark"] = rec

    build = ROOT / "build"
    build.mkdir(exist_ok=True)
    base = ["render", "--no-denoise", "--tonemap", "aces"]
    paths = {k: build / f"chip_smoke_cli_{k}" for k in ("first.npz", "resumed.npz", "fresh.npz")}
    _, err, _ = _cli_quiet(base + ["--frames", "16", "--timing", "--checkpoint",
                                   str(paths["first.npz"]), "-o",
                                   str(build / "chip_smoke_cli_16.png")])
    timings = {line.split()[0]: float(line.split()[1]) for line in err.splitlines()
               if line.strip().endswith("us/frame")}
    print(f"cli render 16 frames --timing: pass timings {timings} us/frame")
    _check(set(timings) == {"raytrace", "accumulate", "fullscreen"}
           and all(v > 0 for v in timings.values()), f"cli render --timing: {timings}")
    _cli_quiet(base + ["--frames", "32", "--resume", str(paths["first.npz"]), "--checkpoint",
                       str(paths["resumed.npz"]), "-o", str(build / "chip_smoke_cli_resumed.png")])
    _cli_quiet(base + ["--frames", "32", "--checkpoint", str(paths["fresh.npz"]),
                       "-o", str(build / "chip_smoke_cli_fresh.png")])
    resumed, fresh = np.load(paths["resumed.npz"]), np.load(paths["fresh.npz"])
    same = (np.array_equal(resumed["acc"], fresh["acc"])
            and int(resumed["frame"]) == int(fresh["frame"]) == 33)
    print(f"cli render --resume to 32 frames vs a fresh 32-frame render: accumulation equal bit "
          f"for bit: {same}")
    _check(same, "cli resume differs from a fresh render")
    sky = build / "chip_smoke_cli_sky.png"
    _, _, sec = _cli_quiet(["render", "--env", "sky:elevation=30", "--frames", "16", "-o",
                            str(sky)])
    _check(sky.exists() and sky.stat().st_size > 1000, "cli sky render wrote no image")
    print(f"cli render --env sky:elevation=30 ({sec:.1f} s) -> {sky.relative_to(ROOT)}")
    results.update(cli_render_timings_us=timings, cli_resume_equal=same)


GLTF_BOUNCES = 6  # the gltf+viewer phase's frames: 512x512, 1 sample per pixel
VIEWER_FRAMES = 16  # progressive frames the viewer must serve from an uploaded GLB
VIEWER_TIMEOUT = 180.0  # s, for those frames (the upload's compile included)
PNG_REQUESTS = 20  # /frame.png fetches timed in each viewer run


def _gltf_viewer_phase(pt, trace, counters, results, tag):
    """glTF and Draco import, export and the viewer on the card.  The
    default scene (through `cli export`) and the stress scene
    mesh_scene(320) (through `save_glb`) go to GLB three ways: plain, Draco
    lossless (0 bits) and Draco at 14/10 bits.  Each loads back with
    normalize=False and renders one frame at 512x512, 1 sample per pixel, 6
    bounces through 'auto' (#1 for the default scene, #3 for the mesh),
    every launch count set to 0 just before and read just after: the
    lossless frame must equal the plain GLB's bit for bit, the plain GLB's
    the procedural scene's (bit-equal, else the outlier rule), and the
    14-bit positions stay within one quantisation step.  Then `cli render
    --scene mesh.glb` (normalized, as the CLI loads it) and `cli export`,
    then `_viewer_run` with the Draco mesh GLB: checked once, and timed in
    turns against a session whose requests wait on the lock alone (the
    JAX session's locking): no turn, turn, turn, no turn."""
    import contextlib

    import numpy as np
    import torch

    from tpu_pathtracer_torch.io.gltf import load_gltf, save_glb
    from tpu_pathtracer_torch.scene.envmap import gradient_sky
    from tpu_pathtracer_torch.viewer import ViewerSession

    out_dir = ROOT / "build"
    out_dir.mkdir(exist_ok=True)
    kw = dict(width=WIDTH, height=HEIGHT, aspect=WIDTH / HEIGHT, samples_per_frame=1,
              max_bounces=GLTF_BOUNCES)
    params = pt.RenderParams.create(pt.Camera.create(**CAMERA, device="cuda"), frame=1)
    ways = {"plain": [], "lossless": ["--draco", "--draco-bits", "0", "--draco-normal-bits", "0"],
            "draco14": ["--draco"]}
    procedural = {"default": pt.default_scene(gradient_sky(64, 128)),
                  "mesh": _mesh_scene(pt, STRESS_SEGMENTS)}
    expect = {"default": "mt_nf", "mesh": "mt_stream"}
    out = {}
    for name, proc in procedural.items():
        paths = {way: out_dir / f"chip_smoke_{name}_{way}.glb" for way in ways}
        for way, flags in ways.items():
            if name == "default":
                _cli_quiet(["export", "-o", str(paths[way]), *flags])
            else:
                bits = (0, 0) if way == "lossless" else (14, 10)
                save_glb(proc.meshes, str(paths[way]), draco=way != "plain",
                         draco_position_bits=bits[0], draco_normal_bits=bits[1])
        sizes = {way: paths[way].stat().st_size for way in ways}
        loaded, decode_s = {}, {}
        for way in ways:
            t0 = time.perf_counter()
            loaded[way] = load_gltf(str(paths[way]), normalize=False)
            decode_s[way] = time.perf_counter() - t0
        for a, b in zip(loaded["plain"], proc.meshes):  # arrays and transforms exactly
            _check(np.array_equal(a.positions, b.positions) and np.array_equal(a.normals, b.normals)
                   and np.array_equal(a.indices, np.asarray(b.indices).reshape(-1, 3))
                   and np.array_equal(a.transform, b.transform), f"{name}: plain GLB arrays differ")
        for a, b in zip(loaded["lossless"], loaded["plain"]):
            _check(all(np.array_equal(getattr(a, f), getattr(b, f)) for f in
                       ("positions", "normals", "indices", "transform")),
                   f"{name}: lossless Draco arrays differ from the plain GLB's")
        q_err = []
        for a, b in zip(loaded["draco14"], loaded["plain"]):
            step = float((b.positions.max(0) - b.positions.min(0)).max()) / (2 ** 14 - 1)
            err = float(np.abs(a.positions - b.positions).max())
            _check(err <= step, f"{name}: 14-bit positions off by {err} > one step {step}")
            q_err.append((err, step))
        scenes, compile_s, frames, launches = {"procedural": proc}, {}, {}, {}
        for way, meshes in loaded.items():
            scenes[way] = pt.Scene()
            for m in meshes:
                scenes[way].add(m)
            scenes[way].set_environment(proc.env_radiance)
        data = {}
        for key, sc in scenes.items():
            t0 = time.perf_counter()
            data[key] = sc.compile(device="cuda")
            torch.cuda.synchronize()
            compile_s[key] = time.perf_counter() - t0
            for fn in counters.values():
                fn.launches = 0
            frames[key] = trace.render_frame(data[key], params, **kw)
            torch.cuda.synchronize()
            launches[key] = {n: fn.launches for n, fn in counters.items() if fn.launches}
            _check(launches[key].get(expect[name], 0) >= 1
                   and not _mt_launched(launches[key], (expect[name],)),
                   f"{name} {key}: launches {launches[key]}, expected {expect[name]} alone")
            img = frames[key]
            _check(bool(torch.isfinite(img).all()) and float(img.mean()) > 0,
                   f"{name} {key}: frame not finite or black")
        _check(torch.equal(frames["lossless"], frames["plain"]),
               f"{name}: the lossless Draco frame differs from the plain GLB's")
        differ = int((frames["plain"] != frames["procedural"]).any(dim=-1).sum())
        verdict = _equal_or_outliers(frames["plain"], frames["procedural"])
        d14 = (frames["draco14"] - frames["plain"]).abs().amax(dim=-1)
        times = _in_turns({"procedural": lambda: trace.render_frame(data["procedural"], params,
                                                                     **kw),
                           "gltf": lambda: trace.render_frame(data["plain"], params, **kw)},
                          ("procedural", "gltf", "gltf", "procedural"))
        print(f"gltf {name} ({sum(len(np.asarray(m.indices).reshape(-1, 3)) for m in proc.meshes)}"
              f" triangles, {data['plain'].packed.tri_pos.shape[0]} padded): GLB bytes plain "
              f"{sizes['plain']}, Draco lossless {sizes['lossless']}, Draco 14/10 "
              f"{sizes['draco14']}; host load_gltf s plain {decode_s['plain']:.4f}, lossless "
              f"{decode_s['lossless']:.4f}, 14/10 {decode_s['draco14']:.4f}")
        print(f"gltf {name}: compile s procedural {compile_s['procedural']:.3f}, plain "
              f"{compile_s['plain']:.3f}, lossless {compile_s['lossless']:.3f}, 14/10 "
              f"{compile_s['draco14']:.3f}; launches a frame {launches['plain']}")
        print(f"gltf {name}: lossless Draco frame equal to the plain GLB's bit for bit; plain "
              f"GLB frame vs procedural: {differ} pixels differ, {verdict}; 14/10 positions "
              f"within one step (max err / step "
              + ", ".join(f"{e:.3e}/{st:.3e}" for e, st in q_err)
              + f"), its frame differs from plain's on {int((d14 > 0).sum())} pixels")
        print(f"timing {tag}: gltf {name} frame ({GLTF_BOUNCES} bounces) in turns (procedural, "
              f"glTF, glTF, procedural): {_turns(times, 'procedural', 'gltf')} ms")
        out[name] = dict(glb_bytes=sizes, load_s=decode_s, compile_s=compile_s,
                         launches=launches["plain"], plain_vs_procedural=verdict,
                         pixels_differ=differ, q14=q_err, frame_ms=times)
        del frames, data, scenes

    # the CLI on the card: render a normalized mesh GLB, export a GLB to Draco
    mesh_glb = out_dir / "chip_smoke_mesh_draco14.glb"
    for fn in counters.values():
        fn.launches = 0
    _, _, sec = _cli_quiet(["render", "--scene", str(mesh_glb), "--width", str(WIDTH),
                            "--height", str(HEIGHT), "--bounces", str(GLTF_BOUNCES),
                            "--frames", "2", "-o", str(out_dir / "chip_smoke_cli_gltf.png")])
    torch.cuda.synchronize()
    cli_launches = {n: fn.launches for n, fn in counters.items() if fn.launches}
    _check(cli_launches.get("mt_stream", 0) >= 2 and cli_launches.get("denoise", 0) >= 1,
           f"cli render --scene mesh.glb: launches {cli_launches}")
    _, err, sec_x = _cli_quiet(["export", "--scene", str(mesh_glb), "--draco", "-o",
                                str(out_dir / "chip_smoke_cli_export.glb")])
    print(f"cli render --scene {mesh_glb.name} (normalized, 2 frames, {sec:.1f} s): launches "
          f"{cli_launches}; cli export --draco ({sec_x:.2f} s): {err.strip()}")
    out["cli"] = dict(render_s=sec, launches=cli_launches, export_s=sec_x)

    # the viewer: a session on the card behind the HTTP server; the checked
    # run in turns with sessions whose requests wait on the lock alone
    class NoTurn(ViewerSession):
        """The JAX session's locking: a request waits on the lock alone."""

        @contextlib.contextmanager
        def _turn(self):
            with self.lock:
                yield

    runs = []
    for label, cls, checked in (("no turn", NoTurn, False), ("turn", ViewerSession, True),
                                ("turn", ViewerSession, False), ("no turn", NoTurn, False)):
        runs.append((label, _viewer_run(pt, counters, cls, mesh_glb, checked)))
    view = runs[1][1]
    print(f"viewer (session on cuda, {WIDTH}x{HEIGHT}, {GLTF_BOUNCES} bounces): uploaded "
          f"{mesh_glb.name} ({view['triangles']} triangles) in {view['upload_s']:.2f} s; "
          f"{view['frames']} progressive frames; launches {view['launches']}; /params reset "
          f"frame {view['reset'][0]} -> {view['reset'][1]}")
    for label, got in runs:
        lat = got["png_ms"]
        print(f"timing {tag}: viewer ({label}) {got['fps']:.2f} frames/s by the host clock "
              f"(rolling meter {got['meter_fps']} fps); /frame.png latency over "
              f"{len(lat)} requests: median {statistics.median(lat):.1f} ms, max "
              f"{max(lat):.1f} ms")
    out["viewer"] = [{"locking": label, **got} for label, got in runs]
    results["gltf_viewer"] = out
    return {"mt_nf": out["default"]["launches"].get("mt_nf", 0),
            "mt_stream": out["mesh"]["launches"].get("mt_stream", 0)
            + cli_launches.get("mt_stream", 0) + view["launches"].get("mt_stream", 0),
            "denoise": cli_launches.get("denoise", 0) + view["launches"].get("denoise", 0)}


def _viewer_run(pt, counters, session_cls, glb: Path, checked: bool) -> dict:
    """A ViewerServer on 127.0.0.1:0 with a `session_cls` session on the
    card (512x512, 6 bounces): `glb` uploaded through /upload/scene,
    VIEWER_FRAMES progressive frames awaited (frames/s by the host clock
    from the end of the first), then PNG_REQUESTS fetches of /frame.png 50
    ms apart (latency by the host clock).  `checked`: every launch count
    set to 0 before the upload and read after the fetches (the streamed
    walk a bounce, the denoise kernel for display(), no other MT kernel),
    and /params must reset the accumulation.  The server stops in a
    finally; `stop()` raises if the render loop failed or outlived its
    limit."""
    import urllib.request

    from tpu_pathtracer_torch.viewer import ViewerServer

    cfg = pt.RenderConfig(width=WIDTH, height=HEIGHT, scaling_factor=1.0, frames=2048,
                          samples_per_frame=1, max_bounces=GLTF_BOUNCES)
    server = ViewerServer(session_cls(config=cfg, device="cuda"), port=0)
    session = server.session
    server.start()
    try:
        url = server.url.rstrip("/")
        session.control("pause")  # no frame of the start-up scene past this point
        for fn in counters.values():
            fn.launches = 0
        t0 = time.perf_counter()
        req = urllib.request.Request(url + "/upload/scene", data=glb.read_bytes(), method="POST")
        with urllib.request.urlopen(req, timeout=VIEWER_TIMEOUT) as r:
            stats = json.loads(r.read())["scene_stats"]
        upload_s = time.perf_counter() - t0
        first = None
        while session.renderer.frame <= VIEWER_FRAMES:
            _check(time.perf_counter() - t0 < VIEWER_TIMEOUT,
                   f"the viewer served {session.renderer.frame - 1} frames in {VIEWER_TIMEOUT} s")
            if first is None and session.renderer.frame >= 2:
                first = (time.perf_counter(), session.renderer.frame)
            time.sleep(0.005)
        t_end, frame_end = time.perf_counter(), session.renderer.frame
        png_ms = []
        for _ in range(PNG_REQUESTS):
            t1 = time.perf_counter()
            with urllib.request.urlopen(url + "/frame.png", timeout=60) as r:
                body = r.read()
            png_ms.append((time.perf_counter() - t1) * 1e3)
            _check(body[:8] == b"\x89PNG\r\n\x1a\n", "/frame.png is not a PNG")
            time.sleep(0.05)
        state = session.state()
        got = dict(triangles=stats["triangles"], upload_s=upload_s, frames=frame_end - 1,
                   fps=(frame_end - first[1]) / (t_end - first[0]), meter_fps=state["fps"],
                   png_ms=png_ms)
        if checked:
            launches = {n: fn.launches for n, fn in counters.items() if fn.launches}
            _check(launches.get("mt_stream", 0) >= VIEWER_FRAMES
                   and launches.get("denoise", 0) >= 1
                   and not _mt_launched(launches, ("mt_stream",)), f"viewer launches {launches}")
            before = session.renderer.frame
            req = urllib.request.Request(url + "/params", data=b'{"bounces": 4}', method="POST")
            with urllib.request.urlopen(req, timeout=60) as r:
                _check(json.loads(r.read())["params"]["bounces"] == 4, "/params did not apply")
            after = session.renderer.frame
            _check(after <= 2 < before,
                   f"/params did not reset the accumulation ({before} -> {after})")
            got.update(launches=launches, reset=(before, after))
    finally:
        server.stop()
    return got


SKY_SPEC = "sky:elevation=30,azimuth=90,turbidity=3"  # the CLI's sun-sky example
SORT_WINDOW = 32768  # the binning sort's default window, the JAX package's
PRIOR_LARGE_COMPILE_S = "20.09-25.13"  # the large scene's compile with the numpy builder (PERF.md)


def _in_turns(fns: dict, order, warmup: int = 2, reps: int = 10) -> dict:
    """CUDA-event median ms of each fns[k]() (see `_time_ms`), in the turns
    `order` (e.g. off, on, on, off); {k: [ms, ...]}."""
    times = {k: [] for k in fns}
    for k in order:
        times[k].append(_time_ms(fns[k], warmup, reps))
    return times


def _device_ms_in_turns(fns: dict, order) -> dict:
    """The profiler's device time (every kernel, copy and fill) of one call
    of each fns[k](), after one unprofiled call, in the turns `order`;
    {k: [ms, ...]}."""
    times = {k: [] for k in fns}
    for k in order:
        fns[k]()
        got = _device_time(fns[k])
        _check(got["ok"], f"no device time for {k}: {got}")
        times[k].append(got["total_s"] * 1e3)
    return times


def _turns(times: dict, a, b) -> str:
    """Four readings in the turns (a, b, b, a), as ms."""
    return _fmt_ms([times[a][0], *times[b], times[a][1]])


def _equal_or_outliers(a, b) -> str:
    """'bit-equal' if the two images are, else the outlier rule's verdict
    (which must hold)."""
    import torch

    if torch.equal(a, b):
        return "bit-equal"
    frac, agree = _outlier_rule(a, b)
    return f"outlier rule: outlier fraction {frac:.2e}, non-outlier mean diff {agree:.2e}"


def _option_renderer(pt, scene, counters, what: str, env_importance=False, blue_noise=False):
    """One frame of the headline shape through `Renderer(...).render_all()`
    and `display()` with an option on, every launch count set to 0 just
    before and read just after: the nf kernel on every bounce and the
    denoise kernel, no other MT kernel.  Returns (the renderer, launches)."""
    import torch

    config = pt.RenderConfig(width=WIDTH, height=HEIGHT, frames=1, samples_per_frame=1,
                             max_bounces=BOUNCES, blue_noise=blue_noise)
    renderer = pt.Renderer(scene, pt.Camera.create(**CAMERA), config, pt.PostConfig(),
                           device="cuda", env_importance=env_importance)
    renderer.scene_data  # compiled before the counts are set to 0
    for fn in counters.values():
        fn.launches = 0
    renderer.render_all()
    image = renderer.display()
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in counters.items()}
    _check(1 <= launches["mt_nf"] <= BOUNCES and not _mt_launched(launches, ("mt_nf",))
           and launches["denoise"] == 1, f"{what} Renderer frame: launches {launches}")
    _check(bool(torch.isfinite(image).all()) and float(image.mean()) > 0.05,
           f"{what} display image not finite or black")
    print(f"{what}: Renderer frame + display(): launches {launches}, display mean "
          f"{float(image.mean()):.4f}")
    return renderer, launches


def _render_options_phase(pt, trace, scene, data, cam, counters, results, tag):
    """The render options: env importance sampling on the sun-sky scene,
    the blue-noise AA jitter, the windowed binning sort and the native BVH
    builder, each at the headline shape (512x512, 1 sample per pixel, 4
    bounces).  Each option's frame
    goes through the Renderer (nf and denoise kernels launched) and is held
    to the same frame through the plain versions on the card (bit-equal
    expected, else the outlier rule), then timed in turns against the
    option off; windows 0 and 32,768 give bit-equal images; the native
    builder's arrays are byte-equal to numpy's on the stress scene; and the
    CLI renders --env sky --env-importance --blue-noise on the card."""
    import os

    import torch

    from tpu_pathtracer_torch.accel import bvh, native
    from tpu_pathtracer_torch.scene.sky import parse_sky_spec, sun_sky
    from tpu_pathtracer_torch.utils.bluenoise import blue_noise_table

    kw = dict(width=WIDTH, height=HEIGHT, aspect=WIDTH / HEIGHT, max_bounces=BOUNCES)
    params = pt.RenderParams.create(cam, frame=1)
    out = {}

    # env importance on the sun-sky scene
    sky_scene = pt.default_scene(sun_sky(512, 1024, **parse_sky_spec(SKY_SPEC)))
    renderer, launches = _option_renderer(pt, sky_scene, counters, "env importance",
                                          env_importance=True)
    sky = renderer.scene_data
    plain = trace.render_frame(sky, params, env_importance=True, plain=True, **kw)
    verdict = _equal_or_outliers(renderer.accumulation, plain)
    frames = {"off": lambda: trace.render_frame(sky, params, **kw),
              "on": lambda: trace.render_frame(sky, params, env_importance=True, **kw)}
    times = _in_turns(frames, ("off", "on", "on", "off"))
    device = _device_ms_in_turns(frames, ("off", "on", "on", "off"))
    print(f"env importance ({SKY_SPEC}): the Renderer's frame vs the same frame through the "
          f"plain versions: {verdict}")
    print(f"timing {tag}: sun-sky frame in turns (off, on, on, off): "
          f"{_turns(times, 'off', 'on')} ms; device time {_turns(device, 'off', 'on')} ms")
    out["env_importance"] = dict(launches=launches, check=verdict, frame_ms=times,
                                 device_ms=device)
    del renderer, plain

    # blue-noise AA jitter on the headline scene
    renderer, launches = _option_renderer(pt, scene, counters, "blue noise", blue_noise=True)
    table = torch.from_numpy(blue_noise_table(64)).cuda()
    plain = trace.render_frame(data, params, blue_noise=table, plain=True, **kw)
    verdict = _equal_or_outliers(renderer.accumulation, plain)
    _check(not torch.equal(plain, trace.render_frame(data, params, plain=True, **kw)),
           "the blue-noise jitter changed nothing")
    frames = {"off": lambda: trace.render_frame(data, params, **kw),
              "on": lambda: trace.render_frame(data, params, blue_noise=table, **kw)}
    times = _in_turns(frames, ("off", "on", "on", "off"))
    device = _device_ms_in_turns(frames, ("off", "on", "on", "off"))
    print(f"blue noise: the Renderer's frame vs the same frame through the plain versions: "
          f"{verdict}")
    print(f"timing {tag}: headline frame blue noise in turns (off, on, on, off): "
          f"{_turns(times, 'off', 'on')} ms; device time {_turns(device, 'off', 'on')} ms")
    out["blue_noise"] = dict(launches=launches, check=verdict, frame_ms=times, device_ms=device)
    del renderer, plain

    # the windowed binning sort: one global sort against 8 windows of 32,768
    images = {w: trace.render_frame(data, params, sort_window=w, **kw) for w in (0, SORT_WINDOW)}
    _check(torch.equal(images[0], images[SORT_WINDOW]), "sort windows 0 and 32768 differ")
    frames = {w: (lambda w=w: trace.render_frame(data, params, sort_window=w, **kw))
              for w in (0, SORT_WINDOW)}
    times = _in_turns(frames, (0, SORT_WINDOW, SORT_WINDOW, 0))
    device = _device_ms_in_turns(frames, (0, SORT_WINDOW, SORT_WINDOW, 0))
    ro, rd, _ = _primary_rays(cam, data.packed.tri_pos.device)
    key = trace._coherence_key(ro, rd, torch.ones_like(ro[0], dtype=torch.bool),
                               trace._key_boxes(data.packed.tri_pos))
    sort_ms = _in_turns({w: (lambda w=w: trace._windowed_sort(key, w)) for w in (0, SORT_WINDOW)},
                        (0, SORT_WINDOW, SORT_WINDOW, 0), 3, 30)
    profiled = {}
    for w in (0, SORT_WINDOW):
        got = _device_time(lambda w=w: trace.render_frame(data, params, sort_window=w, **kw))
        profiled[w] = {name: sec * 1e3 for name, sec in got["programs"].items()
                       if "sort" in name.lower()}
    print(f"sort window: frames with windows 0 and {SORT_WINDOW} bit-equal")
    print(f"timing {tag}: headline frame in turns (window 0, {SORT_WINDOW}, {SORT_WINDOW}, 0): "
          f"{_turns(times, 0, SORT_WINDOW)} ms; device time {_turns(device, 0, SORT_WINDOW)} "
          f"ms; the sort of the primary rays' 262,144 keys alone: "
          f"{_turns(sort_ms, 0, SORT_WINDOW)} ms")
    for w, got in profiled.items():
        print(f"profiler {tag}: window {w}: sort kernels of one frame (device ms, "
              f"{sum(got.values()):.4f} in all): "
              + "; ".join(f"{name[:90]} {ms:.4f}" for name, ms in got.items()))
    out["sort_window"] = dict(frame_ms=times, device_ms=device, sort_ms=sort_ms,
                              profiled_sort_ms=profiled)
    del images

    # the native BVH builder on the stress scene, then the large scene's compile
    _check(not os.environ.get("TPU_PT_NO_NATIVE") and native.get_lib() is not None,
           "the native BVH builder did not load")
    p0, p1, p2 = _mesh_scene(pt, STRESS_SEGMENTS).gather_triangles()[:3]
    built, host_s = {}, {}
    for label, use in (("native", True), ("numpy", False)):
        t0 = time.perf_counter()
        flat = bvh.build_bvh_flat(p0, p1, p2, native=use)
        links = bvh.flat_to_links(flat, end=2 * flat["left"].shape[0], native=use)
        host_s[label] = time.perf_counter() - t0
        built[label] = {**flat, **{f"links_{k}": v for k, v in links.items()}}
    same = all(built["native"][k].dtype == v.dtype and built["native"][k].tobytes() == v.tobytes()
               for k, v in built["numpy"].items())
    _check(same, "the native BVH differs from numpy's")
    large = _mesh_scene(pt, LARGE_SEGMENTS)
    t0 = time.perf_counter()
    large = large.compile(device="cuda")
    torch.cuda.synchronize()
    large_s = time.perf_counter() - t0
    print(f"native BVH ({native.library_path().name}): stress scene {p0.shape[0]} triangles, "
          f"build_bvh_flat + flat_to_links byte-equal to numpy's; host {host_s['native']:.3f} s "
          f"native, {host_s['numpy']:.3f} s numpy")
    print(f"timing {tag}: large scene ({large.packed.tri_pos.shape[0]} padded triangles) "
          f"compile with the native builder {large_s:.2f} s (numpy builder, earlier runs: "
          f"{PRIOR_LARGE_COMPILE_S} s)")
    out["native_bvh"] = dict(host_s=host_s, byte_equal=same, large_compile_s=large_s)
    del large, built

    # the CLI with both options on the card
    from tpu_pathtracer_torch.cli import main as cli

    png = ROOT / "build" / "chip_smoke_cli_options.png"
    t0 = time.perf_counter()
    rc = cli(["render", "--env", "sky", "--env-importance", "--blue-noise", "--frames", "16",
              "-o", str(png)])
    _check(rc == 0 and png.exists() and png.stat().st_size > 1000,
           f"cli render --env sky --env-importance --blue-noise: exit {rc}")
    print(f"cli render --env sky --env-importance --blue-noise ({time.perf_counter() - t0:.1f} s)"
          f" -> {png.relative_to(ROOT)}")
    results["render_options"] = out


SHARD_TIMEOUT = 300.0  # s, a spawned group of ranks from start to end
SHARD_GRAD_TOL = dict(atol=1e-6, rtol=1e-4)  # tests/test_parallel.py:143


def _sharded_rank(spec) -> dict:
    """One of the sharded phase's two ranks (gloo, both on the one card),
    spawned by `parallel.dryrun.run`.  Its numbers go back to the parent,
    which checks and prints them: the main path over 2 tiles (the step,
    then `Renderer(shard=ShardConfig(2)).render_all()` and `display()`, with
    the nf and denoise launch counts set to 0 just before and read just
    after) against the unsharded frame and Renderer; a 1x2 mesh against the
    mean of the unsalted and salted frames; the sharded loss gradient at
    the training step's size against the unsharded one; the sharded frame
    and the unsharded one timed in turns, the all-reduce of the image, and
    `bench_scaling` at tiles 1 and 2.  Both ranks render rank 0's scene
    and camera, broadcast over gloo by `multihost.replicate`: rank 1 starts
    from a black sky and another camera."""
    import dataclasses

    import numpy as np
    import torch
    import torch.distributed as dist

    import tpu_pathtracer_torch as pt
    from tpu_pathtracer_torch import diff
    from tpu_pathtracer_torch.ops import trace
    from tpu_pathtracer_torch.ops.kernels import denoise as kdenoise
    from tpu_pathtracer_torch.ops.kernels import mt_shade
    from tpu_pathtracer_torch.parallel import (make_mesh, make_sharded_frame_step,
                                               make_sharded_value_and_grad, multihost,
                                               zeros_acc)
    from tpu_pathtracer_torch.parallel.sharded import _SALT, assemble
    from tpu_pathtracer_torch.render.benchmark import bench_scaling
    from tpu_pathtracer_torch.render.renderer import make_frame_step
    from tpu_pathtracer_torch.scene.envmap import gradient_sky

    rank = dist.get_rank()
    dev = torch.device(spec["device"])
    w, h, b = spec["width"], spec["height"], spec["bounces"]
    kw = dict(width=w, height=h, aspect=w / h, max_bounces=b)
    scene = pt.default_scene(gradient_sky(64, 128))
    data = scene.compile(device=dev)
    cam = pt.Camera.create(**CAMERA, device=dev)
    params = pt.RenderParams.create(cam, frame=1)
    counters = (mt_shade.mt_intersect_nf_phi, kdenoise.smart_denoise)
    out = {}

    def diffs(a, b):  # differing pixels; outlier fraction; mean diff of the others
        d = (a.double() - b.double()).abs()
        outlier = d.amax(dim=-1) > 0.05
        return np.array([int((a != b).any(dim=-1).sum()), float(outlier.double().mean()),
                         float(d[~outlier].mean())])

    mesh = make_mesh(tiles=2, samples=1, device=dev)
    mine, my_params = data, params
    if rank != 0:
        mine = dataclasses.replace(data, env=dataclasses.replace(
            data.env, radiance=torch.zeros_like(data.env.radiance)))
        my_params = pt.RenderParams.create(
            pt.Camera.create(**dict(CAMERA, position=(1.0, 2.0, 3.0)), device=dev), frame=1)
    rdata, rparams = multihost.replicate(mesh, mine), multihost.replicate(mesh, my_params)
    out["replicated"] = np.array([torch.equal(rdata.env.radiance, data.env.radiance),
                                  torch.equal(rparams.camera.position, params.camera.position)])
    step = make_sharded_frame_step(mesh, **kw)
    config = pt.RenderConfig(width=w, height=h, frames=2, max_bounces=b)
    for fn in counters:
        fn.launches = 0
    img = assemble(mesh, step(rdata, rparams, zeros_acc(mesh, h, w)), h)
    r = pt.Renderer(scene, cam, config, device=dev, shard=pt.ShardConfig(tiles=2))
    acc = r.render_all()
    disp = r.display()
    if dev.type == "cuda":
        torch.cuda.synchronize()
    out["launches"] = np.array([fn.launches for fn in counters])
    out["tiles_vs_unsharded"] = diffs(img, trace.render_frame(data, params, **kw))
    ustep = make_frame_step(w, h, w / h, 1, b, True)
    uacc = torch.zeros((h, w, 3), device=dev)
    for f in (1, 2):
        ustep(data, pt.RenderParams.create(cam, frame=f), uacc)
    out["renderer_vs_unsharded"] = diffs(acc, uacc)
    out["display"] = np.array([float(disp.min()), float(disp.max()), float(disp.mean()),
                               float(torch.isfinite(disp).all())])

    mesh2 = make_mesh(tiles=1, samples=2, device=dev)
    step2 = make_sharded_frame_step(mesh2, samples_per_frame=2, **kw)
    img2 = assemble(mesh2, step2(data, params, zeros_acc(mesh2, h, w)), h)
    mean2 = (trace.render_frame(data, params, **kw)
             + trace.render_frame(data, params, seed_salt=_SALT, **kw)) / 2.0
    out["samples_vs_streams"] = diffs(img2, mean2)

    n = spec["invert_size"]
    tkw = dict(width=n, height=n, aspect=1.0, samples_per_frame=1, max_bounces=b)
    tdata = pt.default_scene(gradient_sky(512, 1024)).compile(device=dev)
    target = diff.render_frame_diff(tdata, params, **tkw).detach()
    wrong = torch.from_numpy(np.random.default_rng(0).random(
        tuple(tdata.materials.color.shape)).astype(np.float32)).to(dev)
    loss, grads = make_sharded_value_and_grad(mesh, tdata, params, **tkw)(
        {"materials.color": wrong}, target)
    leaf = wrong.clone().requires_grad_(True)
    l_ref = diff.make_param_loss(diff.make_loss(target, **tkw), tdata, params,
                                 ["materials.color"])({"materials.color": leaf})
    (g_ref,) = torch.autograd.grad(l_ref, [leaf])
    out["vg_loss"] = np.array([float(loss), float(l_ref.detach())])
    out["vg_grad"] = np.stack([grads["materials.color"].cpu().numpy(), g_ref.cpu().numpy()])

    if dev.type == "cuda":
        sacc = zeros_acc(mesh, h, w)
        fns = {"unsharded": lambda: ustep(data, params, uacc),
               "sharded": lambda: step(data, params, sacc)}
        turns = []
        for k in ("unsharded", "sharded", "sharded", "unsharded"):
            dist.barrier()
            turns.append(_time_ms(fns[k], 2, 10) if k == "sharded" or rank == 0 else np.nan)
            dist.barrier()
        out["frame_turns_ms"] = np.array(turns)
        image = torch.zeros((h, w, 3), device=dev)
        dist.barrier()
        out["all_reduce_ms"] = np.array(
            _time_ms(lambda: dist.all_reduce(image, group=mesh.group), 2, 10))
        rows = bench_scaling(data, cam, width=w, height=h, spp=1, bounces=b, tile_counts=(1, 2),
                             reps=3, target_seconds=0.5)
        out["scaling"] = np.array([[r["tiles"], r["per_frame_s"], r["efficiency"], r["ok"]]
                                   for r in rows])
    return out


def _sharded_cli(tag) -> dict:
    """`cli render --shard-tiles 2` under torchrun, two ranks sharing the
    one card: each must join with gloo (the ranks outnumber the cards), and
    rank 0's accumulation (written as .hdr) must equal the unsharded CLI's
    at the same settings (or differ on near-ties only, by the outlier
    rule)."""
    import os
    import signal

    import numpy as np
    import torch

    from tpu_pathtracer_torch.cli import main as cli
    from tpu_pathtracer_torch.io.hdr import read_hdr

    args = ["render", "--width", str(WIDTH), "--height", str(HEIGHT), "--bounces", str(BOUNCES),
            "--frames", "4"]
    sharded = ROOT / "build" / "chip_smoke_cli_sharded.hdr"
    plain = ROOT / "build" / "chip_smoke_cli_unsharded.hdr"
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "2",
         "-m", "tpu_pathtracer_torch.cli", *args, "--shard-tiles", "2", "-o", str(sharded)],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        start_new_session=True)
    try:
        log, _ = proc.communicate(timeout=SHARD_TIMEOUT)
    finally:  # torchrun and both ranks, whatever happened
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
    spawn_s = time.perf_counter() - t0
    _check(proc.returncode == 0, f"torchrun cli render --shard-tiles 2: exit {proc.returncode}"
           f"\n{log[-4000:]}")
    # the ranks' lines may interleave on the shared pipe
    joined = sorted(re.findall(r"rank (\d) of 2 \((\w+)\)", log))
    _check(joined == [("0", "gloo"), ("1", "gloo")], f"the two ranks joined as {joined}")
    _check(cli([*args, "-o", str(plain)]) == 0, "cli render (unsharded) failed")
    a, b = (torch.from_numpy(np.ascontiguousarray(read_hdr(str(f)))) for f in (sharded, plain))
    n_diff = int((a != b).any(dim=-1).sum())
    frac, _ = _outlier_rule(a, b)
    who = ", ".join(f"rank {r} {backend}" for r, backend in joined)
    print(f"cli render --shard-tiles 2 under torchrun ({tag}; 2 ranks on one card, joined "
          f"{who}; {spawn_s:.1f} s): its accumulation against the unsharded "
          f"CLI's at {WIDTH}x{HEIGHT}, 4 frames: {n_diff} pixels differ (outlier fraction "
          f"{frac:.2e})")
    return dict(cli_joined=joined, cli_diff_pixels=n_diff, cli_s=spawn_s)


def _sharded_phase(pt, trace, data, cam, counters, results, tag):
    """The sharded path (`parallel/`) at the headline shape: in this process
    the 2 tile bands and the 2x2 shards through `render_frame`'s band hooks
    (their composite against the unsharded frame, the nf walk launched once
    a bounce a band; the plain loop's bands bit-equal); two gloo ranks on
    the card (`_sharded_rank`); the sharded CLI under torchrun
    (`_sharded_cli`); one NCCL rank whose (1, 1) step equals the unsharded
    frame.  Returns the nf and denoise launches of the path (the CLI's ranks
    count their own)."""
    import tempfile

    import numpy as np
    import torch
    import torch.distributed as dist

    from tpu_pathtracer_torch.parallel import dryrun, make_mesh, make_sharded_frame_step
    from tpu_pathtracer_torch.parallel import multihost, zeros_acc
    from tpu_pathtracer_torch.parallel.sharded import assemble, shard_frame

    params = pt.RenderParams.create(cam, frame=1)
    kw = dict(width=WIDTH, height=HEIGHT, aspect=WIDTH / HEIGHT, max_bounces=BOUNCES)
    nf = counters["mt_nf"]
    out = {}

    def shards(tiles, samples, **extra):
        nf.launches = 0
        got = [[shard_frame(data, params, tile=t, sample=s, tiles=tiles, samples=samples,
                            samples_per_frame=samples, **kw, **extra) for s in range(samples)]
               for t in range(tiles)]
        torch.cuda.synchronize()
        return got, nf.launches

    bands, launches = shards(2, 1)
    _check(launches == 2 * BOUNCES, f"nf launched {launches} times for 2 bands of {BOUNCES} "
           f"bounces")
    full = trace.render_frame(data, params, **kw)
    comp = torch.cat([b[0] for b in bands])
    n_diff = int((comp != full).any(dim=-1).sum())
    frac, agree = _outlier_rule(comp, full)
    print(f"sharded bands in process: nf launched {launches} times (2 bands x {BOUNCES} "
          f"bounces); the 2 bands put together against the unsharded frame: {n_diff} pixels "
          f"differ (outlier fraction {frac:.2e}, non-outlier mean diff {agree:.2e})")
    quads, quad_launches = shards(2, 2)
    _check(quad_launches == 4 * BOUNCES, f"nf launched {quad_launches} times for 4 shards")
    comp2 = torch.cat([(q[0] + q[1]) / 2.0 for q in quads])
    ref2 = trace.render_frame(data, params, samples_per_frame=2, **kw)
    _check(bool(torch.isfinite(comp2).all()), "2x2 composite not finite")
    mean_gap = float((comp2.mean() - ref2.mean()).abs())
    _check(mean_gap < 0.01, f"2x2 composite mean {float(comp2.mean())} against "
           f"{float(ref2.mean())}")
    plain, plain_launches = shards(2, 1, intersector="mt")
    _check(plain_launches == 0, "the plain loop's bands launched the nf walk")
    _check(torch.equal(torch.cat([b[0] for b in plain]),
                       trace.render_frame(data, params, intersector="mt", **kw)),
           "the plain loop's 2 bands differ from its unsharded frame")
    print(f"sharded bands in process: 2x2 shards launched nf {quad_launches} times, composite "
          f"mean {float(comp2.mean()):.4f} against {float(ref2.mean()):.4f} at 2 spp; the "
          f"plain loop's ('mt') bands bit-equal to its unsharded frame")
    out.update(band_launches=launches, band_diff_pixels=n_diff, band_outlier_frac=frac,
               shard_launches=quad_launches)
    del bands, quads, plain, comp, comp2

    spec = {"device": "cuda", "backend": "gloo", "width": WIDTH, "height": HEIGHT,
            "bounces": BOUNCES, "invert_size": INVERT_SIZE}
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        ranks = dryrun.run(_sharded_rank, 2, spec, tmp, timeout=SHARD_TIMEOUT)
    spawn_s = time.perf_counter() - t0
    for i, r in enumerate(ranks):
        nf_l, den_l = (int(x) for x in r["launches"])
        _check(nf_l >= BOUNCES and den_l >= 1, f"rank {i}: nf {nf_l}, denoise {den_l} launches")
        tiles, rend, samp = (r[k] for k in ("tiles_vs_unsharded", "renderer_vs_unsharded",
                                            "samples_vs_streams"))
        for what, d in (("step", tiles), ("Renderer", rend)):
            _check(d[1] < 0.01 and d[2] < 1e-4, f"rank {i}: 2-tile {what} against unsharded {d}")
        _check(samp[0] == 0, f"rank {i}: 1x2 mesh differs from the streams' mean on {samp[0]} px")
        _check(bool(r["replicated"].all()), f"rank {i}: replicate gave another scene or camera "
               f"than rank 0's {r['replicated']}")
        lo, hi, mean, finite = r["display"]
        _check(finite == 1.0 and lo >= 0.0 and hi <= 1.0 and mean > 0.05,
               f"rank {i}: display {r['display']}")
        l_sh, l_ref = r["vg_loss"]
        _check(abs(l_sh - l_ref) <= 1e-5 * abs(l_ref), f"rank {i}: loss {l_sh} against {l_ref}")
        g_sh, g_ref = r["vg_grad"]
        _check(bool(np.allclose(g_sh, g_ref, **SHARD_GRAD_TOL))
               and not np.allclose(g_sh, 2 * g_ref, **SHARD_GRAD_TOL),
               f"rank {i}: gradients {g_sh} against {g_ref}")
        print(f"sharded rank {i} of 2 (gloo, one card): nf {nf_l}, denoise {den_l} launches; "
              f"2-tile step against the unsharded frame {int(tiles[0])} pixels differ "
              f"(outliers {tiles[1]:.2e}), Renderer 2 frames {int(rend[0])} (outliers "
              f"{rend[1]:.2e}), on rank 0's scene and camera from replicate; 1x2 mesh equal "
              f"to the mean of the two streams; loss "
              f"{l_sh:.6f} against {l_ref:.6f}, max gradient difference "
              f"{float(np.abs(g_sh - g_ref).max()):.2e}")
    r0 = ranks[0]
    turns, ar_ms, scaling = r0["frame_turns_ms"], float(r0["all_reduce_ms"]), r0["scaling"]
    print(f"timing {tag}: frame unsharded, 2-tile sharded, sharded, unsharded (2 gloo ranks "
          f"sharing the one card, rank 0's CUDA events, median of 10): {_fmt_ms(turns)} ms; "
          f"rank 1 sharded {_fmt_ms(ranks[1]['frame_turns_ms'][1:3])} ms")
    print(f"timing {tag}: all_reduce of the {HEIGHT}x{WIDTH}x3 f32 image on gloo (2 ranks, one "
          f"card): {ar_ms:.3f} ms")
    for t, per_frame, eff, ok in scaling:
        print(f"timing {tag}: bench_scaling tiles={int(t)} (2 ranks on one card, no claim of "
              f"scaling): {per_frame * 1e3:.3f} ms/frame, efficiency {eff:.3f}, ok {bool(ok)}")
    print(f"sharded ranks: spawned, ran and joined in {spawn_s:.1f} s")
    out.update(rank_launches=[r["launches"].tolist() for r in ranks],
               frame_turns_ms=turns.tolist(), all_reduce_ms=ar_ms, scaling=scaling.tolist(),
               spawn_s=spawn_s, rank_frame_diff=[r["tiles_vs_unsharded"].tolist() for r in ranks])

    out.update(_sharded_cli(tag))

    with tempfile.TemporaryDirectory() as tmp:
        multihost.initialize("nccl", f"file://{tmp}/store", 1, 0)
        try:
            mesh = make_mesh(tiles=1, samples=1)
            step = make_sharded_frame_step(mesh, **kw)
            img = assemble(mesh, step(data, params, zeros_acc(mesh, HEIGHT, WIDTH)), HEIGHT)
            want = trace.render_frame(data, params, **kw)
            _check(torch.equal(img, want),
                   "the NCCL rank's (1, 1) step differs from the unsharded frame")
            dist.all_reduce(img)  # the communicator runs a collective: a sum over one rank
            _check(torch.equal(img, want), "an NCCL all-reduce over one rank changed the image")
            print(f"sharded NCCL rank ({dist.get_backend()}, world 1): (1, 1) step bit-equal "
                  f"to the unsharded frame, and after an all-reduce")
        finally:
            dist.destroy_process_group()
    results["sharded"] = out
    return (launches + quad_launches + sum(int(r["launches"][0]) for r in ranks),
            sum(int(r["launches"][1]) for r in ranks))


WAVE_CHUNK = 2048  # render_frame_wavefront's default chunk
WAVE_PADDED = 500  # a 500x500 frame: 250,000 rays, not a multiple of the chunk
FAULT_TIMEOUT = 300.0  # s, the injected-fault child from start to end


def _mt_counts(counters) -> dict:
    import torch

    torch.cuda.synchronize()
    return {n: fn.launches for n, fn in counters.items()}


def _zero(counters) -> None:
    for fn in counters.values():
        fn.launches = 0


def _wavefront_phase(pt, trace, data, sdata, cam, counters, results, tag):
    """`ops.wavefront.render_frame_wavefront` (torch ops, no CUDA kernel)
    at the headline shape with sort_rays True and False and at 500x500 (a
    ray count the chunk does not divide), each bit-equal to the
    `render_frame(intersector='bvh')` frame and within the outlier rule of
    the default (nf kernel) frame; on the stress scene (131,072 padded
    triangles, 6 bounces) bit-equal to its 'bvh' frame.  No MT kernel may
    launch.  The wavefront and 'bvh' frames are timed in turns (bvh, wave,
    wave, bvh).  F7: the padded frame is rendered with a camera built on the
    CPU over the CUDA scene."""
    import torch

    from tpu_pathtracer_torch.ops.wavefront import render_frame_wavefront

    params = pt.RenderParams.create(cam, frame=3)
    cpu_params = pt.RenderParams.create(pt.Camera.create(**CAMERA), frame=3)  # F7
    kw = dict(width=WIDTH, height=HEIGHT, aspect=WIDTH / HEIGHT, max_bounces=BOUNCES)
    out = {}

    def bvh(scene, p, **k):
        return trace.render_frame(scene, p, intersector="bvh", **k)

    def wave(scene, p, **k):
        return render_frame_wavefront(scene, p, chunk=WAVE_CHUNK, **k)

    _zero(counters)
    ref = bvh(data, params, **kw)
    fused = trace.render_frame(data, params, **kw)
    _zero(counters)
    for sort_rays in (True, False):
        img = wave(data, params, sort_rays=sort_rays, **kw)
        launched = _mt_launched(_mt_counts(counters))
        _check(not launched and not counters["denoise"].launches,
               f"the wavefront frame launched kernels: {launched}")
        _check(bool(torch.isfinite(img).all()) and float(img.min()) >= 0.0,
               "wavefront frame not finite or negative")
        differ = int((img != ref).any(dim=-1).sum())
        _check(differ == 0,
               f"wavefront (sort_rays={sort_rays}) vs bvh frame: {differ} pixels differ")
        frac, agree = _outlier_rule(img, fused)
        print(f"wavefront {WIDTH}x{HEIGHT} sort_rays={sort_rays}: bit-equal to the bvh frame "
              f"(0 pixels differ); vs the nf frame outlier fraction {frac:.2e}, non-outlier mean "
              f"diff {agree:.2e}; MT kernels launched none")
        out[f"sort_{sort_rays}"] = dict(pixels_differ=differ, fused_outlier_frac=frac,
                                        fused_mean_diff=agree)
    del img, fused

    pkw = dict(width=WAVE_PADDED, height=WAVE_PADDED, aspect=1.0, max_bounces=BOUNCES)
    _check((WAVE_PADDED * WAVE_PADDED) % WAVE_CHUNK != 0, "the padded case is not padded")
    pref = bvh(data, params, **pkw)
    img = wave(data, cpu_params, sort_rays=True, **pkw)
    differ = int((img != pref).any(dim=-1).sum())
    _check(differ == 0, f"padded wavefront frame (CPU camera) vs bvh: {differ} pixels differ")
    f7 = trace.render_frame(data, cpu_params, **kw)
    f7_differ = int((f7 != trace.render_frame(data, params, **kw)).any(dim=-1).sum())
    _check(f7_differ == 0, f"F7: the CPU-camera frame differs from the card camera's on "
           f"{f7_differ} pixels")
    launched = _mt_launched(_mt_counts(counters), ("mt_nf",))
    _check(not launched, f"unexpected MT kernels: {launched}")
    print(f"wavefront {WAVE_PADDED}x{WAVE_PADDED} ({WAVE_PADDED ** 2} rays, "
          f"{(-WAVE_PADDED ** 2) % WAVE_CHUNK} padding lanes), camera built on the CPU: "
          f"bit-equal to the bvh frame; F7: render_frame with that camera over the CUDA scene "
          f"equals the card camera's frame bit for bit")
    out.update(padded_pixels_differ=differ, f7_pixels_differ=f7_differ)
    del img, pref, f7

    skw = dict(width=WIDTH, height=HEIGHT, aspect=WIDTH / HEIGHT, max_bounces=STRESS_BOUNCES)
    _zero(counters)
    s_wave, s_ref = wave(sdata, params, **skw), bvh(sdata, params, **skw)
    differ = int((s_wave != s_ref).any(dim=-1).sum())
    _check(differ == 0, f"stress wavefront frame vs bvh: {differ} pixels differ")
    _check(bool(torch.isfinite(s_wave).all()), "stress wavefront frame not finite")
    launched = _mt_launched(_mt_counts(counters))
    _check(not launched, f"the stress wavefront frame launched MT kernels: {launched}")
    print(f"wavefront stress ({sdata.packed.tri_pos.shape[0]} padded triangles, "
          f"{STRESS_BOUNCES} bounces): bit-equal to the bvh frame; MT kernels launched none")
    out["stress_pixels_differ"] = differ
    del s_wave, s_ref

    paths = WIDTH * HEIGHT
    times = _in_turns({"bvh": lambda: bvh(data, params, **kw),
                       "wave": lambda: wave(data, params, sort_rays=True, **kw),
                       "wave_unsorted": lambda: wave(data, params, sort_rays=False, **kw)},
                      ("bvh", "wave", "wave_unsorted", "wave", "wave_unsorted", "bvh"),
                      warmup=0, reps=2)
    stimes = _in_turns({"bvh": lambda: bvh(sdata, params, **skw),
                        "wave": lambda: wave(sdata, params, sort_rays=True, **skw)},
                       ("bvh", "wave", "wave", "bvh"), warmup=0, reps=1)
    print(f"timing {tag}: headline frame bvh vs wavefront (chunk {WAVE_CHUNK}) in turns (bvh, "
          f"wave, wave, bvh): {_turns(times, 'bvh', 'wave')} ms; wavefront unsorted "
          f"{_fmt_ms(times['wave_unsorted'])} ms; "
          f"{paths / statistics.median(times['wave']) / 1e3:.3f} Mpaths/s sorted")
    print(f"timing {tag}: stress frame bvh vs wavefront in turns: "
          f"{_turns(stimes, 'bvh', 'wave')} ms")
    out.update(headline_ms=times, stress_ms=stimes)
    results["wavefront"] = out


def _checked_phase(pt, trace, data, cam, counters, results, tag) -> int:
    """`utils.debug.checked_render_frame` at the headline shape on the card:
    no error, the image equal to the unchecked frame bit for bit, the nf
    walk launched (counted from 0 around the call); checked and unchecked
    frames timed in turns.  Then the injected faults in a child process
    (`_fault_child`), so that a device-side assert there could not poison
    this process's context.  Returns the checked frame's nf launches."""
    import torch

    from tpu_pathtracer_torch.utils.debug import checked_render_frame

    params = pt.RenderParams.create(cam, frame=3)
    kw = dict(width=WIDTH, height=HEIGHT, aspect=WIDTH / HEIGHT, max_bounces=BOUNCES)
    _zero(counters)
    err, img = checked_render_frame(data, params, **kw)
    launches = _mt_counts(counters)
    _check(err.get() is None, f"the checked headline frame reports {err.get()}")
    _check(launches["mt_nf"] >= 1, f"the checked frame launched no nf walk: {launches}")
    _check(not _mt_launched(launches, ("mt_nf",)), f"other MT kernels launched: {launches}")
    plain = trace.render_frame(data, params, **kw)
    differ = int((img != plain).any(dim=-1).sum())
    _check(differ == 0, f"checked vs unchecked frame: {differ} pixels differ")
    print(f"checked render {WIDTH}x{HEIGHT}: error None, bit-equal to the unchecked frame; nf "
          f"walk launched {launches['mt_nf']} times")
    times = _in_turns({"unchecked": lambda: trace.render_frame(data, params, **kw),
                       "checked": lambda: checked_render_frame(data, params, **kw)},
                      ("unchecked", "checked", "checked", "unchecked"), warmup=1, reps=3)
    print(f"timing {tag}: headline frame unchecked vs checked in turns (unchecked, checked, "
          f"checked, unchecked): {_turns(times, 'unchecked', 'checked')} ms")

    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--fault-child"],
                          cwd=ROOT, capture_output=True, text=True, timeout=FAULT_TIMEOUT)
    print(f"fault child: exit {proc.returncode} after {time.perf_counter() - t0:.1f} s")
    _check(proc.returncode == 0, f"the fault child failed ({proc.returncode}):\n"
           f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    faults = json.loads(proc.stdout.strip().splitlines()[-1])
    want = {"nan_position": "NaNError", "zero_direction": "DivisionByZeroError",
            "material_index": None}
    for case, cls in want.items():
        _check(faults[case] == cls, f"fault {case}: {faults[case]}, want {cls}")
    _check(all(v == "OOBError" for v in faults["index_ops"].values()),
           f"out-of-range index ops: {faults['index_ops']}")
    _check(faults["context_ok"], "the CUDA context did not survive the injected faults")
    print(f"injected faults (child process): {faults}")
    results["checked"] = dict(launches=launches["mt_nf"], ms=times, faults=faults)
    return launches["mt_nf"]


def _fault_child() -> int:
    """The injected faults on the card, each through the checked render at
    the headline shape: a NaN camera position (NaNError), a zero camera
    direction (DivisionByZeroError), and a material index past the table
    written into the compiled scene (no error: both packages clamp it
    before their gather, so it reaches no index op; the frame must equal
    the unchecked one).  Then an index past the end given to each index
    op on CUDA tensors under the mode (OOBError, clamped, so no
    device-side assert), and a synchronize that shows the context is
    whole.  Prints one JSON line of error class names."""
    import dataclasses

    import torch

    import tpu_pathtracer_torch as pt
    from tpu_pathtracer_torch.ops import trace
    from tpu_pathtracer_torch.scene.envmap import gradient_sky
    from tpu_pathtracer_torch.utils import debug

    dev = torch.device("cuda")
    data = pt.default_scene(gradient_sky(64, 128)).compile(device=dev)
    cam = pt.Camera.create(**CAMERA, device=dev)
    kw = dict(width=WIDTH, height=HEIGHT, aspect=WIDTH / HEIGHT, max_bounces=BOUNCES)

    def cls(err):
        exc = err.get_exception()
        return None if exc is None else type(exc).__name__

    out = {}
    bad_pos = dataclasses.replace(cam, position=torch.tensor([math.nan, 1.0, 4.0], device=dev))
    out["nan_position"] = cls(debug.checked_render_frame(
        data, pt.RenderParams.create(bad_pos, frame=1), **kw)[0])
    bad_dir = dataclasses.replace(cam, direction=torch.zeros(3, device=dev))
    out["zero_direction"] = cls(debug.checked_render_frame(
        data, pt.RenderParams.create(bad_dir, frame=1), **kw)[0])
    bits = data.packed.tri_shade.contiguous().view(torch.int32).clone()
    bits[0, 9] = 1 << 20
    bad = dataclasses.replace(data, packed=dataclasses.replace(
        data.packed, tri_shade=bits.view(torch.float32)))
    params = pt.RenderParams.create(cam, frame=1)
    err, img = debug.checked_render_frame(bad, params, **kw)
    out["material_index"] = cls(err)
    _check(torch.equal(img, trace.render_frame(bad, params, **kw)),
           "the material-index frame differs from the unchecked one")

    x = torch.arange(20.0, device=dev).reshape(5, 4)
    far = torch.tensor([0, 1 << 20], device=dev)
    ops = {"index_select": lambda: torch.index_select(x, 0, far),
           "gather": lambda: torch.gather(x, 0, far[:, None].expand(-1, 4)),
           "index": lambda: x[far],
           "index_put_": lambda: x.clone().index_put_((far,), torch.zeros(4, device=dev)),
           "take": lambda: torch.take(x, -far),
           "scatter_add": lambda: torch.zeros(5, device=dev).scatter_add(
               0, far, torch.ones(2, device=dev))}
    out["index_ops"] = {}
    for name, op in ops.items():
        with debug.CheckMode() as mode:
            op()
        out["index_ops"][name] = cls(mode.error())
    torch.cuda.synchronize()
    out["context_ok"] = bool(float((x * 2).sum()) == 380.0)
    print(json.dumps(out))
    return 0


def main(argv=None) -> int:
    args = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    args.add_argument("--profile", action="store_true")
    args.add_argument("--out", default=None)
    args.add_argument("--fault-child", action="store_true", help=argparse.SUPPRESS)
    opts = args.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; nothing run", file=sys.stderr)
        return 2
    if opts.fault_child:
        return _fault_child()

    import numpy as np

    import tpu_pathtracer_torch as pt
    from tpu_pathtracer_torch import _build
    from tpu_pathtracer_torch.ops import intersect, trace
    from tpu_pathtracer_torch.ops.kernels import denoise as kdenoise
    from tpu_pathtracer_torch.ops.kernels import mt_intersect, mt_shade, mt_stream
    from tpu_pathtracer_torch.scene.envmap import gradient_sky

    sys.stdout.reconfigure(line_buffering=True)  # a cut run's log shows how far it got
    t_start = time.perf_counter()

    def phase(name):
        print(f"phase {name} from {time.perf_counter() - t_start:.1f} s; card clocks (SM, max SM, "
              f"power) {_clocks()}")

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
                "mt_pallas_r2": mt_intersect.mt_intersect_pallas,
                "mt_stream_r2": mt_intersect.mt_intersect_stream,
                "mt_nf_mxu": mt_shade.mt_intersect_nf_mxu_phi,
                "mt_list_mxu": mt_shade.mt_intersect_list_mxu_phi,
                "mt_cond_mxu": mt_shade.mt_intersect_cond_mxu_phi,
                "denoise": kdenoise.smart_denoise}

    # --- build --------------------------------------------------------------
    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.load()
    build_s = time.perf_counter() - t0
    print(f"kernel build: {build_s:.1f} s -> build/tpu_pathtracer_torch/{lib_path.name}")
    for line in _ptxas_summary(lib_path.with_suffix(".log").read_text()):
        print("  ptxas:", line)
    results["build_s"] = build_s

    # --- headline: near-to-far MT kernel vs plain on the headline rays ------
    phase("headline")
    scene = pt.default_scene(gradient_sky(64, 128))
    data = scene.compile(device=dev)
    cam = pt.Camera.create(**CAMERA, device=dev)
    tri_pos = data.packed.tri_pos
    rays = _mt_rays(data, cam, mt_shade.mt_intersect_nf_phi)
    phi_primary = rays["primary"][0]
    mt_err = _kernel_vs_plain("mt", tri_pos, rays, mt_shade.mt_intersect_nf_phi,
                              mt_shade.mt_intersect_nf_phi_plain, results)

    # --- cull phase: nf, list and cond at sub 32/64/128 vs plain ---------------
    phase("cull")
    culls = _cull_phase(mt_shade, tri_pos, rays, results, tag)
    cull_bounds = {cull: _cull_bound(mt_shade, tri_pos, phi_primary, cull) for cull in CULLS}
    for cull, (bound_ms, bound_by) in cull_bounds.items():
        print(f"bound: mt_{cull} primary wrapper (sub 64) {bound_ms:.4f} ms ({bound_by})")
        results[f"mt_{cull}_bound_ms"] = bound_ms

    # --- MXU phase: kernel #5, nf/list/cond MXU at sub 32/64/128 vs plain and FP32
    phase("mxu")
    mxu = _mxu_phase(mt_shade, tri_pos, rays, results, tag)

    # --- round-2 phase: mt_intersect_pallas / mt_intersect_stream vs plain ------
    phase("round-2")
    r2 = _r2_phase(mt_intersect, mt_shade, counters, tri_pos, phi_primary,
                   mt_shade.mt_intersect_nf_phi(tri_pos, phi_primary), results, tag)

    # --- denoise phase: the tiled kernel vs plain -----------------------------
    phase("denoise")
    den_err, den = _denoise_phase(kdenoise, results, tag)

    # --- headline main path: Renderer.render_all() + display() ---------------
    phase("headline main path")
    config = pt.RenderConfig(width=WIDTH, height=HEIGHT, frames=FRAMES,
                             samples_per_frame=1, max_bounces=BOUNCES)
    print("headline main path:")
    precull0 = mt_shade._precull_live_subs.launches
    launches, main_s, renderer, mean = _drive(pt, scene, config, counters,
                                              ROOT / "build" / "chip_smoke_headline.png")
    _check(FRAMES <= launches["mt_nf"] <= FRAMES * BOUNCES, f"mt_nf launches {launches}")
    precull_launches = mt_shade._precull_live_subs.launches - precull0
    _check(precull_launches == launches["mt_nf"], f"precull launches {precull_launches}, "
           f"one a walk expected: {launches}")
    _check(not _mt_launched(launches, ("mt_nf",)),
           f"other MT kernels launched on the headline path: {launches}")
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
    display_ms = _time_ms(renderer.display, 2, 10)
    print(f"timing {tag}: headline frame kernel path {ms_k:.3f} ms "
          f"({paths / ms_k / 1e3:.2f} Mpaths/s), plain path {ms_p:.3f} ms "
          f"({paths / ms_p / 1e3:.2f} Mpaths/s)")
    print(f"timing {tag}: mt primary wrapper {mt_ms:.3f} ms (precull {prep_ms:.3f} ms, kernel "
          f"walk and repack {walk_ms:.3f} ms), plain wrapper {mt_plain_ms:.3f} ms (plain walk "
          f"{walk_plain_ms:.3f} ms)")
    print(f"timing {tag}: display() {display_ms:.3f} ms")
    results.update(frame_ms=ms_k, frame_plain_ms=ms_p, mt_ms=mt_ms, mt_plain_ms=mt_plain_ms,
                   mt_walk_ms=walk_ms, mt_walk_plain_ms=walk_plain_ms, mt_prepare_ms=prep_ms,
                   display_ms=display_ms)
    if opts.profile:
        _profile(lambda: trace.render_frame(data, frame_params, **kw), tag, results, "headline")

    # --- intersector phase: 'mt', 'bvh', 'bvh8' frames vs the nf frame ----------
    phase("intersector")
    _intersector_phase(trace, data, frame_params, kw, img_k, counters, results, tag)
    del renderer, img_k, img_p, prep

    # --- cond end to end: the headline frame under TPT_CULL=nf and =cond -----
    phase("cond end to end")
    cond_launches = _cond_e2e_phase(mt_shade, trace, data, frame_params, kw, phi_primary,
                                    counters, results, tag)

    # --- sweep phase: make_budget under TPT_MXU_DETS=0 / =1 (the MXU main path)
    phase("sweep")
    mxu_launches = _sweep_phase(pt, data, cam, counters, results, tag)

    # --- CLI phase: benchmark, render with checkpoint/resume and timing, sky --
    phase("cli")
    _cli_phase(results, tag)

    # --- render options: env importance, blue noise, sort window, native BVH -
    phase("render options")
    _render_options_phase(pt, trace, scene, data, cam, counters, results, tag)

    # --- sharded: the band hooks, 2 gloo ranks on the card, one NCCL rank ------
    phase("sharded")
    sharded_launches = _sharded_phase(pt, trace, data, cam, counters, results, tag)

    # --- glTF, Draco and the viewer: GLBs three ways, cli, ViewerServer ------
    phase("gltf+viewer")
    gltf_launches = _gltf_viewer_phase(pt, trace, counters, results, tag)

    # --- stress: streamed MT kernel vs plain on the stress scene's rays ------
    phase("stress")
    stress = _mesh_scene(pt, STRESS_SEGMENTS)
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

    # --- precull phase: the walks' precull kernel vs plain, timed -----------
    phase("precull")
    precull = _precull_phase(mt_shade, [
        ("default", mt_shade.mt_intersect_nf_phi, tri_pos, rays),
        ("stress", mt_stream.mt_intersect_stream2_phi, s_tri, s_rays)], results, tag)

    # --- walk phase: the Hopper walks of #1, #4b and #3 vs plain ------------
    phase("walk")
    walks = _walk_phase(mt_shade, mt_stream, _walk_cases(tri_pos, rays, s_tri, s_rays),
                        results, tag)

    # the streamed round-2 kernel at its cap (131,072 triangles) vs plain
    s_ro, s_rd = s_primary[1:4].T.contiguous(), s_primary[4:7].T.contiguous()
    r2_stats = _r2_check(mt_intersect, "mt_stream_r2", s_tri, s_ro, s_rd,
                         mt_intersect.mt_intersect_stream(s_tri, s_ro, s_rd), results, "stress")[1]
    r2_stress = _r2_timing(mt_intersect, mt_shade, "mt_stream_r2", s_tri, s_ro, s_rd, r2_stats,
                           results, "stress", tag, plain_reps=1)

    # --- stress main path: Renderer.render_all() + display() -----------------
    phase("stress main path")
    s_config = pt.RenderConfig(width=WIDTH, height=HEIGHT, frames=STRESS_FRAMES,
                               samples_per_frame=1, max_bounces=STRESS_BOUNCES)
    print("stress main path:")
    precull0 = mt_shade._precull_live_subs.launches
    s_launches, s_main_s, s_renderer, s_mean = _drive(pt, stress, s_config, counters,
                                                      ROOT / "build" / "chip_smoke_stress.png")
    s_precull_launches = mt_shade._precull_live_subs.launches - precull0
    _check(s_precull_launches == s_launches["mt_stream"],
           f"precull launches {s_precull_launches}, one a walk expected: {s_launches}")
    _check(STRESS_FRAMES <= s_launches["mt_stream"] <= STRESS_FRAMES * STRESS_BOUNCES,
           f"mt_stream launches {s_launches}")
    _check(not _mt_launched(s_launches, ("mt_stream",)),
           f"other MT kernels launched on the stress path: {s_launches}")
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
    # the same frame through the fat-leaf BVH walk (no MT kernel)
    for fn in counters.values():
        fn.launches = 0
    img_b8 = trace.render_frame(sdata, frame_params, intersector="bvh8", **s_kw)
    torch.cuda.synchronize()
    launched = _mt_launched({n: fn.launches for n, fn in counters.items()})
    _check(not launched, f"the bvh8 stress frame launched MT kernels: {launched}")
    frac, agree = _outlier_rule(img_b8, img_k)
    b8_ms = _time_ms(lambda: trace.render_frame(sdata, frame_params, intersector="bvh8", **s_kw),
                     0, 2)
    print(f"stress frame bvh8 vs mt_stream: outlier fraction {frac:.2e}, non-outlier mean diff "
          f"{agree:.2e}; MT kernels launched none")
    print(f"timing {tag}: stress frame intersector bvh8 {b8_ms:.3f} ms "
          f"({paths / b8_ms / 1e3:.3f} Mpaths/s)")
    results.update(stress_bvh8_outlier_frac=frac, stress_bvh8_mean_diff=agree,
                   stress_bvh8_frame_ms=b8_ms)
    del img_k, img_p, img_b8

    s_ms = _time_ms(lambda: trace.render_frame(sdata, frame_params, **s_kw), 1, 5)
    s_ms_p = _time_ms(lambda: trace.render_frame(sdata, frame_params, plain=True, **s_kw), 0, 2)
    st_ms = _time_ms(lambda: mt_stream.mt_intersect_stream2_phi(s_tri, s_primary), 2, 10)
    st_plain_ms = _time_ms(
        lambda: mt_stream.mt_intersect_stream2_phi_plain(s_tri, s_primary), 1, 2)
    s_prep = mt_stream._prepare(s_tri, s_primary, None)
    st_walk_ms = _time_ms(lambda: mt_stream._walk_cuda(*s_prep), 2, 10)
    st_walk_plain_ms = _time_ms(lambda: mt_stream._walk_plain(*s_prep), 1, 2)
    st_prep_ms = _time_ms(lambda: mt_stream._prepare(s_tri, s_primary, None), 2, 10)
    walked, staged, evaluated = (results["mt_stream_primary"][k] for k in (
        "supers_walked", "chunks_staged", "subs_evaluated"))
    s_tile, s_supers = s_prep[-1], s_prep[5].shape[1]
    st_bound = _bound(
        evaluated * mt_stream.SUB_TRIS * s_tile * PAIR_OPS_NF
        + (s_prep[0].shape[1] * s_supers + (walked * mt_stream.CHUNKS_PER_SUPER
                                            + staged * mt_stream.SUBS_PER_CHUNK) * s_tile)
        * SLAB_OPS, _mt_bytes(s_tri.shape[0], s_primary.shape[1]))
    print(f"timing {tag}: stress frame kernel path {s_ms:.3f} ms "
          f"({paths / s_ms / 1e3:.3f} Mpaths/s), plain path {s_ms_p:.3f} ms "
          f"({paths / s_ms_p / 1e3:.3f} Mpaths/s)")
    print(f"timing {tag}: mt_stream primary wrapper {st_ms:.3f} ms (precull {st_prep_ms:.3f} ms, "
          f"kernel walk and repack {st_walk_ms:.3f} ms), plain wrapper {st_plain_ms:.3f} ms (plain walk "
          f"{st_walk_plain_ms:.3f} ms); bound {st_bound[0]:.4f} ms ({st_bound[1]})")
    results.update(stress_frame_ms=s_ms, stress_frame_plain_ms=s_ms_p, stream_ms=st_ms,
                   stream_plain_ms=st_plain_ms, stream_walk_ms=st_walk_ms,
                   stream_walk_plain_ms=st_walk_plain_ms, stream_prepare_ms=st_prep_ms)
    if opts.profile:
        _profile(lambda: trace.render_frame(sdata, frame_params, **s_kw), tag, results, "stress")

    del s_prep

    # --- wavefront: render_frame_wavefront vs the bvh frame, headline and stress
    phase("wavefront")
    _wavefront_phase(pt, trace, data, sdata, cam, counters, results, tag)

    # --- checked render: checked_render_frame on the card, injected faults ---
    phase("checked render")
    checked_launches = _checked_phase(pt, trace, data, cam, counters, results, tag)

    # --- large-scene main path: Renderer on mesh_scene(640) through bvh8 ------
    phase("large")
    fat_walk = _large_phase(pt, trace, intersect, counters, results, tag, opts.profile)

    # --- training main path: diff.invert, then list/cond/bvh8 gradients --------
    phase("training")
    cull_launches = _training_phase(pt, counters, results, tag, opts.profile)

    # --- the walks' inner loops in SASS: shared loads a pair ------------------
    phase("sass")
    shp = {k: results[f"walk_{k}_shape"]
           for k in ("nf", "list", "cond", "stream", "nf_mxu", "list_mxu", "cond_mxu")}

    def tail(k):
        return f"Li{shp[k]['rpt']}ELi{shp[k]['cluster']}ELi{shp[k]['tpr']}E"

    def mxu_tail(k):  # m-tiles a warp, cluster
        return f"Li{shp[k]['rpt'] // 2}ELi{shp[k]['cluster']}E"

    sass = _sass_loads(lib_path, {
        "nf": f"nf_walk_kernelILi64E{tail('nf')}Lb1E",
        "list": f"nf_walk_kernelILi64E{tail('list')}Lb0E",
        "cond": f"cond_walk_kernelILi64E{tail('cond')}E",
        "stream": f"stream_walk_kernelI{tail('stream')}E",
        "nf_mxu": f"mxu_walk_kernelILi64E{mxu_tail('nf_mxu')}Lb1E",
        "list_mxu": f"mxu_walk_kernelILi64E{mxu_tail('list_mxu')}Lb0E",
        "cond_mxu": f"mxu_cond_kernelILi64E{mxu_tail('cond_mxu')}E",
        "r2": "r2_walk_kernelEPKf"},
        Path(opts.out) if opts.out else None)
    for label, got in sass.items():
        print(f"sass {label} ({'stream' if label == 'r2' else 'at sub 64'}): pair loop "
              f"{got}")
    results["sass_inner_loop"] = sass

    def bound(b):
        return {"bound_ms": b[0], "bound_by": b[1], "library_ms": None}

    def walk(key):  # the walk's kernel
        w = walks[key]
        return {"kernel_ms": w["kept_ms"], "repack_ms": w["repack_ms"],
                "walk_bound_ms": w["walk_bound_ms"],
                "critical_path_bound_ms": w["critical_path_bound_ms"]}

    den512, den1080 = den[(512, 512)], den[(1080, 1920)]

    r2_src = "tpu_pathtracer_torch/csrc/r2_walk.cu"
    kernels = [
        {"name": "mt_nf", "route": "cuda", "source": "tpu_pathtracer_torch/csrc/nf_walk.cu",
         "replaces": "tpu_pathtracer/ops/pallas/mt_shade.py:308", "launches": launches["mt_nf"],
         "max_abs_err": max(mt_err, culls["nf"][0]), "ms": mt_ms, "plain_ms": mt_plain_ms,
         **bound(cull_bounds["nf"]), **walk("nf_headline_primary"),
         "sharded_launches": sharded_launches[0], "gltf_launches": gltf_launches["mt_nf"],
         "checked_launches": checked_launches},
        {"name": "denoise", "route": "cuda", "source": "tpu_pathtracer_torch/csrc/denoise.cu",
         "replaces": "tpu_pathtracer/ops/pallas/denoise.py:33",
         "launches": launches["denoise"], "max_abs_err": den_err, "ms": den512["ms"],
         "plain_ms": den512["plain_ms"], **bound((den512["bound_ms"], den512["bound_by"])),
         "kernel_ms": den512["kernel_ms"], "ms_1080p": den1080["ms"],
         "kernel_ms_1080p": den1080["kernel_ms"], "bound_ms_1080p": den1080["bound_ms"],
         "sharded_launches": sharded_launches[1], "gltf_launches": gltf_launches["denoise"]},
        {"name": "mt_stream", "route": "cuda",
         "source": "tpu_pathtracer_torch/csrc/stream_walk.cu",
         "replaces": "tpu_pathtracer/ops/pallas/mt_shade.py:628",
         "launches": s_launches["mt_stream"], "max_abs_err": stream_err, "ms": st_ms,
         "plain_ms": st_plain_ms, **bound(st_bound), **walk("stream_stress_primary"),
         "gltf_launches": gltf_launches["mt_stream"]},
        {"name": "mt_list", "route": "cuda", "source": "tpu_pathtracer_torch/csrc/nf_walk.cu",
         "replaces": "tpu_pathtracer/ops/pallas/mt_shade.py:255",
         "launches": cull_launches["list"], "max_abs_err": culls["list"][0],
         "ms": culls["list"][1], "plain_ms": culls["list"][2], **bound(cull_bounds["list"]),
         **walk("list_headline_primary")},
        {"name": "mt_cond", "route": "cuda", "source": "tpu_pathtracer_torch/csrc/cond_walk.cu",
         "replaces": "tpu_pathtracer/ops/pallas/mt_shade.py:183", "launches": cond_launches,
         "max_abs_err": culls["cond"][0], "ms": culls["cond"][1], "plain_ms": culls["cond"][2],
         **bound(cull_bounds["cond"]), **walk("cond_headline_primary")},
        *({"name": name, "route": "cuda", "source": r2_src,
           "replaces": f"tpu_pathtracer/ops/pallas/mt_intersect.py:{line}",
           "launches": r2[name]["launches"], "max_abs_err": r2[name]["max_abs_err"],
           "ms": r2[name]["ms"], "kernel_ms": r2[name]["kernel_ms"],
           "plain_ms": r2[name]["plain_ms"],
           **bound((r2[name]["bound_ms"], r2[name]["bound_by"])),
           "critical_path_bound_ms": r2[name]["critical_path_bound_ms"],
           **({f"stress_{k}": v for k, v in r2_stress.items()} if name == "mt_stream_r2" else {})}
          for name, line in (("mt_pallas_r2", 62), ("mt_stream_r2", 293))),
        {"name": "precull", "route": "cuda", "source": "tpu_pathtracer_torch/csrc/precull.cu",
         "replaces": None, "xla_glue": "tpu_pathtracer/ops/pallas/mt_shade.py:364",
         "launches": precull_launches, "stress_launches": s_precull_launches, "max_abs_err": 0.0,
         "kernel_ms": precull["default_primary"]["kernel_ms"],
         "ms": precull["default_primary"]["call_ms"],
         "plain_ms": precull["default_primary"]["plain_ms"],
         **bound((precull["default_primary"]["bound_ms"], precull["default_primary"]["bound_by"])),
         **{f"stress_{k}": precull["stress_primary"][k]
            for k in ("kernel_ms", "call_ms", "plain_ms", "bound_ms")}},
        {"name": "fat_walk", "route": "cuda", "source": "tpu_pathtracer_torch/csrc/fat_walk.cu",
         "replaces": None, "xla_glue": "tpu_pathtracer/ops/intersect.py:372",
         "launches": results["large_fat_walk_launches"], "max_abs_err": 0.0,
         "kernel_ms": fat_walk["primary"]["kernel_ms"],
         "plain_ms": fat_walk["primary"]["plain_ms"],
         **bound((fat_walk["primary"]["bound_ms"], fat_walk["primary"]["bound_by"])),
         **{f"bounce1_{k}": fat_walk["bounce1"][k] for k in ("kernel_ms", "plain_ms", "bound_ms")}},
        *({"name": f"mt_{cull}_mxu", "route": "cuda",
           "source": "tpu_pathtracer_torch/csrc/mxu_walk.cu",
           "replaces": "tpu_pathtracer/ops/pallas/mt_shade.py:118",
           "launches": mxu_launches[f"mt_{cull}_mxu"], "max_abs_err": mxu[cull]["max_abs_err"],
           "ms": mxu[cull]["ms"], "plain_ms": mxu[cull]["plain_ms"],
           **bound((mxu[cull]["bound_ms"], mxu[cull]["bound_by"])),
           **walk(f"{cull}_mxu_headline_primary")}
          for cull in CULLS),
    ]
    results["kernels"] = kernels
    if opts.out:
        out_dir = Path(opts.out)
        out_dir.mkdir(parents=True, exist_ok=True)
        (out_dir / "chip_smoke.json").write_text(json.dumps(results, indent=1))
    phase("end")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
