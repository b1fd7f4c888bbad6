"""The frame path's spans and counters (`tpu_pathtracer_torch.utils.spans`).

  * with no profiler running, a frame records no span and no counter;
  * under a CPU torch profiler, a default-scene frame records the span
    tree of the frame path, every child inside its parent, one frame id;
  * the image and the loops' seeds are bit-equal with the recorder on and
    off, through the fused and the plain loop;
  * the walks' counters equal `chip_smoke._walk_work`'s rule applied to the
    walk counts the side-channel functions read on the same inputs;
  * `syncs` counts the bounce loops' host reads;
  * on CPU tensors the precull is the plain version and counts no
    `walk.precull.rays`;
  * `cli render --profile DIR` writes DIR/spans.jsonl.

The same spans on the card (the kernel launches, the copies to the card,
the CUDA events of `postprocess`) are read by the benchmark's traced runs."""

import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import chip_smoke
import tpu_pathtracer_torch as tpt
from tpu_pathtracer_torch import _build
from tpu_pathtracer_torch.cli import main
from tpu_pathtracer_torch.ops import trace as ttrace
from tpu_pathtracer_torch.ops.kernels import mt_shade, mt_stream
from tpu_pathtracer_torch.ops.mt_matmul import ray_features
from tpu_pathtracer_torch.scene.envmap import gradient_sky
from tpu_pathtracer_torch.utils import spans

CAM = dict(position=(0, 1, 4), look_at=(0, 0.5, 0), fov=45)
SIZE, BOUNCES, SORTED = 32, 4, 2


def _profiled(fn, *args, **kw):
    """`fn` under a CPU profiler, recorded afresh: a span tried with no
    profiler running makes the next session's records start over."""
    with spans.span("between sessions"):
        pass
    with profile(activities=[ProfilerActivity.CPU]):
        return fn(*args, **kw)


def _snapshot():
    return spans.recorded(), spans.counters()


@pytest.fixture(scope="module")
def scene():
    return tpt.default_scene(gradient_sky(8, 16)).compile(device="cpu")


@pytest.fixture(scope="module")
def params():
    return tpt.RenderParams.create(tpt.Camera.create(**CAM), frame=2)


@pytest.fixture(scope="module")
def frame(scene, params):
    """A 32^2 default-scene frame under the profiler: (image, spans, counts)."""
    image = _profiled(ttrace.render_frame, scene, params, width=SIZE, height=SIZE, aspect=1.0,
                      max_bounces=BOUNCES)
    return (image, *_snapshot())


def test_no_profiler_records_nothing(scene, params, frame):
    image, before, counts = frame
    assert before and counts and spans.recorded() == before
    again = ttrace.render_frame(scene, params, width=SIZE, height=SIZE, aspect=1.0,
                                max_bounces=BOUNCES)
    assert torch.equal(again, image)
    assert _snapshot() == (before, counts)


def _children(recorded, parent):
    return [s.name for s in recorded if s.parent == parent]


def test_profiled_frame_has_the_span_tree(frame):
    _, recorded, _ = frame
    assert recorded[0].name == "frame" and recorded[0].parent == -1
    assert [s.name for s in recorded if s.parent == -1] == ["frame"]
    top = _children(recorded, 0)
    assert top == ["raygen", "raygen"] + ["bounce"] * BOUNCES + ["env"]
    bounces = [i for i, s in enumerate(recorded) if s.name == "bounce"]
    for b, i in enumerate(bounces):
        want = ["sync", "walk", "shade"] + ["sort"] * (b < SORTED)
        assert _children(recorded, i) == want
        walk = next(j for j, s in enumerate(recorded) if s.parent == i and s.name == "walk")
        assert _children(recorded, walk) == ["walk.prep", "walk.launch"]
        prep = next(j for j, s in enumerate(recorded) if s.parent == walk)
        assert _children(recorded, prep) == ["walk.precull"]
    for s in recorded:
        assert s.frame == 0 and s.start_us <= s.end_us and s.device_ms is None
        if s.parent >= 0:
            up = recorded[s.parent]
            assert up.start_us <= s.start_us and s.end_us <= up.end_us


def test_syncs_count_the_bounce_loop_reads(scene, params, frame):
    _, recorded, counts = frame
    reads = sum(1 for s in recorded if s.name == "sync")
    assert spans.totals(counts)["syncs"] == reads == BOUNCES
    assert all(recorded[s.parent].name == "bounce" for s in recorded if s.name == "sync")
    _profiled(ttrace.render_frame, scene, params, width=8, height=8, aspect=1.0, max_bounces=3,
              differentiable=True)
    recorded = spans.recorded()
    assert [s.name for s in recorded].count("bounce") == 3
    assert spans.totals()["syncs"] == [s.name for s in recorded].count("sync") == 3


def _rays(scene, params, n=256):
    xs, ys, uv, seed = ttrace.band_pixels(16, 16, params.frame, blocked=True)
    o, d = ttrace.camera_ops.camera_rays(params.camera, uv, 1.0)
    return o[:n], d[:n], seed[:n]


@pytest.mark.parametrize("loop", ["fused", "plain"])
def test_recorder_changes_no_result(scene, params, loop):
    o, d, seed = _rays(scene, params)
    tri = scene.packed.tri_pos
    if loop == "fused":
        run = lambda: ttrace.trace_rays_fused(
            scene, params, o, d, seed, max_bounces=BOUNCES,
            intersector_phi_fn=lambda phi: mt_shade.mt_intersect_pallas2_phi(tri, phi))
    else:
        run = lambda: ttrace.trace_rays(scene, params, o, d, seed, max_bounces=BOUNCES,
                                        intersector="mt_pallas")
    off = run()
    on = _profiled(run)
    assert spans.totals()["walk.pairs"] > 0
    for a, b in zip(off, on):
        assert torch.equal(a, b)


def _soup(n_tris, n_rays, seed):
    """Triangles around the origin and rays from a shell towards it, every
    fifth ray parked (rd = 0)."""
    rng = np.random.default_rng(seed)
    centre = rng.uniform(-1, 1, (n_tris, 1, 3))
    tri = (centre + rng.normal(0, 0.05, (n_tris, 3, 3))).reshape(n_tris, 9).astype(np.float32)
    ro = rng.normal(0, 1, (n_rays, 3))
    ro = 3.0 * ro / np.linalg.norm(ro, axis=1, keepdims=True)
    rd = rng.uniform(-0.5, 0.5, (n_rays, 3)) - ro
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    ro[::5], rd[::5] = 1e30, 0.0
    ro, rd = torch.from_numpy(ro.astype(np.float32)), torch.from_numpy(rd.astype(np.float32))
    return torch.from_numpy(tri), ray_features(ro, rd).T.contiguous()


@pytest.mark.parametrize("kind", ["nf", "cond", "stream"])
def test_walk_counters_follow_the_walk_counts(kind):
    tri, phi = _soup(2300, 700, 5)
    tile = 256
    if kind == "stream":
        wrapper, sub, n_chunks = mt_stream.mt_intersect_stream2_phi, mt_stream.SUB_TRIS, 0
        stats = mt_stream.walk_stats(tri, phi, tile_rays=tile)
    else:
        wrapper = getattr(mt_shade, f"mt_intersect_{kind}_phi")
        sub, n_chunks = mt_shade.SUB_TRIS, -(-tri.shape[0] // 128)
        stats = getattr(mt_shade, f"{kind}_walk_stats")(tri, phi, tile_rays=tile)
    alive = None
    if kind == "cond":
        pad = -(-phi.shape[1] // tile) * tile - phi.shape[1]
        rd = torch.nn.functional.pad(phi[4:7], (0, pad), value=1e30)
        alive = rd.abs().reshape(3, -1, tile).sum(dim=(0, 2)) > 0
    pairs, slabs = chip_smoke._walk_work(kind, stats, tile, sub, n_chunks=n_chunks, alive=alive)
    hit = _profiled(wrapper, tri, phi, tile_rays=tile)
    assert torch.equal(hit.tri, wrapper(tri, phi, tile_rays=tile).tri)
    got = spans.totals()
    assert got["walk.pairs"] == int(pairs.sum()) > 0
    assert got["walk.slabs"] == int(slabs.sum())
    assert got["walk.lanes"] == phi.shape[1]
    assert (got["walk.slabs"] > 0) == (kind != "nf")


@pytest.mark.parametrize("kind", ["nf", "stream"])
def test_cpu_precull_runs_the_plain_version(kind, monkeypatch):
    """On CPU tensors the walks' precull is `_precull_live_subs_plain`: no
    kernel library is loaded, no launch is counted, and under the profiler
    `walk.precull.rays` counts nothing while `walk.lanes` counts the rays."""
    calls = []
    plain = mt_shade._precull_live_subs_plain
    monkeypatch.setattr(mt_shade, "_precull_live_subs_plain",
                        lambda *a: calls.append(a[0].shape[0]) or plain(*a))

    def refuse():
        raise AssertionError("the kernel library was loaded")

    monkeypatch.setattr(_build, "load", refuse)
    before = mt_shade._precull_live_subs.launches
    tri, phi = _soup(2300, 700, 6)
    wrapper = mt_stream.mt_intersect_stream2_phi if kind == "stream" else mt_shade.mt_intersect_nf_phi
    hit = _profiled(wrapper, tri, phi, tile_rays=256)
    got = spans.totals()
    assert calls == [2 if kind == "stream" else 36] and int(hit.hit.sum()) > 0
    assert mt_shade._precull_live_subs.launches == before
    assert "walk.precull.rays" not in got and got["walk.lanes"] == phi.shape[1]


def test_cli_profile_writes_the_spans(tmp_path):
    out = tmp_path / "prof"
    assert main(["render", "--device", "cpu", "--width", "16", "--height", "16", "--frames", "2",
                 "-o", str(tmp_path / "r.png"), "--profile", str(out)]) == 0
    lines = [json.loads(x) for x in (out / "spans.jsonl").read_text().splitlines()]
    frames = [x for x in lines if x.get("name") == "frame"]
    assert [x["frame"] for x in frames] == [0, 1]
    assert {"accumulate", "postprocess", "bounce", "walk.launch"} <= {x.get("name") for x in lines}
    counters = {x["counter"]: x["value"] for x in lines if "counter" in x}
    assert counters["syncs"] > 0 and counters["walk.pairs"] > 0
    assert all(x["start_us"] <= x["end_us"] for x in lines if "name" in x)
