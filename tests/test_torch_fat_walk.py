"""The fat-leaf walk's spans and counters (`ops/intersect.py`, the 'bvh8'
intersector, through `utils/spans.py`):

  * `walk.fat.nodes` and `walk.fat.steps` equal a plain count: each ray
    walked on its own in a Python loop over the same `fat_nodes`, and the
    walk's check rule (`_CHECK_EVERY` steps a host read, compaction once a
    quarter of the held lanes have finished) applied to those counts;
  * `walk.fat.nodes` <= `walk.fat.lane_steps`, and `syncs` grows by one for
    each of the walk's host reads, each a `sync` span inside `walk.fat`;
  * frames through `Renderer` forced to 'bvh8' are bit-equal with the
    recorder on and off, and nothing is recorded while it is off;
  * on a card (marker `cuda`), the walk run as CUDA graphs gives the eager
    walk's hits bit for bit, and its counts:

    python -m pytest --noconftest -m cuda tests/test_torch_fat_walk.py"""

import math

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import tpu_pathtracer_torch as tpt
from tpu_pathtracer_torch.ops import intersect as tint
from tpu_pathtracer_torch.ops import trace
from tpu_pathtracer_torch.scene import primitives
from tpu_pathtracer_torch.scene.envmap import gradient_sky
from tpu_pathtracer_torch.scene.host import rotation_x
from tpu_pathtracer_torch.utils import spans

CAM = dict(position=(0.0, 1.0, 4.0), look_at=(0.0, 0.5, 0.0), fov=45.0)


def mesh_scene(segments):
    """bench.py's `mesh_scene`: a beige sphere on a white 4x4 plane."""
    s = tpt.Scene()
    s.add(tpt.Mesh(*primitives.sphere(0.5, segments, segments // 2),
                   tpt.Material(color=(0.8, 0.7, 0.6))))
    s.add(tpt.Mesh(*primitives.plane(4, 4), tpt.Material(), transform=rotation_x(-math.pi / 2)))
    s.set_environment(gradient_sky(8, 16))
    return s


def _profiled(fn, *args, **kw):
    """`fn` under a CPU profiler, recorded afresh."""
    with spans.span("between sessions"):
        pass
    with profile(activities=[ProfilerActivity.CPU]):
        return fn(*args, **kw)


@pytest.fixture(scope="module")
def scene():
    return mesh_scene(24).compile(device="cpu")


def _rays(n, seed):
    """Rays from the camera's side towards the sphere, some past it."""
    rng = np.random.default_rng(seed)
    ro = np.asarray(CAM["position"]) + rng.normal(0, 0.3, (n, 3))
    target = np.asarray(CAM["look_at"]) + rng.normal(0, 0.6, (n, 3))
    rd = target - ro
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    return torch.tensor(ro, dtype=torch.float32), torch.tensor(rd, dtype=torch.float32)


def _plain_visits(fat, ro, rd, max_leaf=8):
    """Node rows each ray visits, walked one ray at a time: a node whose box
    the ray misses, or enters no nearer than its best hit, sends it down
    the miss link; a hit inner node to the next row; a leaf tests its
    triangles and follows the miss link."""
    k = fat.shape[0]
    links = fat[:, 6:9].contiguous().view(torch.int32)
    visits = []
    for o, d in zip(ro[:, None], rd[:, None]):
        ptr, best, n = 0, math.inf, 0
        while ptr < k:
            n += 1
            row = fat[ptr]
            miss, _, count = (int(x) for x in links[ptr])
            hit, tmin = tint.ray_aabb_t(o, d, row[None, 0:3], row[None, 3:6])
            entered = bool(hit[0]) and float(tmin[0]) < best
            if entered and count > 0:
                tp = row[9:9 + 9 * max_leaf].reshape(max_leaf, 9)[:count]
                ok, t, _, _ = tint.ray_triangle(o, d, tp[:, 0:3], tp[:, 3:6], tp[:, 6:9])
                if bool(ok.any()):
                    best = min(best, float(t[ok].min()))
            ptr = ptr + 1 if entered and count == 0 else miss
        visits.append(n)
    return visits


def _check_rule(visits):
    """(steps, lanes stepped, host reads) of one walk whose rays take
    `visits` steps each, under `_walk`'s rule."""
    every = tint._CHECK_EVERY
    held, steps, lane_steps, reads = len(visits), 0, 0, 0
    while True:
        steps += every
        lane_steps += every * held
        reads += 1
        live = sum(v > steps for v in visits)
        if live == 0:
            return steps, lane_steps, reads
        if 4 * live <= 3 * held:
            held = live


def test_counters_equal_a_plain_count(scene):
    fat = scene.packed.fat_nodes
    ro, rd = _rays(40, 3)
    hit = _profiled(tint.bvh_fat_intersect, fat, ro, rd, ray_batch=0)
    totals = spans.totals()
    visits = _plain_visits(fat, ro, rd)
    steps, lane_steps, reads = _check_rule(visits)
    assert hit.hit.any() and not hit.hit.all()
    assert totals["walk.fat.rays"] == len(visits)
    assert totals["walk.fat.nodes"] == sum(visits)
    assert totals["walk.fat.steps"] == steps
    assert totals["walk.fat.lane_steps"] == lane_steps
    assert totals["syncs"] == reads
    assert sum(visits) <= lane_steps


def test_batches_add_up_and_reads_are_syncs(scene):
    fat = scene.packed.fat_nodes
    ro, rd = _rays(96, 4)
    _profiled(tint.bvh_fat_intersect, fat, ro, rd, ray_batch=32)
    recorded, totals = spans.recorded(), spans.totals()
    visits = _plain_visits(fat, ro, rd)
    rules = [_check_rule(visits[i:i + 32]) for i in range(0, 96, 32)]
    walks = [i for i, s in enumerate(recorded) if s.name == "walk.fat"]
    syncs = [s for s in recorded if s.name == "sync"]
    assert len(walks) == 3 and totals["walk.fat.rays"] == 96
    assert totals["walk.fat.nodes"] == sum(visits) <= totals["walk.fat.lane_steps"]
    assert totals["walk.fat.steps"] == sum(r[0] for r in rules)
    assert totals["walk.fat.lane_steps"] == sum(r[1] for r in rules)
    assert totals["syncs"] == len(syncs) == sum(r[2] for r in rules)
    assert all(s.parent in walks for s in syncs)
    compact = [s for s in recorded if s.name == "walk.fat.compact"]
    assert len(compact) >= 3 and all(s.parent in walks for s in compact)


def _renderer(scene_host):
    r = tpt.Renderer(scene_host, tpt.Camera.create(**CAM),
                     tpt.RenderConfig(width=16, height=16, frames=8, max_bounces=3,
                                      intersector="bvh8"),
                     tpt.PostConfig(denoise=False), device="cpu")
    r.reset()
    return r


def test_frames_bit_equal_with_the_recorder_on_and_off():
    host = mesh_scene(16)
    on = _renderer(host)
    for _ in range(2):
        _profiled(on.render)
    snapshot = (spans.recorded(), spans.counters())
    totals = spans.totals(snapshot[1])
    assert totals["walk.fat.rays"] >= 16 * 16 and totals["walk.fat.nodes"] > 0
    assert [s.name for s in snapshot[0]].count("walk.fat") >= 1
    off = _renderer(host)
    off.render()
    off.render()
    assert torch.equal(off.accumulation, on.accumulation)
    assert torch.equal(off.display(), on.display())
    assert (spans.recorded(), spans.counters()) == snapshot


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _both_walks(fat, ro, rd):
    """(graphed, eager) hits and counter totals of one profiled walk each."""
    out = []
    for graphed in (True, False):
        hit = _profiled(tint.bvh_fat_intersect, fat, ro, rd, ray_batch=0, graphed=graphed)
        torch.cuda.synchronize()
        out.append((hit, spans.totals()))
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("n", [0, 1, 700, 1024, 5000, 40000])
def test_graphed_walk_gives_the_eager_walk(cuda, n):
    fat = mesh_scene(96).compile(device=cuda).packed.fat_nodes
    ro, rd = _rays(n, 10 + n)
    (hit_g, tot_g), (hit_e, tot_e) = _both_walks(fat, ro.to(cuda), rd.to(cuda))
    for a, b in zip(hit_g, hit_e):
        assert torch.equal(a, b)
    assert n < 700 or hit_e.hit.any()
    for name in ("walk.fat.rays", "walk.fat.nodes", "walk.fat.steps", "syncs"):
        assert tot_g.get(name) == tot_e.get(name), name
    assert tot_e.get("walk.fat.lane_steps", 0) <= tot_g.get("walk.fat.lane_steps", 0)


@pytest.mark.cuda
def test_graphs_serve_each_table_and_frames_match_the_eager_walk(cuda, monkeypatch):
    tables = [mesh_scene(s).compile(device=cuda).packed.fat_nodes for s in (24, 48, 24)]
    ro, rd = _rays(3000, 5)
    ro, rd = ro.to(cuda), rd.to(cuda)
    for fat in tables * 2:  # more tables than are kept: each is captured anew
        for a, b in zip(tint.bvh_fat_intersect(fat, ro, rd, ray_batch=0),
                        tint.bvh_fat_intersect(fat, ro, rd, ray_batch=0, graphed=False)):
            assert torch.equal(a, b)
    assert len(tint._FAT_GRAPHS) == tint._GRAPH_TABLES

    def frames(graphed):
        monkeypatch.setattr(trace, "bvh_fat_intersect",
                            lambda *a, **kw: tint.bvh_fat_intersect(*a, **kw, graphed=graphed))
        r = tpt.Renderer(mesh_scene(48), tpt.Camera.create(**CAM),
                         tpt.RenderConfig(width=64, height=48, frames=4, max_bounces=4,
                                          intersector="bvh8"),
                         tpt.PostConfig(denoise=False), device=cuda)
        r.reset()
        for _ in range(3):
            r.render()
        return r.accumulation.clone()

    assert torch.equal(frames(True), frames(False))
