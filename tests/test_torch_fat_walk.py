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
  * the fat walk kernel's wrapper: a CPU tensor walks in torch ops and
    launches nothing, and the argument checks refuse a wrong dtype, width
    or layout before any launch; the kernel's 32-ray group rule, by hand;
  * on a card (marker `cuda`), the kernel (csrc/fat_walk.cu) gives the
    torch walk's hits bit for bit over three tables, with dead lanes, its
    counters the plain count's, and `Renderer` frames equal to the torch
    walk's:

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


def _group_rule(visits, group: int = 32):
    """(nodes, steps, lane_steps) the fat walk kernel counts for rays that
    visit `visits` rows each: the rows, the longest walk, and over each
    group of `group` consecutive rays (a warp), the rays in the group times
    its longest walk."""
    lane_steps = sum(len(visits[i:i + group]) * max(visits[i:i + group])
                     for i in range(0, len(visits), group))
    return sum(visits), max(visits, default=0), lane_steps


def test_group_rule_by_hand():
    visits = [3] * 31 + [9] + [1] * 32 + [2, 7, 4]  # 67 rays: two full groups, one of 3
    assert _group_rule(visits) == (93 + 9 + 32 + 13, 9, 32 * 9 + 32 * 1 + 3 * 7)
    assert _group_rule([]) == (0, 0, 0)
    assert _group_rule([5, 1], group=1) == (6, 5, 6)


def test_cpu_tensors_walk_in_torch_ops(scene, monkeypatch):
    fat = scene.packed.fat_nodes
    ro, rd = _rays(64, 7)
    launched = tint.bvh_fat_intersect.launches
    monkeypatch.setattr(tint, "_fat_walk_cuda", lambda *a: pytest.fail("the kernel was called"))
    hit = tint.bvh_fat_intersect(fat, ro, rd, ray_batch=0)
    plain = tint._bvh_fat_intersect_plain(fat, ro, rd)
    assert tint.bvh_fat_intersect.launches == launched
    assert hit.hit.any()
    for a, b in zip(hit, plain):
        assert torch.equal(a, b)


def _bad_inputs(fat, ro, rd, what):
    if what == "dtype":
        return fat.double(), ro, rd, 8
    if what == "width":
        return fat[:, :9 + 9 * 4].contiguous(), ro, rd, 8
    if what == "layout":
        return fat.T.contiguous().T, ro, rd, 8
    if what == "rays":
        return fat, ro[:, :2].contiguous(), rd[:, :2].contiguous(), 8
    return fat, ro, rd, 8  # "device": right in all but the device


@pytest.mark.parametrize("what", ["dtype", "width", "layout", "rays", "device"])
def test_fat_walk_kernel_refuses_what_it_cannot_take(scene, what, monkeypatch):
    from tpu_pathtracer_torch import _build

    monkeypatch.setattr(_build, "load", lambda: pytest.fail("the kernel library was loaded"))
    ro, rd = _rays(8, 1)
    fat, ro, rd, max_leaf = _bad_inputs(scene.packed.fat_nodes, ro, rd, what)
    launched = tint.bvh_fat_intersect.launches
    with pytest.raises(ValueError, match="fat walk kernel"):
        tint._fat_walk_cuda(fat, ro, rd, max_leaf)
    assert tint.bvh_fat_intersect.launches == launched


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _soup_table(max_leaf=4, end=1024):
    """A 300-triangle soup's fat-leaf table with `max_leaf` slots and its
    miss links past the last row re-targeted to `end` (test_torch_scene's
    recipe), and the packed triangle rows."""
    from tpu_pathtracer_torch.accel.bvh import build_bvh_flat, flat_to_links, links_to_fat

    rng = np.random.default_rng(0)
    p0 = rng.uniform(-1, 1, (300, 3)).astype(np.float32)
    p1 = p0 + rng.uniform(-0.1, 0.1, (300, 3)).astype(np.float32)
    p2 = p0 + rng.uniform(-0.1, 0.1, (300, 3)).astype(np.float32)
    links = flat_to_links(build_bvh_flat(p0, p1, p2))
    order = links["tri"][links["tri"] >= 0]
    packed_id = np.where(links["tri"] >= 0, np.argsort(order)[np.clip(links["tri"], 0, None)],
                         -1).astype(np.int32)
    tri_pos = np.concatenate([p0, p1, p2], axis=1)[order]
    return torch.from_numpy(links_to_fat(links, tri_pos, packed_id, max_leaf, end))


TABLES = {"mesh16": (8, lambda: mesh_scene(16).compile(device="cpu").packed.fat_nodes),
          "soup_leaf4_end": (4, _soup_table),
          "large524K": (8, lambda: mesh_scene(640).compile(device="cpu").packed.fat_nodes)}


@pytest.fixture(scope="module")
def tables():
    return {}


def _table(tables, name, device):
    if name not in tables:
        max_leaf, make = TABLES[name]
        tables[name] = (max_leaf, make().to(device))
    return tables[name]


def _walk_rays(n, seed, device):
    """`_rays` with a seventh of the lanes dead (ro = 1e30, rd = 0, as the
    plain loop hands finished rays in) and a seventh along an axis."""
    ro, rd = _rays(n, seed)
    lane = torch.arange(n)
    axis = torch.zeros((n, 3))
    axis[torch.arange(n), lane % 3] = torch.where(lane % 2 == 0, -1.0, 1.0)
    rd = torch.where((lane % 7 == 3)[:, None], axis, rd)
    dead = (lane % 7 == 5)[:, None]
    ro, rd = torch.where(dead, 1e30, ro), torch.where(dead, 0.0, rd)
    return ro.to(device), rd.to(device)


def _kernel_and_plain(fat, ro, rd, max_leaf):
    """(kernel, plain) hits and counter totals, one profiled walk each."""
    out = []
    for fn in (tint.bvh_fat_intersect, tint._bvh_fat_intersect_plain):
        kw = dict(ray_batch=0) if fn is tint.bvh_fat_intersect else {}
        hit = _profiled(fn, fat, ro, rd, max_leaf=max_leaf, **kw)
        torch.cuda.synchronize()
        out.append((hit, spans.totals()))
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("n", [0, 1, 700, 1024, 5000, 40000, 262144])
@pytest.mark.parametrize("table", sorted(TABLES))
def test_fat_walk_kernel_gives_the_torch_walk(cuda, tables, table, n):
    max_leaf, fat = _table(tables, table, cuda)
    ro, rd = _walk_rays(n, 10 + n, cuda)
    launched = tint.bvh_fat_intersect.launches
    (hit_k, tot_k), (hit_p, tot_p) = _kernel_and_plain(fat, ro, rd, max_leaf)
    assert tint.bvh_fat_intersect.launches == launched + 1
    for a, b in zip(hit_k, hit_p):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert n < 700 or (hit_p.hit.any() and not hit_p.hit.all())
    assert tot_k.get("walk.fat.rays") == n
    assert tot_k.get("walk.fat.nodes", 0) == tot_p.get("walk.fat.nodes", 0)
    assert tot_k.get("syncs", 0) == 0
    assert tot_k.get("walk.fat.steps", 0) <= tot_p.get("walk.fat.steps", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("table", ["mesh16", "soup_leaf4_end"])
def test_fat_walk_kernel_counts_by_the_group_rule(cuda, tables, table):
    max_leaf, fat = _table(tables, table, cuda)
    ro, rd = _walk_rays(720, 31, cuda)
    _profiled(tint.bvh_fat_intersect, fat, ro, rd, max_leaf=max_leaf, ray_batch=240)
    totals = spans.totals()
    visits = _plain_visits(fat, ro, rd, max_leaf)
    rules = [_group_rule(visits[i:i + 240]) for i in range(0, 720, 240)]  # one launch a slice
    assert totals["walk.fat.nodes"] == sum(visits) == sum(r[0] for r in rules)
    assert totals["walk.fat.steps"] == sum(r[1] for r in rules)
    assert totals["walk.fat.lane_steps"] == sum(r[2] for r in rules)
    assert max(visits) > min(visits) == 1


@pytest.mark.cuda
def test_renderer_frames_equal_the_torch_walk(cuda, monkeypatch):
    def frames(fn):
        monkeypatch.setattr(trace, "bvh_fat_intersect", fn)
        r = tpt.Renderer(mesh_scene(48), tpt.Camera.create(**CAM),
                         tpt.RenderConfig(width=64, height=48, frames=4, max_bounces=4,
                                          intersector="bvh8"),
                         tpt.PostConfig(denoise=False), device=cuda)
        r.reset()
        for _ in range(3):
            r.render()
        return r.accumulation.clone()

    calls = []

    def kernel(*a, **kw):
        calls.append(tint.bvh_fat_intersect.launches)
        return tint.bvh_fat_intersect(*a, **kw)

    plain = lambda fat, ro, rd, ray_batch: tint._bvh_fat_intersect_plain(fat, ro, rd)
    launched = tint.bvh_fat_intersect.launches
    got = frames(kernel)
    assert len(calls) >= 3 and tint.bvh_fat_intersect.launches == launched + len(calls)
    assert calls == list(range(launched, launched + len(calls)))
    assert torch.equal(got, frames(plain))
