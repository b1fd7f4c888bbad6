"""Port parity: ray-primitive tests, the BVH traversals and the frames they
render (tpu_pathtracer_torch/ops/intersect.py, the 'mt', 'bvh' and 'bvh8'
intersectors of ops/trace.py).

Scenes are compiled by both packages from the same meshes (byte-equal,
tests/test_torch_scene.py): the random soups of tests/test_intersect.py
(200 triangles, seed 0; 300 triangles, seed 4) and the default scene.
Traversals must give equal hit masks and triangles; t follows
tests/test_intersect.py's bound between its own traversals (rtol 2e-6,
atol 1e-7), and u and v, which cancel more and whose sums XLA may contract
differently, tests/test_mt_shade.py's (rtol 1e-3, atol 1e-4).  Frames
follow the outlier rule of tests/test_trace_golden.py; gradients
tests/test_mt_matmul.py's rtol 1e-5 / atol 1e-6."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu_pathtracer as jpt
from tpu_pathtracer.ops import intersect as jint
from tpu_pathtracer.ops import trace as jtrace
from tpu_pathtracer.ops.mt_matmul import mt_intersect_diff as j_mt_intersect_diff
from tpu_pathtracer.scene.envmap import gradient_sky as j_gradient_sky
from tpu_pathtracer.scene.host import Material as JMaterial
from tpu_pathtracer.scene.host import Mesh as JMesh
from tpu_pathtracer.scene.host import Scene as JScene
import tpu_pathtracer_torch as tpt
from tpu_pathtracer_torch.ops import intersect as tint
from tpu_pathtracer_torch.ops import trace as ttrace
from tpu_pathtracer_torch.ops.mt_matmul import mt_intersect_diff
from tpu_pathtracer_torch.scene.envmap import gradient_sky
from test_torch_trace import assert_images_close


def _soup_scenes(n, seed):
    """tests/test_intersect.py::_random_soup_scene in both packages."""
    rs = np.random.RandomState(seed)
    base = rs.uniform(-2, 2, (n, 3)).astype(np.float32)
    e1 = rs.uniform(-0.5, 0.5, (n, 3)).astype(np.float32)
    e2 = rs.uniform(-0.5, 0.5, (n, 3)).astype(np.float32)
    pos = np.stack([base, base + e1, base + e2], axis=1).reshape(-1, 3)
    nrm = np.tile(np.array([[0, 0, 1]], np.float32), (pos.shape[0], 1))
    idx = np.arange(pos.shape[0]).reshape(-1, 3)
    js, ts = JScene(), tpt.Scene()
    js.add(JMesh(pos, nrm, idx, JMaterial()))
    ts.add(tpt.Mesh(pos, nrm, idx, tpt.Material()))
    return js.compile(), ts.compile(device="cpu")


def _random_rays(seed, r):
    rs = np.random.RandomState(seed)
    ro = rs.uniform(-3, 3, (r, 3)).astype(np.float32)
    rd = rs.randn(r, 3).astype(np.float32)
    return ro, (rd / np.linalg.norm(rd, axis=-1, keepdims=True)).astype(np.float32)


def _camera_rays(r=1024, seed=2):
    """Rays from the headline camera toward the default scene."""
    rng = np.random.default_rng(seed)
    target = rng.uniform([-1.5, 0.0, -1.0], [1.5, 1.2, 1.0], (r, 3))
    ro = np.tile(np.float32([[0.0, 1.0, 4.0]]), (r, 1))
    rd = (target - ro) / np.linalg.norm(target - ro, axis=1, keepdims=True)
    return ro, rd.astype(np.float32)


@pytest.fixture(scope="module")
def scenes():
    out = {"soup200": _soup_scenes(200, 0) + (_random_rays(1, 256),),
           "soup300": _soup_scenes(300, 4) + (_random_rays(7, 512),)}
    jd = jpt.default_scene(j_gradient_sky(8, 16)).compile()
    td = tpt.default_scene(gradient_sky(8, 16)).compile(device="cpu")
    out["default"] = (jd, td, _camera_rays())
    return out


def assert_same_hits(ha, hb, min_hits=20):
    """ha: JAX Hit; hb: port Hit."""
    hb = [x.numpy() for x in hb]
    np.testing.assert_array_equal(hb[0], np.asarray(ha.hit))
    m = hb[0]
    assert m.sum() >= min_hits
    np.testing.assert_array_equal(hb[2], np.asarray(ha.tri))
    np.testing.assert_allclose(hb[1][m], np.asarray(ha.t)[m], rtol=2e-6, atol=1e-7)
    np.testing.assert_array_equal(hb[1][~m], np.asarray(ha.t)[~m])  # INF on misses
    for k in (3, 4):
        np.testing.assert_allclose(hb[k][m], np.asarray(ha[k])[m], rtol=1e-3, atol=1e-4)


def _t(*arrays):
    return tuple(torch.from_numpy(np.array(a)) for a in arrays)


def test_ray_triangle_and_aabb_match_jax():
    """Elementwise tests on random pairs, parallel and degenerate ones
    included (zero-area triangles, axis-parallel directions, origins on box
    faces)."""
    rng = np.random.default_rng(0)
    n = 4000
    ro = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    rd = rng.normal(size=(n, 3)).astype(np.float32)
    rd[::7, rng.integers(0, 3)] = 0.0  # parallel to a slab
    p0, p1, p2 = (rng.uniform(-1, 1, (n, 3)).astype(np.float32) for _ in range(3))
    p2[::11] = p1[::11]  # degenerate
    jv = jint.ray_triangle(*(jnp.asarray(x) for x in (ro, rd, p0, p1, p2)))
    tv = tint.ray_triangle(*_t(ro, rd, p0, p1, p2))
    np.testing.assert_array_equal(tv[0].numpy(), np.asarray(jv[0]))
    m = np.asarray(jv[0])
    assert 50 < m.sum() < n
    np.testing.assert_allclose(tv[1].numpy()[m], np.asarray(jv[1])[m], rtol=2e-6, atol=1e-7)
    for a, b in zip(tv[2:], jv[2:]):
        np.testing.assert_allclose(a.numpy()[m], np.asarray(b)[m], rtol=1e-3, atol=1e-4)
    bmin = np.minimum(p0, p1)
    bmax = np.maximum(p0, p1)
    bmin[::13] = ro[::13]  # origin on a face
    jh, jt = jint.ray_aabb_t(*(jnp.asarray(x) for x in (ro, rd, bmin, bmax)))
    th, tt = tint.ray_aabb_t(*_t(ro, rd, bmin, bmax))
    np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(
        tint.ray_aabb(*_t(ro, rd, bmin, bmax)).numpy(),
        np.asarray(jint.ray_aabb(*(jnp.asarray(x) for x in (ro, rd, bmin, bmax)))))
    assert 200 < np.asarray(jh).sum() < n


@pytest.mark.parametrize("name", ["soup200", "soup300", "default"])
def test_bvh_intersect_matches_jax(scenes, name):
    jd, td, (ro, rd) = scenes[name]
    ha = jint.bvh_intersect(jd.packed.nodes, jd.packed.tri_pos, jnp.asarray(ro), jnp.asarray(rd))
    hb = tint.bvh_intersect(td.packed.nodes, td.packed.tri_pos, *_t(ro, rd))
    assert_same_hits(ha, hb)


@pytest.mark.parametrize("name", ["soup200", "default"])
def test_bvh_intersect_stack_matches_jax(scenes, name):
    """The literal stack walk, in the original triangle order."""
    jd, td, (ro, rd) = scenes[name]
    ha = jint.bvh_intersect_stack(jd.bvh, jd.triangles, jnp.asarray(ro), jnp.asarray(rd))
    hb = tint.bvh_intersect_stack(td.bvh, td.triangles, *_t(ro, rd))
    assert_same_hits(ha, hb)
    # and the skip-link walk finds the same triangles (through tri_perm)
    hl = tint.bvh_intersect(td.packed.nodes, td.packed.tri_pos, *_t(ro, rd))
    perm = td.packed.tri_perm.numpy()
    link = np.where(hl.tri.numpy() >= 0, perm[np.clip(hl.tri.numpy(), 0, None)], -1)
    np.testing.assert_array_equal(link, hb.tri.numpy())


def test_brute_force_matches_jax_and_the_walks(scenes):
    jd, td, (ro, rd) = scenes["soup200"]
    ha = jint.brute_force_intersect(jd.triangles, jnp.asarray(ro), jnp.asarray(rd))
    hb = tint.brute_force_intersect(td.triangles, *_t(ro, rd))
    assert_same_hits(ha, hb)
    hs = tint.bvh_intersect_stack(td.bvh, td.triangles, *_t(ro, rd))
    assert torch.equal(hs.tri, hb.tri) and torch.equal(hs.t, hb.t)


@pytest.mark.parametrize("ray_batch", [0, 128, 16384], ids=["unbatched", "batch128", "default"])
@pytest.mark.parametrize("name", ["soup300", "default"])
def test_bvh_fat_intersect_matches_jax(scenes, name, ray_batch):
    """bvh8 with all rays in one walk, in 128-ray batches (which divide R)
    and at the default batch (larger than R: one walk)."""
    jd, td, (ro, rd) = scenes[name]
    ha = jint.bvh_fat_intersect(jd.packed.fat_nodes, jnp.asarray(ro), jnp.asarray(rd),
                                ray_batch=ray_batch)
    hb = tint.bvh_fat_intersect(td.packed.fat_nodes, *_t(ro, rd), ray_batch=ray_batch)
    assert_same_hits(ha, hb)
    h0 = tint.bvh_fat_intersect(td.packed.fat_nodes, *_t(ro, rd), ray_batch=0)
    for a, b in zip(hb, h0):
        assert torch.equal(a, b)


def test_walk_checks_do_not_change_results(scenes, monkeypatch):
    """Dropping finished lanes every few steps gives every lane the state
    the per-step loop gives it: the same hits whether the host checks after
    every step or after many."""
    _, td, (ro, rd) = scenes["default"]
    ro, rd = _t(ro, rd)
    runs = []
    for every in (1, 3, 64):
        monkeypatch.setattr(tint, "_CHECK_EVERY", every)
        runs.append((tint.bvh_fat_intersect(td.packed.fat_nodes, ro, rd, ray_batch=0),
                     tint.bvh_intersect(td.packed.nodes, td.packed.tri_pos, ro, rd),
                     tint.bvh_intersect_stack(td.bvh, td.triangles, ro, rd)))
    for other in runs[1:]:
        for ha, hb in zip(runs[0], other):
            for a, b in zip(ha, hb):
                assert torch.equal(a, b)


def test_map_ray_batches_falls_back_to_one_call():
    calls = []

    def fn(ro, rd):
        calls.append(ro.shape[0])
        return tint.Hit(*(torch.zeros(ro.shape[0]) for _ in range(5)))

    ro = torch.zeros((96, 3))
    for batch, want in ((0, [96]), (96, [96]), (200, [96]), (40, [96]), (32, [32] * 3)):
        calls.clear()
        assert tint._map_ray_batches(fn, ro, ro, batch).t.shape == (96,)
        assert calls == want, batch


def test_empty_scene_misses():
    td = tpt.Scene().compile(device="cpu")
    jd = JScene().compile()
    ro = torch.zeros((8, 3))
    rd = torch.tensor([[0.0, 0.0, -1.0]]).repeat(8, 1)
    for h in (tint.bvh_intersect(td.packed.nodes, td.packed.tri_pos, ro, rd),
              tint.bvh_fat_intersect(td.packed.fat_nodes, ro, rd),
              tint.bvh_intersect_stack(td.bvh, td.triangles, ro, rd),
              tint.bvh_intersect(torch.zeros((0, 8)), torch.zeros((0, 9)), ro, rd)):
        assert not h.hit.any() and (h.tri == -1).all()
    assert not np.asarray(jint.bvh_intersect(jd.packed.nodes, jd.packed.tri_pos,
                                             jnp.asarray(ro.numpy()),
                                             jnp.asarray(rd.numpy())).hit).any()


def test_diff_intersectors_gradients_match_jax():
    """tests/test_mt_matmul.py::test_mt_diff_gradients_match_bvh_diff on
    both packages: d sum(t)/d ro through the detached walk + replay."""
    jd = jpt.default_scene().compile()
    td = tpt.default_scene().compile(device="cpu")
    rng = np.random.default_rng(13)
    ro = np.tile(np.float32([[0.0, 1.0, 4.0]]), (64, 1))
    target = rng.uniform(-0.5, 0.5, (64, 3)) + [0, 0.5, 0]
    rd = (target - ro) / np.linalg.norm(target - ro, axis=1, keepdims=True)
    rd = rd.astype(np.float32)

    def j_grad(fn):
        return np.asarray(jax.grad(lambda o: jnp.where((h := fn(o)).hit, h.t, 0.0).sum())(
            jnp.asarray(ro)))

    def t_grad(fn):
        o = torch.from_numpy(ro.copy()).requires_grad_(True)
        h = fn(o)
        torch.where(h.hit, h.t, 0.0).sum().backward()
        return o.grad.numpy()

    rd_j, rd_t = jnp.asarray(rd), torch.from_numpy(rd)
    g = {
        "bvh": (j_grad(lambda o: jint.bvh_intersect_diff(jd.packed.nodes, jd.packed.tri_pos,
                                                         o, rd_j)),
                t_grad(lambda o: tint.bvh_intersect_diff(td.packed.nodes, td.packed.tri_pos,
                                                         o, rd_t))),
        "mt": (j_grad(lambda o: j_mt_intersect_diff(jd.packed.tri_pos, o, rd_j)),
               t_grad(lambda o: mt_intersect_diff(td.packed.tri_pos, o, rd_t))),
    }
    for name, (want, got) in g.items():
        assert np.isfinite(got).all() and np.abs(got).sum() > 0, name
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6, err_msg=name)
    np.testing.assert_allclose(g["mt"][1], g["bvh"][1], rtol=1e-5, atol=1e-6)


CAM = dict(position=(0, 1, 4), look_at=(0, 0.5, 0), fov=45)
FRAME = dict(width=16, height=16, aspect=1.0, samples_per_frame=1, max_bounces=2)


@pytest.mark.parametrize("intersector", ["mt", "bvh", "bvh8"])
def test_render_frame_matches_jax(scenes, intersector):
    jd, td, _ = scenes["default"]
    a = jtrace.render_frame(jd, jpt.RenderParams.create(jpt.Camera.create(**CAM), frame=2),
                            intersector=intersector, **FRAME)
    b = ttrace.render_frame(td, tpt.RenderParams.create(tpt.Camera.create(**CAM), frame=2),
                            intersector=intersector, **FRAME)
    assert b.shape == (16, 16, 3) and torch.isfinite(b).all() and float(b.std()) > 0
    assert_images_close(np.asarray(a), b.numpy())


def test_auto_above_the_stream_cap_renders_through_bvh8(scenes, monkeypatch):
    """'auto' above the streamed kernel's cap (lowered here to the default
    scene's size) takes the fat-leaf walk in the plain loop, and its frame
    is the explicit 'bvh8' frame."""
    _, td, _ = scenes["default"]
    monkeypatch.setattr(ttrace, "MT_SHADE_MAX_TRIS", 1024)
    monkeypatch.setattr(ttrace, "MT_STREAM2_MAX_TRIS", 1024)
    assert ttrace.resolve_intersector("auto", td.packed.tri_pos.shape[0]) == "bvh8"
    calls = []
    fat = ttrace.bvh_fat_intersect
    monkeypatch.setattr(ttrace, "bvh_fat_intersect",
                        lambda *a, **k: calls.append(k) or fat(*a, **k))
    params = tpt.RenderParams.create(tpt.Camera.create(**CAM), frame=2)
    auto = ttrace.render_frame(td, params, **FRAME)
    assert calls and all(k == {"ray_batch": 0} for k in calls)
    assert torch.equal(auto, ttrace.render_frame(td, params, intersector="bvh8", **FRAME))
