"""Port parity: the streamed large-scene MT kernel's plain version, its
boxes and lists, `resolve_intersector`, and whole frames on the
`mt_stream` path.

The JAX side runs `_kernel_stream2` in interpret mode, as
tests/test_mt_shade.py does.  Hits are held to
`tests/test_mt_shade.py::assert_hit_parity` (equal hit masks and
triangles, t within rtol 5e-5, u/v within rtol 1e-3); boxes and lists must
be equal; images follow the outlier rule of tests/test_trace_golden.py.
The CUDA kernel itself is compared with the plain version in
tests/test_torch_cuda.py and chip_smoke.py, on a machine with a card."""

import math
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu_pathtracer as jpt
from tpu_pathtracer.ops import trace as jtrace
from tpu_pathtracer.ops.mt_matmul import mt_intersect as j_mt_intersect
from tpu_pathtracer.ops.mt_matmul import ray_features as j_ray_features
from tpu_pathtracer.ops.pallas.mt_intersect import _pad_to as j_pad_to
from tpu_pathtracer.ops.pallas.mt_intersect import treelet_boxes as j_treelet_boxes
from tpu_pathtracer.ops.pallas.mt_shade import _dead_pad_boxes as j_dead_pad_boxes
from tpu_pathtracer.ops.pallas.mt_shade import _precull_live_subs as j_precull
from tpu_pathtracer.ops.pallas.mt_shade import mt_intersect_stream2 as j_stream2
from tpu_pathtracer.ops.pallas.mt_shade import mt_intersect_stream2_phi as j_stream2_phi
from tpu_pathtracer.scene import primitives as jprim
from tpu_pathtracer.scene.envmap import gradient_sky as j_gradient_sky
from tpu_pathtracer.scene.host import Material as JMaterial
from tpu_pathtracer.scene.host import Mesh as JMesh
from tpu_pathtracer.scene.host import Scene as JScene
from tpu_pathtracer.scene.host import rotation_x as j_rotation_x
import tpu_pathtracer_torch as tpt
from tpu_pathtracer_torch import _build
from tpu_pathtracer_torch.ops import trace as ttrace
from tpu_pathtracer_torch.ops.kernels import mt_shade, mt_stream
from tpu_pathtracer_torch.scene import primitives as tprim
from tpu_pathtracer_torch.scene.envmap import gradient_sky
from tpu_pathtracer_torch.scene.host import rotation_x
from test_torch_mt import assert_hit_parity, precull_edge_rays, random_rays, random_soup
from test_torch_trace import assert_images_close


def _phi(ro, rd):
    return j_ray_features(jnp.asarray(ro), jnp.asarray(rd)).T


@pytest.mark.parametrize("n_tris,n_rays,park,seed", [
    (2200, 640, "every 3rd", 17),     # the multi-super soup of tests/test_mt_shade.py
    (2100, 768, "first tile", 18),    # one all-parked tile beside a live one
])
def test_stream_plain_matches_pallas_interpret(n_tris, n_rays, park, seed):
    rng = np.random.default_rng(seed)
    tri = random_soup(rng, n_tris, spread=0.1)
    ro, rd = random_rays(rng, n_rays, park_every=3 if park == "every 3rd" else 0)
    if park == "first tile":
        ro[:512], rd[:512] = np.float32(1e30), np.float32(0.0)
    parked = rd[:, 0] == 0.0
    ha = j_stream2(jnp.asarray(tri), jnp.asarray(ro), jnp.asarray(rd), interpret=True)
    hb = mt_stream.mt_intersect_stream2(torch.from_numpy(tri), torch.from_numpy(ro),
                                        torch.from_numpy(rd))
    assert parked.sum() > 0 and not hb.hit.numpy()[parked].any()
    assert_hit_parity(ha, hb, min_hits=30)
    assert_hit_parity(j_mt_intersect(jnp.asarray(tri), jnp.asarray(ro), jnp.asarray(rd)),
                      hb, min_hits=30)


def test_stream_plain_matches_nf_plain_bit_for_bit():
    """Both plain walks reach the nearest hit with the same arithmetic, so
    on a scene both accept they agree exactly."""
    rng = np.random.default_rng(21)
    tri = torch.from_numpy(random_soup(rng, 5000, spread=0.1))
    phi_t = _phi(*random_rays(rng, 1500, park_every=5))
    phi_t = torch.from_numpy(np.asarray(phi_t).copy())
    hs = mt_stream.mt_intersect_stream2_phi(tri[:4000], phi_t, tile_rays=256)
    hn = mt_shade.mt_intersect_nf_phi(tri[:4000], phi_t)
    assert int(hs.hit.sum()) > 100
    for a, b in zip(hs, hn):
        assert torch.equal(a, b)


def test_walk_stats_bound_the_walk():
    """Per-tile walk counts of the plain walk: a tile walks at most its
    listed supers (at least the first), stages at most 16 chunks per super
    and evaluates at most 4 subs per staged chunk; an all-parked tile walks
    nothing."""
    rng = np.random.default_rng(19)
    tri = torch.from_numpy(random_soup(rng, 5000, spread=0.1))
    ro, rd = random_rays(rng, 1024)
    ro[:256], rd[:256] = np.float32(1e30), np.float32(0.0)
    phi_t = torch.from_numpy(np.asarray(_phi(ro, rd)).copy())
    stats = mt_stream.walk_stats(tri, phi_t, tile_rays=256)
    counts = mt_stream._prepare(tri, phi_t, 256)[4]
    assert stats.shape == (4, 3) and stats.dtype == torch.int32
    assert (stats[0] == 0).all() and counts[0] == 0
    assert ((stats[1:, 0] >= 1) & (stats[1:, 0] <= counts[1:])).all()
    assert (stats[:, 1] <= 16 * stats[:, 0]).all() and (stats[:, 2] <= 4 * stats[:, 1]).all()
    assert int(stats[:, 2].sum()) > 0


def test_dead_pad_boxes_match_jax():
    rng = np.random.default_rng(3)
    boxes = rng.uniform(-1, 1, (10, 8)).astype(np.float32)
    for n_real, granule in ((300, 128), (1280, 128), (1281, 128), (0, 32)):
        np.testing.assert_array_equal(
            mt_shade._dead_pad_boxes(torch.from_numpy(boxes), n_real, granule).numpy(),
            np.asarray(j_dead_pad_boxes(jnp.asarray(boxes), n_real, granule)))


@pytest.mark.parametrize("rays", ["soup", "edges"])
def test_stream_boxes_and_precull_lists_match_jax(rays):
    """The wrapper's chunk and sub boxes and its near-to-far super lists
    equal the JAX wrapper's (`_mt_intersect_stream2_impl`); "edges": rays
    parked inside the supers, axes under EPSILON or exactly 0."""
    rng = np.random.default_rng(9)
    n = 5000  # 3 supers, the last one mostly padding
    tri = random_soup(rng, n, spread=0.1)
    if rays == "soup":
        ro, rd = random_rays(rng, 1000, park_every=4)
        phi = np.asarray(_phi(ro, rd))
    else:
        supers = np.asarray(j_treelet_boxes(j_pad_to(jnp.asarray(tri), 3 * 2048, 0), 2048))
        phi = precull_edge_rays(rng, 1000, supers)
    (phi_pad, _, chunk_boxes, sub_boxes, counts, lists, emins,
     tile_rays) = mt_stream._prepare(torch.from_numpy(tri), torch.from_numpy(phi.copy()), 256)
    assert tile_rays == 256 and phi_pad.shape == (10, 1024)
    tri_p = j_pad_to(jnp.asarray(tri), 3 * 2048, 0)
    jboxes = {g: j_dead_pad_boxes(j_treelet_boxes(tri_p, g), n, g) for g in (2048, 128, 32)}
    np.testing.assert_array_equal(chunk_boxes.numpy(), np.asarray(jboxes[128]))
    np.testing.assert_array_equal(sub_boxes.numpy(), np.asarray(jboxes[32]))
    assert chunk_boxes.shape == (48, 8) and (chunk_boxes[40:, 0] == 1e20).all()
    jc, jl, je = (np.asarray(x) for x in j_precull(
        jboxes[2048], j_pad_to(jnp.asarray(phi), 1024, 1, value=1e30), 256))
    np.testing.assert_array_equal(counts.numpy(), jc[:, 0])
    assert counts.sum() > 0
    for t in range(counts.shape[0]):
        np.testing.assert_array_equal(lists[t, :counts[t]].numpy(), jl[t, :jc[t, 0]])
        np.testing.assert_array_equal(emins[t, :counts[t]].numpy(), je[t, :jc[t, 0]])


RESOLVE = [
    ("auto", 0, "mt_pallas"),
    ("auto", 8192, "mt_pallas"),
    ("auto", 8193, "mt_stream"),
    ("auto", 262144, "mt_stream"),
    ("auto", 262145, "bvh8"),
    ("mt_stream", 100, "mt_stream"),
    ("mt_pallas", 9000, "mt_pallas"),  # the wrapper rejects it, as in JAX
    ("bvh8", 100, "bvh8"),
    ("bvh", 100, "bvh"),
    ("mt", 100, "mt"),
    ("nope", 100, ValueError),
]


@pytest.mark.parametrize("name,n_tris,want", RESOLVE,
                         ids=[f"{r[0]}-{r[1]}" for r in RESOLVE])
def test_resolve_intersector(name, n_tris, want):
    if isinstance(want, str):
        assert ttrace.resolve_intersector(name, n_tris) == want
    else:
        with pytest.raises(want):
            ttrace.resolve_intersector(name, n_tris)


@pytest.mark.parametrize("n_tris", [2048, 16384, 131072])
def test_key_boxes_match_jax(n_tris):
    """The coherence key's treelet boxes coarsen to at most 64, as in JAX
    `trace_rays_fused` (ops/trace.py:767-774): 2,048-triangle boxes at the
    stress scene's 131,072."""
    tri = random_soup(np.random.default_rng(n_tris), n_tris)
    granule = 128
    while n_tris > 64 * granule:
        granule *= 2
    want = j_treelet_boxes(j_pad_to(jnp.asarray(tri), -(-n_tris // granule) * granule, 0),
                           granule)
    got = ttrace._key_boxes(torch.from_numpy(tri))
    assert got.shape[0] == min(64, n_tris // 128)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_stream_empty_and_oversized_scenes():
    phi_t = torch.from_numpy(np.asarray(_phi(*random_rays(np.random.default_rng(2), 64))).copy())
    h = mt_stream.mt_intersect_stream2_phi(torch.zeros((0, 9)), phi_t)
    assert not h.hit.any() and (h.tri == -1).all() and (h.t == 1e20).all()
    with pytest.raises(ValueError, match="bvh8"):
        mt_stream.mt_intersect_stream2_phi(torch.zeros((262145, 9)), phi_t)
    with pytest.raises(NotImplementedError):
        mt_stream.mt_intersect_stream2_phi(torch.zeros((8, 9), device="meta"),
                                           torch.zeros((10, 8), device="meta"))


def test_header_edit_changes_library_path(tmp_path, monkeypatch):
    """The library is named by a hash of the sources and the shared
    headers: editing mt_common.cuh must not load a stale build."""
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    before = _build.library_path()
    assert [p.name for p in _build._sources()] == ["cond_walk.cu", "denoise.cu", "fat_walk.cu",
                                                   "mxu_walk.cu", "nf_walk.cu", "precull.cu",
                                                   "r2_walk.cu", "stream_walk.cu"]
    header = csrc / "mt_common.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = _build.library_path()
    assert after != before and after.parent == before.parent
    (csrc / "mt_stream.cu").write_text("// edited\n")
    assert _build.library_path() not in (before, after)


def _scenes():
    """sphere(0.5, 48, 24) + plane: 2,210 triangles, padded to 4,096 (two
    supers); the cut-down stress scene of bench.py."""
    js = JScene()
    js.add(JMesh(*jprim.sphere(0.5, 48, 24), JMaterial(color=(0.8, 0.7, 0.6))))
    js.add(JMesh(*jprim.plane(4, 4), JMaterial(), transform=j_rotation_x(-math.pi / 2)))
    js.set_environment(j_gradient_sky(8, 16))
    ts = tpt.Scene()
    ts.add(tpt.Mesh(*tprim.sphere(0.5, 48, 24), tpt.Material(color=(0.8, 0.7, 0.6))))
    ts.add(tpt.Mesh(*tprim.plane(4, 4), tpt.Material(), transform=rotation_x(-math.pi / 2)))
    ts.set_environment(gradient_sky(8, 16))
    return js.compile(), ts.compile(device="cpu")


@pytest.fixture(scope="module")
def stream_scenes():
    jsd, tsd = _scenes()
    assert tsd.packed.tri_pos.shape == (4096, 9)
    return jsd, tsd


CAM = dict(position=(0, 1, 4), look_at=(0, 0.5, 0), fov=45)


def test_render_frame_mt_stream_matches_jax(stream_scenes):
    jsd, tsd = stream_scenes
    kw = dict(width=16, height=16, aspect=1.0, samples_per_frame=1, max_bounces=2,
              intersector="mt_stream")
    a = jtrace.render_frame(jsd, jpt.RenderParams.create(jpt.Camera.create(**CAM), frame=2), **kw)
    b = ttrace.render_frame(tsd, tpt.RenderParams.create(tpt.Camera.create(**CAM), frame=2), **kw)
    assert b.shape == (16, 16, 3) and torch.isfinite(b).all()
    assert_images_close(np.asarray(a), b.numpy())


def test_trace_rays_fused_mt_stream_seeds_and_radiance_match_jax(stream_scenes):
    jsd, tsd = stream_scenes
    rng = np.random.default_rng(3)
    r = 256
    ro = (rng.uniform(-1, 1, (r, 3)) + [0.0, 1.0, 3.0]).astype(np.float32)
    rd = rng.normal(size=(r, 3)) * 0.3 + [0.0, -0.3, -1.0]
    rd = (rd / np.linalg.norm(rd, axis=1, keepdims=True)).astype(np.float32)
    seed = rng.integers(0, 2**31, r).astype(np.uint32)
    jp = jpt.RenderParams.create(jpt.Camera.create(**CAM), frame=2)
    inc_j, seed_j = jtrace.trace_rays_fused(
        jsd, jp, jnp.asarray(ro), jnp.asarray(rd), jnp.asarray(seed), max_bounces=2,
        intersector_phi_fn=lambda phi: j_stream2_phi(jsd.packed.tri_pos, phi, interpret=True))
    tp = tpt.RenderParams.create(tpt.Camera.create(**CAM), frame=2)
    inc_t, seed_t = ttrace.trace_rays_fused(
        tsd, tp, torch.from_numpy(ro), torch.from_numpy(rd),
        torch.from_numpy(seed.astype(np.int64)), max_bounces=2,
        intersector_phi_fn=lambda phi: mt_stream.mt_intersect_stream2_phi(
            tsd.packed.tri_pos, phi))
    assert (seed_t.numpy().astype(np.uint32) != seed).mean() > 0.3  # rays hit the scene
    same = seed_t.numpy().astype(np.uint32) == np.asarray(seed_j)
    assert same.mean() >= 0.99
    np.testing.assert_allclose(inc_t.numpy()[same], np.asarray(inc_j)[same],
                               rtol=1e-4, atol=1e-5)
