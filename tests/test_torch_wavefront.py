"""Port parity: the wavefront tracer (tpu_pathtracer_torch/ops/wavefront.py).

The cases of tests/test_wavefront.py, mirrored on the port, on its scene (a
rough metal plane and an orange sphere under a gradient sky, compiled by
both packages).  Inside the port the wavefront frame uses the skip-link
walk, `ray_triangle` and `bounce_shade` of the `bvh` intersector and
differs from it only in lane order and in how lanes that are not active
are parked, so it must equal `render_frame(..., intersector="bvh")` bit
for bit.  Against the default fused frame (the MT kernels' form) and
against JAX's `render_frame_wavefront` frames follow the outlier rule of
tests/test_trace_golden.py (the MT forms split on borderline pixels)."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_pathtracer.ops import wavefront as jwave
from tpu_pathtracer.scene import primitives as jprimitives
from tpu_pathtracer.scene.envmap import gradient_sky as j_gradient_sky
from tpu_pathtracer.scene.host import Material as JMaterial
from tpu_pathtracer.scene.host import Mesh as JMesh
from tpu_pathtracer.scene.host import Scene as JScene
from tpu_pathtracer.scene.types import Camera as JCamera
from tpu_pathtracer.scene.types import RenderParams as JRenderParams
from tpu_pathtracer_torch.ops import trace as ttrace
from tpu_pathtracer_torch.ops import wavefront as twave
from tpu_pathtracer_torch.ops.intersect import bvh_intersect
from tpu_pathtracer_torch.scene import primitives
from tpu_pathtracer_torch.scene.envmap import gradient_sky
from tpu_pathtracer_torch.scene.host import Material, Mesh, Scene, rotation_x, translation
from tpu_pathtracer_torch.scene.types import Camera, RenderParams
from test_torch_trace import assert_images_close

W = H = 16
CAM = dict(position=(0, 1, 4), look_at=(0, 0.5, 0), fov=45, aperture=0.1, focal_distance=4.0)


def _build(scene_cls, mesh_cls, material_cls, sky, plane, sphere):
    sc = scene_cls()
    p, n, i = plane(4, 4)
    sc.add(mesh_cls(p, n, i, material_cls(roughness=0.4, metalness=0.5),
                    transform=rotation_x(-math.pi / 2)))
    p, n, i = sphere(0.5, 12, 8)
    sc.add(mesh_cls(p, n, i, material_cls(color=(0.9, 0.4, 0.2)),
                    transform=translation(0, 0.5, 0)))
    sc.set_environment(sky(16, 32))
    return sc


@pytest.fixture(scope="module")
def scenes():
    """tests/test_wavefront.py's scene, in both packages."""
    js = _build(JScene, JMesh, JMaterial, j_gradient_sky, jprimitives.plane, jprimitives.sphere)
    ts = _build(Scene, Mesh, Material, gradient_sky, primitives.plane, primitives.sphere)
    return js.compile(), ts.compile(device="cpu")


def _params(frame=1):
    return RenderParams.create(Camera.create(**CAM), frame=frame)


def _assert_same_frame(a, b):
    assert a.shape == b.shape and torch.equal(a, b), \
        f"{int((a != b).any(-1).sum())} pixels differ"


@pytest.mark.parametrize("sort_rays", [False, True])
@pytest.mark.parametrize("chunk", [64, 256])
def test_wavefront_equals_the_bvh_frame(scenes, sort_rays, chunk):
    kw = dict(width=W, height=H, aspect=1.0, samples_per_frame=2, max_bounces=3)
    bvh = ttrace.render_frame(scenes[1], _params(), intersector="bvh", **kw)
    wave = twave.render_frame_wavefront(scenes[1], _params(), chunk=chunk, sort_rays=sort_rays,
                                        **kw)
    _assert_same_frame(wave, bvh)


def test_wavefront_pads_to_chunk_multiple(scenes):
    """100 rays and chunk 64: 28 inactive padding lanes, the same frame."""
    kw = dict(width=10, height=10, aspect=1.0, samples_per_frame=1, max_bounces=2)
    bvh = ttrace.render_frame(scenes[1], _params(), intersector="bvh", **kw)
    wave = twave.render_frame_wavefront(scenes[1], _params(), chunk=64, sort_rays=True, **kw)
    _assert_same_frame(wave, bvh)


def test_wavefront_deep_bounces(scenes):
    kw = dict(width=W, height=H, aspect=1.0, samples_per_frame=1, max_bounces=8)
    wave = twave.render_frame_wavefront(scenes[1], _params(), chunk=64, **kw)
    assert torch.isfinite(wave).all() and wave.max() > 0
    _assert_same_frame(wave, ttrace.render_frame(scenes[1], _params(), intersector="bvh", **kw))


def test_wavefront_matches_jax(scenes):
    kw = dict(width=W, height=H, aspect=1.0, samples_per_frame=2, max_bounces=3, chunk=64)
    want = jwave.render_frame_wavefront(
        scenes[0], JRenderParams.create(JCamera.create(**CAM), frame=1), **kw)
    got = twave.render_frame_wavefront(scenes[1], _params(), **kw)
    assert got.shape == (H, W, 3)
    assert_images_close(np.asarray(want), got.numpy())


def test_wavefront_against_the_fused_frame(scenes):
    """The default frame goes through the MT kernels' plain versions, whose
    Möller–Trumbore form differs from `ray_triangle`'s: the outlier rule."""
    kw = dict(width=W, height=H, aspect=1.0, samples_per_frame=1, max_bounces=3)
    fused = ttrace.render_frame(scenes[1], _params(2), **kw)
    wave = twave.render_frame_wavefront(scenes[1], _params(2), chunk=64, **kw)
    assert_images_close(fused.numpy(), wave.numpy())


def _rays(r, seed):
    rng = np.random.default_rng(seed)
    ro = rng.uniform(-3, 3, (r, 3)).astype(np.float32)
    rd = rng.normal(size=(r, 3))
    rd = (rd / np.linalg.norm(rd, axis=1, keepdims=True)).astype(np.float32)
    active = rng.random(r) < 0.8
    return ro, rd, active


def test_coherence_key_matches_jax(scenes):
    ro, rd, active = _rays(1024, 5)
    ro[:8] = [[-2, -1, -3]] * 8  # origins outside the root box clamp to the edge cells
    nodes = np.asarray(scenes[0].packed.nodes)
    want = jwave._coherence_key(jnp.asarray(ro), jnp.asarray(rd), jnp.asarray(active),
                                jnp.asarray(nodes[0, 0:3]), jnp.asarray(nodes[0, 3:6]))
    tn = scenes[1].packed.nodes
    got = twave._coherence_key(torch.from_numpy(ro), torch.from_numpy(rd),
                               torch.from_numpy(active), tn[0, 0:3], tn[0, 3:6])
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), np.asarray(want).astype(np.int64))
    assert (got.numpy()[~active] == 0xFFFFFFFF).all()


@pytest.mark.parametrize("chunk", [64, 256])
def test_chunked_intersect_equals_bvh_intersect(scenes, chunk):
    """Active lanes hit what `bvh_intersect` hits, bit for bit; lanes that
    are not active start finished and miss."""
    ro, rd, active = _rays(512, 6)
    ro[:, 1] = np.abs(ro[:, 1])  # above the plane, looking down: most rays hit it
    rd[:, 1] = -np.abs(rd[:, 1])
    packed = scenes[1].packed
    ro_t, rd_t, act_t = torch.from_numpy(ro), torch.from_numpy(rd), torch.from_numpy(active)
    got = twave._chunked_intersect(packed.nodes, packed.tri_pos, ro_t, rd_t, act_t, chunk)
    want = bvh_intersect(packed.nodes, packed.tri_pos, ro_t, rd_t)
    assert int(want.hit[act_t].sum()) > 100
    for g, w in zip(got, want):
        assert torch.equal(g[act_t], w[act_t])
    assert not got.hit[~act_t].any() and (got.tri[~act_t] == -1).all()
    with pytest.raises(ValueError, match="multiple of chunk"):
        twave._chunked_intersect(packed.nodes, packed.tri_pos, ro_t[:100], rd_t[:100],
                                 act_t[:100], chunk)


def test_trace_rays_wavefront_equals_trace_rays(scenes):
    """Random rays (a count that 64 does not divide) with random seeds:
    radiance and seeds equal the plain loop's 'bvh' trace bit for bit."""
    ro, rd, _ = _rays(300, 7)
    seed = torch.from_numpy(np.random.default_rng(8).integers(0, 2**32, 300))
    args = (scenes[1], _params(), torch.from_numpy(ro), torch.from_numpy(rd), seed)
    inc_w, seed_w = twave.trace_rays_wavefront(*args, max_bounces=3, chunk=64)
    inc_b, seed_b = ttrace.trace_rays(*args, max_bounces=3, intersector="bvh")
    assert torch.equal(seed_w, seed_b) and torch.equal(inc_w, inc_b)
    assert twave.accumulate is ttrace.accumulate
