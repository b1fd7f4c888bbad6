"""Port parity: the fused trace loop, whole frames and the Renderer.

The JAX side runs the fused path as its own tests do on the CPU
(`intersector="mt_pallas"`: the Pallas kernel in interpret mode).  Images
are held to the outlier rule of tests/test_trace_golden.py: at most 1% of
pixels may take a different random branch, every other pixel agrees to
1e-4 mean absolute difference."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu_pathtracer as jpt
from tpu_pathtracer.ops import trace as jtrace
from tpu_pathtracer.ops.pallas.mt_shade import mt_intersect_pallas2_phi
from tpu_pathtracer.post.pipeline import postprocess as j_postprocess
from tpu_pathtracer.scene.envmap import gradient_sky as j_gradient_sky
import tpu_pathtracer_torch as tpt
from tpu_pathtracer_torch.ops import trace as ttrace
from tpu_pathtracer_torch.ops.kernels import mt_shade
from tpu_pathtracer_torch.scene.envmap import gradient_sky


def assert_images_close(a, b, mean_tol=1e-4, outlier_frac=0.01, outlier_tol=0.05):
    """tests/test_trace_golden.py::_assert_images_close."""
    diff = np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))
    pix = diff.max(axis=-1)
    outlier = pix > outlier_tol
    assert outlier.mean() < outlier_frac, f"outlier fraction {outlier.mean():.4f}"
    agree = diff[~outlier].mean() if (~outlier).any() else 0.0
    assert agree < mean_tol, f"non-outlier mean abs diff {agree:.6f}"


CAM = dict(position=(0, 1, 4), look_at=(0, 0.5, 0), fov=45, aperture=0.05, focal_distance=4.0)


@pytest.fixture(scope="module")
def scenes():
    return (jpt.default_scene(j_gradient_sky(8, 16)).compile(),
            tpt.default_scene(gradient_sky(8, 16)).compile(device="cpu"))


def test_render_frame_matches_jax_fused(scenes):
    jsd, tsd = scenes
    kw = dict(width=32, height=32, aspect=1.0, samples_per_frame=1, max_bounces=3)
    a = jtrace.render_frame(jsd, jpt.RenderParams.create(jpt.Camera.create(**CAM), frame=2),
                            intersector="mt_pallas", **kw)
    b = ttrace.render_frame(tsd, tpt.RenderParams.create(tpt.Camera.create(**CAM), frame=2),
                            **kw)
    assert b.shape == (32, 32, 3) and torch.isfinite(b).all()
    assert_images_close(np.asarray(a), b.numpy())


def test_trace_rays_fused_seeds_and_radiance_match_jax(scenes):
    jsd, tsd = scenes
    rng = np.random.default_rng(3)
    r = 512
    ro = rng.uniform(-2, 2, (r, 3)).astype(np.float32)
    rd = rng.normal(size=(r, 3))
    rd = (rd / np.linalg.norm(rd, axis=1, keepdims=True)).astype(np.float32)
    seed = rng.integers(0, 2**31, r).astype(np.uint32)
    jcam = jpt.Camera.create(position=(0, 1, 4), look_at=(0, 0.5, 0), fov=45)
    jp = jpt.RenderParams.create(jcam, frame=2)
    inc_j, seed_j = jtrace.trace_rays_fused(
        jsd, jp, jnp.asarray(ro), jnp.asarray(rd), jnp.asarray(seed), max_bounces=3,
        intersector_phi_fn=lambda phi: mt_intersect_pallas2_phi(
            jsd.packed.tri_pos, phi, interpret=True))
    tp = tpt.RenderParams.create(tpt.Camera.create(position=(0, 1, 4), look_at=(0, 0.5, 0),
                                                   fov=45), frame=2)
    inc_t, seed_t = ttrace.trace_rays_fused(
        tsd, tp, torch.from_numpy(ro), torch.from_numpy(rd),
        torch.from_numpy(seed.astype(np.int64)), max_bounces=3,
        intersector_phi_fn=lambda phi: mt_shade.mt_intersect_nf_phi(tsd.packed.tri_pos, phi))
    same = seed_t.numpy().astype(np.uint32) == np.asarray(seed_j)
    assert same.mean() >= 0.99
    np.testing.assert_allclose(inc_t.numpy()[same], np.asarray(inc_j)[same],
                               rtol=1e-4, atol=1e-5)


def test_renderer_display_matches_jax_renderer():
    cfg = dict(width=32, height=32, frames=2, max_bounces=3, intersector="mt_pallas")
    jr = jpt.Renderer(jpt.default_scene(j_gradient_sky(8, 16)),
                      jpt.Camera.create(position=(0, 1, 4), look_at=(0, 0.5, 0), fov=45),
                      jpt.RenderConfig(**cfg), jpt.PostConfig())
    jr.render_all()
    events = []
    tr = tpt.Renderer(tpt.default_scene(gradient_sky(8, 16)),
                      tpt.Camera.create(position=(0, 1, 4), look_at=(0, 0.5, 0), fov=45),
                      tpt.RenderConfig(**cfg), tpt.PostConfig(), device="cpu")
    tr.on("complete", lambda: events.append("complete"))
    acc = tr.render_all()
    assert tr.status == "idle" and tr.frame == 3 and events == ["complete"]
    assert_images_close(np.asarray(jr.accumulation), acc.numpy())
    # The bilateral filter spreads each pixel that took another random branch
    # over its 5-pixel radius, so display() is held to the JAX post pipeline
    # on the same accumulation, and the accumulations to the outlier rule.
    out = tr.display()
    assert out.shape == (32, 32, 3) and float(out.min()) >= 0.0 and float(out.max()) <= 1.0
    want = j_postprocess(jnp.asarray(acc.numpy()), jpt.PostConfig(), 32, 32)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=2e-5, rtol=1e-4)


def test_renderer_state_machine_and_screenshot(tmp_path):
    r = tpt.Renderer(tpt.default_scene(gradient_sky(8, 16)), tpt.Camera.create(),
                     tpt.RenderConfig(width=16, height=8, frames=3, max_bounces=1),
                     device="cpu")
    seen = []
    for ev in ("reset", "start", "pause", "progress", "complete"):
        r.on(ev, lambda *a, ev=ev: seen.append(ev))
    r.reset()
    r.render()
    r.pause()
    r.render()  # paused: no frame
    assert r.frame == 2 and r.samples == 1 and r.status == "paused"
    r.start()
    r.render_all()
    assert r.status == "idle" and r.progress == 1.0
    assert seen.count("progress") == 3 and seen[-2:] == ["complete", "progress"]
    r.screenshot(str(tmp_path / "shot.png"))
    assert (tmp_path / "shot.png").read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"


def test_accumulate_matches_jax():
    rng = np.random.default_rng(0)
    frames = [rng.random((4, 4, 3)).astype(np.float32) for _ in range(4)]
    ja = jnp.zeros((4, 4, 3), jnp.float32)
    ta = torch.zeros((4, 4, 3))
    for f, img in enumerate(frames, start=1):
        ja = jtrace.accumulate(ja, jnp.asarray(img), f)
        ttrace.accumulate(ta, torch.from_numpy(img), f, out=ta)
        np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))


def test_blocked_grid_direction_bin_and_key_match_jax():
    xs, ys = ttrace.blocked_pixel_grid(48, 96)
    jxs, jys = jtrace.blocked_pixel_grid(48, 96)
    np.testing.assert_array_equal(xs.numpy(), np.asarray(jxs))
    np.testing.assert_array_equal(ys.numpy(), np.asarray(jys))
    flat = (xs + ys * 96).to(torch.float32)[:, None]
    np.testing.assert_array_equal(ttrace.unblock_image(flat, 48, 96)[..., 0].numpy(),
                                  np.arange(48 * 96, dtype=np.float32).reshape(48, 96))
    rng = np.random.default_rng(4)
    d = rng.normal(size=(3, 2000)).astype(np.float32)
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    o = rng.uniform(-2, 2, (3, 2000)).astype(np.float32)
    np.testing.assert_array_equal(ttrace._direction_bin(torch.from_numpy(d)).numpy(),
                                  np.asarray(jtrace._direction_bin(jnp.asarray(d))))
    boxes = np.array([[0, 0, 0, 1, 1, 1, 0, 0], [-1, -1, -1, 0, 0, 0, 0, 0]], np.float32)
    active = np.arange(2000) % 5 != 0
    np.testing.assert_array_equal(
        ttrace._coherence_key(torch.from_numpy(o), torch.from_numpy(d),
                              torch.from_numpy(active), torch.from_numpy(boxes)).numpy(),
        np.asarray(jtrace._coherence_key(jnp.asarray(o), jnp.asarray(d), jnp.asarray(active),
                                         jnp.asarray(boxes))))


UNPORTED = [
    ("env_importance", dict(env_importance=True)),
    ("blue_noise", dict(blue_noise=np.zeros((4, 4, 2), np.float32))),
    ("sort_window", dict(sort_window=256)),
]


@pytest.mark.parametrize("name,kw", UNPORTED, ids=[u[0] for u in UNPORTED])
def test_unported_render_options_raise(scenes, name, kw):
    _, tsd = scenes
    params = tpt.RenderParams.create(tpt.Camera.create(), frame=1)
    with pytest.raises(NotImplementedError):
        ttrace.render_frame(tsd, params, width=8, height=8, aspect=1.0, **kw)


@pytest.mark.parametrize("env", [None, "0", "4096"], ids=["unset", "zero", "nonzero"])
@pytest.mark.parametrize("entry", ["render_frame", "Renderer"])
def test_sort_window_variable_raises_when_nonzero(scenes, entry, env, monkeypatch):
    """TPT_SORT_WINDOW is read as JAX reads it (the override first, then the
    variable): a nonzero window raises as `sort_window=W` does, since the
    windowed sort is not ported; unset or 0 renders the global sort, and an
    explicit 0 overrides the variable."""
    if env is None:
        monkeypatch.delenv("TPT_SORT_WINDOW", raising=False)
    else:
        monkeypatch.setenv("TPT_SORT_WINDOW", env)
    cfg = dict(width=8, height=8, max_bounces=1)

    def run(window=None):
        if entry == "render_frame":
            params = tpt.RenderParams.create(tpt.Camera.create(), frame=1)
            return ttrace.render_frame(scenes[1], params, aspect=1.0, sort_window=window, **cfg)
        r = tpt.Renderer(tpt.default_scene(gradient_sky(8, 16)), tpt.Camera.create(),
                         tpt.RenderConfig(frames=1, sort_window=window, **cfg), device="cpu")
        return r.render_all()

    if env == "4096":
        with pytest.raises(NotImplementedError, match="windowed"):
            run()
    else:
        img = run()
        assert img.shape == (8, 8, 3) and torch.isfinite(img).all()
    assert run(window=0).shape == (8, 8, 3)


@pytest.mark.parametrize("kw", [dict(shard=object()), dict(env_importance=True)],
                         ids=["shard", "env_importance"])
def test_unported_renderer_options_raise(kw):
    with pytest.raises(NotImplementedError):
        tpt.Renderer(tpt.default_scene(), tpt.Camera.create(), device="cpu", **kw)


@pytest.fixture(scope="module")
def large_scene():
    """A sphere of 9,400 triangles, padded to 16,384: past the near-to-far
    kernel, so 'auto' takes the streamed kernel."""
    scene = tpt.Scene()
    p, n, i = tpt.scene.primitives.sphere(1.0, 80, 60)
    scene.add(tpt.Mesh(p, n, i, tpt.Material(color=(0.8, 0.7, 0.6))))
    scene.set_environment(gradient_sky(8, 16))
    return scene


LARGE_CAM = dict(position=(0, 0.5, 3), look_at=(0, 0, 0), fov=45)


def test_large_scene_auto_renders_through_mt_stream(large_scene, monkeypatch):
    data = large_scene.compile(device="cpu")
    assert data.packed.tri_pos.shape == (16384, 9) and dataclasses.is_dataclass(data)
    calls = []
    stream = ttrace.mt_intersect_stream2_phi
    monkeypatch.setattr(ttrace, "mt_intersect_stream2_phi",
                        lambda *a, **k: calls.append(1) or stream(*a, **k))
    params = tpt.RenderParams.create(tpt.Camera.create(**LARGE_CAM), frame=1)
    kw = dict(width=8, height=8, aspect=1.0, max_bounces=2)
    auto = ttrace.render_frame(data, params, **kw)
    assert len(calls) >= 1
    assert torch.equal(auto, ttrace.render_frame(data, params, intersector="mt_stream", **kw))
    assert torch.equal(auto, ttrace.render_frame(data, params, intersector="mt_stream",
                                                 plain=True, **kw))
    assert torch.isfinite(auto).all() and float(auto.std()) > 0.0


def test_large_scene_mt_pallas_raises_value_error(large_scene):
    params = tpt.RenderParams.create(tpt.Camera.create(**LARGE_CAM), frame=1)
    with pytest.raises(ValueError, match="mt_stream"):
        ttrace.render_frame(large_scene.compile(device="cpu"), params, width=8, height=8, aspect=1.0,
                            intersector="mt_pallas")


@pytest.mark.parametrize("intersector", ["auto", "mt_stream"])
def test_large_scene_renderer_completes(large_scene, intersector):
    r = tpt.Renderer(large_scene, tpt.Camera.create(**LARGE_CAM),
                     tpt.RenderConfig(width=8, height=8, frames=2, max_bounces=2,
                                      intersector=intersector), device="cpu")
    acc = r.render_all()
    out = r.display()
    assert r.status == "idle" and r.frame == 3 and torch.isfinite(acc).all()
    assert float(out.min()) >= 0.0 and float(out.max()) <= 1.0 and float(out.std()) > 0.0


def test_renderer_rejects_unported_intersector():
    """Every intersector of the JAX package is ported: the Renderer renders
    through 'bvh8', and rejects only a name no intersector has."""
    with pytest.raises(ValueError, match="unknown intersector"):
        tpt.Renderer(tpt.default_scene(), tpt.Camera.create(), device="cpu",
                     config=tpt.RenderConfig(intersector="bvh16"))
    r = tpt.Renderer(tpt.default_scene(gradient_sky(8, 16)),
                     tpt.Camera.create(position=(0, 1, 4), look_at=(0, 0.5, 0), fov=45),
                     tpt.RenderConfig(width=8, height=8, frames=2, max_bounces=2,
                                      intersector="bvh8"), device="cpu")
    acc = r.render_all()
    assert r.status == "idle" and r.frame == 3 and torch.isfinite(acc).all()
    assert float(acc.std()) > 0.0


def test_envsample_matches_jax():
    from tpu_pathtracer.ops import envsample as jenv
    from tpu_pathtracer_torch.ops import envsample as tenv

    rng = np.random.default_rng(8)
    rad = gradient_sky(16, 32)
    d = rng.normal(size=(4096, 3)).astype(np.float32) * 1.3  # non-unit, as after a bounce
    uv_j = jenv.env_uv_from_ray(jnp.asarray(d), jnp.float32(0.7))
    uv_t = tenv.env_uv_from_ray(torch.from_numpy(d), torch.tensor(np.float32(0.7)))
    np.testing.assert_allclose(uv_t.numpy(), np.asarray(uv_j), atol=1e-6)
    uv = rng.uniform(-0.1, 1.1, (4096, 2)).astype(np.float32)  # includes clamped edges
    patches_t = tenv.pack_env_patches(torch.from_numpy(rad))
    np.testing.assert_array_equal(patches_t.numpy(),
                                  np.asarray(jenv.pack_env_patches(jnp.asarray(rad))))
    want = np.asarray(jenv.sample_bilinear(jnp.asarray(rad), jnp.asarray(uv)))
    np.testing.assert_allclose(tenv.sample_bilinear(torch.from_numpy(rad),
                                                    torch.from_numpy(uv)).numpy(),
                               want, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        tenv.env_radiance_packed(patches_t, rad.shape[:2], torch.from_numpy(uv)).numpy(),
        want, rtol=1e-6, atol=1e-6)
