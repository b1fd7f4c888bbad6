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


# Options that raised NotImplementedError until they were ported; each now
# renders, and matches the JAX package's frame with the same option (the
# test keeps its name and case ids).
UNPORTED = [
    ("env_importance", dict(env_importance=True)),
    ("blue_noise", dict(blue_noise=np.random.default_rng(2).random((4, 4, 2)).astype(np.float32))),
    ("sort_window", dict(sort_window=32)),
]


@pytest.mark.parametrize("name,kw", UNPORTED, ids=[u[0] for u in UNPORTED])
def test_unported_render_options_raise(scenes, name, kw):
    """Each option renders on the fused path at 16x16, 2 bounces, and
    matches JAX's frame by the outlier rule; the 8 windows of 32 rays give
    the image of one global sort bit for bit."""
    jsd, tsd = scenes
    kw = dict(width=16, height=16, aspect=1.0, max_bounces=2, **kw)
    a = jtrace.render_frame(jsd, jpt.RenderParams.create(jpt.Camera.create(**CAM), frame=2),
                            intersector="mt_pallas", **kw)
    params = tpt.RenderParams.create(tpt.Camera.create(**CAM), frame=2)
    b = ttrace.render_frame(tsd, params, **kw)
    assert b.shape == (16, 16, 3) and torch.isfinite(b).all() and float(b.max()) > 0
    assert_images_close(np.asarray(a), b.numpy())
    if name == "sort_window":
        assert torch.equal(b, ttrace.render_frame(tsd, params, **{**kw, "sort_window": 0}))


@pytest.mark.parametrize("env", [None, "0", "32"], ids=["unset", "zero", "nonzero"])
@pytest.mark.parametrize("entry", ["render_frame", "Renderer"])
def test_sort_window_variable_raises_when_nonzero(scenes, entry, env, monkeypatch):
    """TPT_SORT_WINDOW is read as JAX reads it (the override first, then the
    variable, then 32768), and the image does not depend on it: each
    resolution renders the image of one global sort (`sort_window=0`) bit
    for bit, at 16x16 (8 windows of 32)."""
    if env is None:
        monkeypatch.delenv("TPT_SORT_WINDOW", raising=False)
    else:
        monkeypatch.setenv("TPT_SORT_WINDOW", env)
    assert ttrace._sort_window() == jtrace._sort_window() == (32768 if env is None else int(env))
    assert ttrace._sort_window(0) == jtrace._sort_window(0) == 0
    cfg = dict(width=16, height=16, max_bounces=2)

    def run(window=None):
        if entry == "render_frame":
            params = tpt.RenderParams.create(tpt.Camera.create(**CAM), frame=1)
            return ttrace.render_frame(scenes[1], params, aspect=1.0, sort_window=window, **cfg)
        r = tpt.Renderer(tpt.default_scene(gradient_sky(8, 16)), tpt.Camera.create(**CAM),
                         tpt.RenderConfig(frames=1, sort_window=window, **cfg), device="cpu")
        return r.render_all()

    img = run()
    assert img.shape == (16, 16, 3) and torch.isfinite(img).all()
    assert torch.equal(img, run(window=0))


@pytest.mark.parametrize("kw", [dict(shard=tpt.ShardConfig(tiles=2)), dict(env_importance=True)],
                         ids=["shard", "env_importance"])
def test_unported_renderer_options_raise(kw):
    """Options that raised until they were ported.  Sharding over 2 tiles
    without a process group raises (it never renders unsharded in
    silence), and a (1, 1) mesh renders the unsharded frame; env importance
    renders what `render_frame(env_importance=True)` renders."""
    cfg = tpt.RenderConfig(width=8, height=8, frames=1, max_bounces=2)
    if "shard" in kw:
        with pytest.raises(ValueError, match="torchrun"):
            tpt.Renderer(tpt.default_scene(), tpt.Camera.create(), cfg, device="cpu", **kw)
        kw = dict(shard=tpt.ShardConfig(tiles=1, samples=1))
    r = tpt.Renderer(tpt.default_scene(gradient_sky(8, 16)), tpt.Camera.create(**CAM), cfg,
                     device="cpu", **kw)
    acc = r.render_all()
    want = ttrace.render_frame(r.scene_data, tpt.RenderParams.create(r.camera, frame=1),
                               width=8, height=8, aspect=1.0, max_bounces=2,
                               env_importance=r.env_importance)
    assert r.env_importance == ("env_importance" in kw) and torch.equal(acc, want)


# --- env importance sampling in the loops -----------------------------------


def _random_rays(n=512, seed=3):
    rs = np.random.default_rng(seed)
    ro = rs.uniform(-2, 2, (n, 3)).astype(np.float32)
    rd = rs.normal(size=(n, 3))
    rd = (rd / np.linalg.norm(rd, axis=1, keepdims=True)).astype(np.float32)
    return ro, rd, rs.integers(0, 2**31, n).astype(np.uint32)


def test_env_importance_fused_matches_plain(scenes):
    """The deferred env term of the fused loop draws what the plain loop
    draws in the bounce where a ray missed: seeds bit-equal, radiance to
    rtol 1e-5 / atol 1e-6 (the reference's fused-vs-plain bound), under a
    windowed sort too (8 windows of 64 rays)."""
    _, tsd = scenes
    ro, rd, seed = (torch.from_numpy(x) for x in _random_rays())
    seed = seed.to(torch.int64)
    params = tpt.RenderParams.create(tpt.Camera.create(**CAM), frame=2)
    inc_p, seed_p = ttrace.trace_rays(tsd, params, ro, rd, seed, max_bounces=3,
                                      env_importance=True)
    for window in (0, 64):
        inc_f, seed_f = ttrace.trace_rays_fused(
            tsd, params, ro, rd, seed, max_bounces=3, env_importance=True, sort_window=window,
            intersector_phi_fn=lambda phi: mt_shade.mt_intersect_nf_phi(tsd.packed.tri_pos, phi))
        assert torch.equal(seed_f, seed_p)
        np.testing.assert_allclose(inc_f.numpy(), inc_p.numpy(), rtol=1e-5, atol=1e-6)
    assert not torch.equal(seed_p, ttrace.trace_rays(tsd, params, ro, rd, seed,
                                                     max_bounces=3)[1])  # 2 more draws a miss


@pytest.mark.parametrize("differentiable", [False, True], ids=["fused", "plain"])
def test_env_importance_frame_matches_jax(scenes, differentiable):
    """8x8, 2 bounces: the port's frame against JAX's (its fused path
    through the Pallas kernel in interpret mode), rtol 1e-5 / atol 1e-6."""
    jsd, tsd = scenes
    kw = dict(width=8, height=8, aspect=1.0, max_bounces=2, env_importance=True,
              differentiable=differentiable)
    a = jtrace.render_frame(jsd, jpt.RenderParams.create(jpt.Camera.create(**CAM), frame=2),
                            intersector="mt_pallas", **kw)
    b = ttrace.render_frame(tsd, tpt.RenderParams.create(tpt.Camera.create(**CAM), frame=2), **kw)
    np.testing.assert_allclose(b.detach().numpy(), np.asarray(a), rtol=1e-5, atol=1e-6)


def test_env_importance_on_a_black_env_is_finite():
    """No light: the tables are uniform, the pdf floored; the frame is the
    emitters' alone, finite, on both loops."""
    data = tpt.default_scene(np.zeros((8, 16, 3), np.float32)).compile(device="cpu")
    params = tpt.RenderParams.create(tpt.Camera.create(**CAM), frame=1)
    kw = dict(width=8, height=8, aspect=1.0, max_bounces=2, env_importance=True)
    for differentiable in (False, True):
        img = ttrace.render_frame(data, params, differentiable=differentiable, **kw)
        assert torch.isfinite(img).all()


# --- the windowed binning sort ----------------------------------------------


WINDOW_KW = dict(width=256, height=128, aspect=2.0, max_bounces=2)


@pytest.fixture(scope="module")
def window_base():
    """A red box on a white plane (14 triangles, so that 32,768 rays stay
    cheap on the CPU) and its 256x128 frame of one global sort."""
    scene = tpt.Scene()
    scene.add(tpt.Mesh(*tpt.scene.primitives.plane(4, 4), tpt.Material(),
                       transform=tpt.scene.host.rotation_x(-np.pi / 2)))
    scene.add(tpt.Mesh(*tpt.scene.primitives.box(0.8, 0.8, 0.8),
                       tpt.Material(color=(0.8, 0.2, 0.2), metalness=0.5, roughness=0.3),
                       transform=tpt.scene.host.translation(0, 0.4, 0)))
    scene.set_environment(gradient_sky(8, 16))
    data = scene.compile(device="cpu")
    params = tpt.RenderParams.create(tpt.Camera.create(**CAM), frame=1)
    return data, params, ttrace.render_frame(data, params, sort_window=0, **WINDOW_KW)


@pytest.mark.parametrize("window", [0, 256, 4096, None])
def test_sort_window_images_are_bit_identical(window_base, window):
    """256x128 (32,768 rays): 128 windows of 256, 8 of 4,096 (the windowed
    branch), and the default 32,768 (one window: the global sort) render the
    image of window 0 bit for bit (tests/test_mt_shade.py:316-340)."""
    data, params, base = window_base
    img = ttrace.render_frame(data, params, sort_window=window, **WINDOW_KW)
    assert torch.equal(img, base) and float(img.max()) > 0 and float(img.std()) > 0


@pytest.mark.parametrize("r,window", [(4096, 256), (4096, 512), (4096, 1024), (4096, 0),
                                      (1000, 100), (4096, 3000)])
def test_windowed_sort_matches_jax(r, window):
    """Each window sorted on its own (no key leaves its window), and the
    global fallback exactly where JAX falls back (fewer than 8 windows, a
    window that does not divide R, W <= 0): the sorted keys equal JAX's."""
    key = np.random.default_rng(r + window).integers(0, 50, r).astype(np.int64)
    order = ttrace._windowed_sort(torch.from_numpy(key), window)
    (want,) = jtrace._windowed_sort((jnp.asarray(key.astype(np.int32)),), window)
    np.testing.assert_array_equal(key[order.numpy()], np.asarray(want))
    assert sorted(order.tolist()) == list(range(r))
    windowed = window > 0 and r % window == 0 and r // window >= 8
    if windowed:
        w = np.arange(r) // window
        np.testing.assert_array_equal(w[order.numpy()], w)


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


def test_port_tests_run_on_one_torch_thread():
    """The repository's conftest.py runs every test of a `test_torch_*`
    module on one torch thread, so the suite's parallel workers do not
    oversubscribe the cores."""
    assert torch.get_num_threads() == 1
