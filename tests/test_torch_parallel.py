"""Port parity: the sharding layer's pieces that run in one process.

  * the band hooks of `render_frame` (`row_offset`, `full_height`,
    `seed_salt`): pixel coordinates, uvs and seeds bit-equal to the JAX
    package's formula; the band's radiance against JAX's `render_frame`
    with the same arguments (both through the fused loop) within rtol 1e-5
    / atol 1e-6, but for the pixels that take another random branch (the
    outlier rule's at most 1%: 1 of 512 pixels for row offset 0, none for
    16, 2 for the salted band at offset 8);
  * tile composites equal the unsharded frame bit for bit, through the
    plain loop ('mt', and differentiable=True) and through the fused loop
    with TPT_SORT_WINDOW=32, so that every band sorts in 8 or more windows
    (no near-tie falls another way at this size: 0 pixels differ);
  * the sample axis's semantics (JAX's test_tile_and_sample_sharding,
    test_sample_axis_psum_mean_semantics and
    test_sample_shard_estimator_converges_to_sequential) on the mesh
    positions' frames (`sharded.shard_frame`) put together in process;
  * the port's 4x2 composite against JAX's `make_sharded_frame_step` on
    the 8-virtual-device mesh, under the outlier rule;
  * the port's loss and gradients on the (1, 1) mesh and over 4 tiles
    (each tile's share summed here, where the ranks' all-reduce would sum
    it) against JAX's `make_sharded_value_and_grad` on 4 virtual devices,
    on the same scene bytes;
  * mesh validation, the (1, 1) mesh (every sharded function is the
    unsharded one), `ShardConfig` field for field, and the back end that
    `multihost.initialize` picks for a rank's device.

The collectives themselves run in tests/test_torch_parallel_dist.py."""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu_pathtracer as jpt
from tpu_pathtracer import diff as jdiff
from tpu_pathtracer.config import ShardConfig as JShardConfig
from tpu_pathtracer.ops import rng as jrng
from tpu_pathtracer.ops import trace as jtrace
from tpu_pathtracer.parallel import make_mesh as j_make_mesh
from tpu_pathtracer.parallel import make_sharded_frame_step as j_make_sharded_frame_step
from tpu_pathtracer.parallel import zeros_acc as j_zeros_acc
from tpu_pathtracer.parallel.diffshard import make_sharded_value_and_grad as j_make_sharded_vg
from tpu_pathtracer.parallel.diffshard import target_sharding as j_target_sharding
from tpu_pathtracer.scene import host as jhost
from tpu_pathtracer.scene import primitives as jprimitives
from tpu_pathtracer.scene.envmap import gradient_sky as j_gradient_sky
import tpu_pathtracer_torch as tpt
from tpu_pathtracer_torch import diff
from tpu_pathtracer_torch.ops import trace as ttrace
from tpu_pathtracer_torch.parallel import (
    make_mesh,
    make_sharded_frame_step,
    make_sharded_render_all,
    make_sharded_value_and_grad,
    single_device_mesh,
    zeros_acc,
)
from tpu_pathtracer_torch.parallel import diffshard, multihost
from tpu_pathtracer_torch.parallel.mesh import Mesh
from tpu_pathtracer_torch.parallel.sharded import _SALT, assemble, shard_frame
from tpu_pathtracer_torch.render.renderer import make_frame_step
from tpu_pathtracer_torch.scene import primitives
from tpu_pathtracer_torch.scene.convert import scene_from_numpy
from tpu_pathtracer_torch.scene.envmap import gradient_sky
from tpu_pathtracer_torch.scene.host import Material, Mesh as SceneMesh, Scene
from tpu_pathtracer_torch.scene.host import rotation_x, translation

CAM = dict(position=(0, 1, 4), look_at=(0, 0.5, 0), fov=45)
W = H = 32
KW = dict(width=W, aspect=1.0, samples_per_frame=1, max_bounces=2)


def outliers(a, b, outlier_tol=0.05):
    """tests/test_trace_golden.py:60-70: pixels whose channels differ by
    more than 0.05 (another random branch), and the mean difference of the
    others."""
    d = np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))
    out = d.max(axis=-1) > outlier_tol
    return out, (d[~out].mean() if (~out).any() else 0.0)


@pytest.fixture(scope="module")
def scenes():
    return (jpt.default_scene(j_gradient_sky(16, 32)).compile(),
            tpt.default_scene(gradient_sky(16, 32)).compile(device="cpu"))


@pytest.fixture(scope="module")
def box_scene():
    """tests/test_parallel.py's fixture: a plane and a box, one material."""
    white = Material(color=(1, 1, 1), roughness=1.0, metalness=0.0)
    sc = Scene()
    p, n, i = primitives.plane(4, 4)
    sc.add(SceneMesh(p, n, i, white, transform=rotation_x(-math.pi / 2)))
    p, n, i = primitives.box(0.8, 0.8, 0.8)
    sc.add(SceneMesh(p, n, i, white, transform=translation(0, 0.4, 0)))
    sc.set_environment(gradient_sky(16, 32))
    return sc.compile(device="cpu")


def _params(frame=1):
    return tpt.RenderParams.create(tpt.Camera.create(**CAM), frame=frame)


def _jparams(frame=1):
    return jpt.RenderParams.create(jpt.Camera.create(**CAM), frame=frame)


def composite(scene, params, tiles, samples, **kw):
    """The sharded frame put together in process: each tile's band, the
    mean of its sample shards' frames."""
    bands = []
    for t in range(tiles):
        shards = [shard_frame(scene, params, tile=t, sample=s, tiles=tiles, samples=samples, **kw)
                  for s in range(samples)]
        bands.append(sum(shards[1:], shards[0]) / float(np.float32(samples)))
    return torch.cat(bands)


# --- the band hooks against JAX ---------------------------------------------


@pytest.mark.parametrize("blocked", [True, False], ids=["blocked", "row_major"])
@pytest.mark.parametrize("row_offset,salt", [(0, None), (16, None), (8, _SALT), (24, 7 * _SALT)])
def test_band_pixels_match_jax(blocked, row_offset, salt):
    """xs, ys (global), uvs and seeds of a 16-row band of a 32-row image are
    JAX `render_frame`'s (`tpu_pathtracer/ops/trace.py:966-989`), seeds
    bit for bit, salt wrapping mod 2**32."""
    rows, frame = 16, 3
    if blocked:
        jxs, jys = jtrace.blocked_pixel_grid(rows, W)
    else:
        jxs = jax.lax.broadcasted_iota(jnp.int32, (rows, W), 1).reshape(-1)
        jys = jax.lax.broadcasted_iota(jnp.int32, (rows, W), 0).reshape(-1)
    jys = jys + row_offset
    juv = np.stack([np.asarray(jxs, np.float32) / np.float32(W),
                    np.asarray(jys, np.float32) / np.float32(H)], axis=-1)
    jseed = jrng.pixel_seed(jxs + jys * W, np.uint32(frame))
    if salt is not None:
        jseed = jseed + jnp.asarray(np.uint32(salt & 0xFFFFFFFF))
    xs, ys, uv, seed = ttrace.band_pixels(W, rows, frame, row_offset=row_offset, full_height=H,
                                          seed_salt=salt, blocked=blocked)
    np.testing.assert_array_equal(xs.numpy(), np.asarray(jxs))
    np.testing.assert_array_equal(ys.numpy(), np.asarray(jys))
    np.testing.assert_array_equal(uv.numpy(), juv)
    np.testing.assert_array_equal(seed.numpy().astype(np.uint32), np.asarray(jseed))


@pytest.mark.parametrize("row_offset,salt", [(0, None), (16, None), (8, _SALT)])
def test_band_frame_matches_jax(scenes, row_offset, salt):
    """A band's radiance through the fused loop, against JAX's fused loop
    (the Pallas kernel in interpret mode, outside shard_map) with the same
    band arguments: within rtol 1e-5 / atol 1e-6 on every pixel but those
    that take another random branch (outliers of the rule, under 1%)."""
    jsd, tsd = scenes
    a = np.asarray(jtrace.render_frame(
        jsd, _jparams(2), height=16, row_offset=row_offset, full_height=H,
        seed_salt=None if salt is None else np.uint32(salt), intersector="mt_pallas", **KW))
    b = ttrace.render_frame(tsd, _params(2), height=16, row_offset=row_offset, full_height=H,
                            seed_salt=salt, **KW).numpy()
    far = (np.abs(b - a) > 1e-6 + 1e-5 * np.abs(a)).any(axis=-1)
    out, _ = outliers(a, b)
    assert far.mean() < 0.01 and (far == out).all(), (int(far.sum()), int(out.sum()))


# --- tile composites against the unsharded frame ----------------------------


@pytest.mark.parametrize("tiles", [2, 4])
@pytest.mark.parametrize("kind", ["mt", "differentiable", "fused"])
def test_tile_composite_is_the_unsharded_frame(scenes, monkeypatch, tiles, kind):
    """Bands in global coordinates put together give the unsharded frame
    bit for bit.  The fused bands sort in 8 or more windows of 32 rays."""
    monkeypatch.setenv("TPT_SORT_WINDOW", "32")
    tsd = scenes[1]
    kw = dict(KW, intersector="mt" if kind == "mt" else "auto",
              differentiable=kind == "differentiable")
    rows = H // tiles
    if kind == "fused":
        assert rows * W // 32 >= 8
    bands = [ttrace.render_frame(tsd, _params(2), height=rows, row_offset=t * rows,
                                 full_height=H, **kw) for t in range(tiles)]
    full = ttrace.render_frame(tsd, _params(2), height=H, **kw)
    assert torch.equal(torch.cat(bands), full)


# --- the sample axis ----------------------------------------------------------


def test_sample_shard_zero_keeps_the_reference_stream(scenes):
    tsd = scenes[1]
    s0 = shard_frame(tsd, _params(), tile=1, sample=0, tiles=2, samples=2, height=H,
                     **dict(KW, samples_per_frame=2))
    band = ttrace.render_frame(tsd, _params(), height=16, row_offset=16, full_height=H, **KW)
    s1 = shard_frame(tsd, _params(), tile=1, sample=1, tiles=2, samples=2, height=H,
                     **dict(KW, samples_per_frame=2))
    assert torch.equal(s0, band) and not torch.equal(s1, band)


def test_tile_and_sample_sharding(box_scene):
    kw = dict(width=16, height=16, aspect=1.0, max_bounces=2, intersector="mt")
    got = composite(box_scene, _params(), 4, 2, samples_per_frame=4, **kw).numpy()
    ref = ttrace.render_frame(box_scene, _params(), samples_per_frame=4, **kw).numpy()
    assert got.shape == ref.shape and np.isfinite(got).all()
    assert abs(got.mean() - ref.mean()) < 0.15
    assert np.abs(got - ref).mean() < 0.35


def test_sample_axis_psum_mean_semantics(box_scene):
    kw = dict(width=16, height=16, aspect=1.0, max_bounces=2, intersector="mt",
              samples_per_frame=8)
    got = composite(box_scene, _params(), 1, 8, **kw).numpy()
    ref = ttrace.render_frame(box_scene, _params(), **kw).numpy()
    assert np.isfinite(got).all()
    assert abs(got.mean() - ref.mean()) < 0.1


def test_sample_shard_estimator_converges_to_sequential(box_scene):
    """The sample-sharded estimator converges to the sequential one's
    converged image: a bias in the salted streams would leave a gap that
    no frame count shrinks."""
    kw = dict(width=16, height=16, aspect=1.0, max_bounces=2, intersector="mt",
              samples_per_frame=4)

    def mean(frames, render):
        acc = torch.zeros((16, 16, 3))
        for f in range(1, frames + 1):
            ttrace.accumulate(acc, render(_params(f)), f, out=acc)
        return acc.numpy().astype(np.float64)

    truth = mean(96, lambda p: ttrace.render_frame(box_scene, p, **kw))
    errs = [np.abs(mean(n, lambda p: composite(box_scene, p, 1, 4, **kw)) - truth).mean()
            for n in (6, 48)]
    assert errs[1] < errs[0] * 0.55, errs
    assert errs[1] < 0.15, errs


# --- against JAX's sharded step ---------------------------------------------


def test_composite_matches_jax_sharded_step(scenes):
    """The port's 4x2 composite against JAX's make_sharded_frame_step on a
    (4, 2) mesh of virtual CPU devices (its XLA loop: JAX leaves the fused
    path under shard_map on the CPU), under the outlier rule."""
    jsd, tsd = scenes
    mesh = j_make_mesh(tiles=4, samples=2)
    step = j_make_sharded_frame_step(mesh, width=W, height=H, aspect=1.0, samples_per_frame=2,
                                     max_bounces=2)
    a = np.asarray(step(jsd, _jparams(), j_zeros_acc(mesh, H, W)))
    b = composite(tsd, _params(), 4, 2, height=H, **dict(KW, samples_per_frame=2)).numpy()
    out, agree = outliers(a, b)
    assert out.mean() < 0.01 and agree < 1e-4, (int(out.sum()), agree)


@pytest.fixture(scope="module")
def carried():
    """(JAX scene, the port's copy of its bytes, leaf by leaf):
    tests/test_diff.py's red box and white plane, carried across as
    tests/test_torch_diff.py carries it, where both packages' frames agree
    on every pixel (the default scene's differ on 2 of 32x32 pixels, a
    random branch taken the other way, which the gradients would feel)."""
    red = jhost.Material(color=(0.8, 0.2, 0.2), roughness=1.0, metalness=0.0)
    white = jhost.Material(color=(0.9, 0.9, 0.9), roughness=0.6, metalness=0.3)
    sc = jhost.Scene()
    p, n, i = jprimitives.plane(4, 4)
    sc.add(jhost.Mesh(p, n, i, white, transform=jhost.rotation_x(-math.pi / 2)))
    p, n, i = jprimitives.box(0.8, 0.8, 0.8)
    sc.add(jhost.Mesh(p, n, i, red, transform=jhost.translation(0, 0.4, 0)))
    sc.set_environment(j_gradient_sky(16, 32))
    jsd = sc.compile()
    leaves = {f"{group}.{f.name}": np.asarray(getattr(getattr(jsd, group), f.name))
              for group in ("triangles", "materials", "bvh", "links", "packed", "env")
              for f in dataclasses.fields(getattr(jsd, group))}
    return jsd, scene_from_numpy(leaves, device="cpu")


def test_sharded_grads_match_jax_sharded_value_and_grad(carried, monkeypatch):
    """The port's loss and gradients, on the (1, 1) mesh and over 4 tiles,
    against JAX's make_sharded_value_and_grad over 4 tiles of virtual CPU
    devices: loss rtol 1e-5, gradients rtol 1e-4 / atol 1e-6.  The 4
    tiles' shares are each rank's own computation (its band's loss over
    the global W*H*3, its backward) with the all-reduce left out and the
    sum taken here."""
    jsd, tsd = carried
    paths = ["materials.color", "env.radiance"]
    kw = dict(KW, height=H)
    target = diff.render_frame_diff(tsd, _params(), **kw).detach() * 0.7
    jmesh = j_make_mesh(tiles=4, samples=1)
    jl, jg = j_make_sharded_vg(jmesh, jsd, _jparams(), **kw)(
        jdiff.extract(jsd, _jparams(), paths),
        jax.device_put(jnp.asarray(target.numpy()), j_target_sharding(jmesh)))
    values = diff.extract(tsd, _params(), paths)
    one = make_sharded_value_and_grad(single_device_mesh(device="cpu"), tsd, _params(), **kw)
    monkeypatch.setattr(diffshard.dist, "all_reduce", lambda *a, **k: None)
    shares = [make_sharded_value_and_grad(Mesh(tiles=4, samples=1, rank=t), tsd, _params(),
                                          **kw)(values, target) for t in range(4)]
    tiles4 = (sum(l for l, _ in shares), {p: sum(g[p] for _, g in shares) for p in paths})
    for loss, grads in (one(values, target), tiles4):
        np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
        for p in paths:
            assert np.abs(np.asarray(jg[p])).max() > 1e-4, p
            np.testing.assert_allclose(grads[p].numpy(), np.asarray(jg[p]), rtol=1e-4,
                                       atol=1e-6, err_msg=p)


# --- the mesh ----------------------------------------------------------------


def test_mesh_validation():
    with pytest.raises(ValueError, match="needs 15 ranks"):
        make_mesh(tiles=5, samples=3)
    with pytest.raises(ValueError, match="torchrun"):
        make_mesh(tiles=2, samples=1, device="cpu")
    mesh = Mesh(tiles=8, samples=1)
    with pytest.raises(ValueError, match="must divide by tile axis"):
        make_sharded_frame_step(mesh, width=W, height=12, aspect=1.0)
    with pytest.raises(ValueError, match="must divide by sample axis"):
        make_sharded_frame_step(Mesh(tiles=1, samples=2), width=W, height=H, aspect=1.0,
                                samples_per_frame=3)
    with pytest.raises(ValueError, match="outside"):
        make_sharded_frame_step(Mesh(tiles=2, samples=1, rank=2), width=W, height=H, aspect=1.0)
    m = make_mesh(device="cpu")
    assert (m.shape, m.in_mesh, m.tile_index, m.sample_index) == (
        {"tiles": 1, "samples": 1}, True, 0, 0)


def test_single_device_mesh_is_unsharded(scenes):
    """On a (1, 1) mesh every sharded function is the unsharded one, bit
    for bit: the step, the whole budget, the assembled image and the loss
    and gradients."""
    tsd = scenes[1]
    mesh = single_device_mesh(device="cpu")
    kw = dict(KW, height=H)
    acc = make_sharded_frame_step(mesh, **kw)(tsd, _params(), zeros_acc(mesh, H, W))
    want = torch.zeros((H, W, 3))
    make_frame_step(W, H, 1.0, 1, 2, True)(tsd, _params(), want)
    assert torch.equal(assemble(mesh, acc, H), want)

    # frames 1 and 2 (render_all ignores params0's frame, as in JAX)
    got = make_sharded_render_all(mesh, frames=2, **kw)(tsd, _params(5))
    make_frame_step(W, H, 1.0, 1, 2, True)(tsd, _params(2), want)
    assert torch.equal(got, want)

    paths = ["materials.color", "env.radiance"]
    target = diff.render_frame_diff(tsd, _params(), **kw).detach() * 0.7
    values = diff.extract(tsd, _params(), paths)
    loss, grads = make_sharded_value_and_grad(mesh, tsd, _params(), **kw)(values, target)
    ref = diff.make_param_loss(diff.make_loss(target, **kw), tsd, _params(), paths)
    leaves = {k: v.detach().clone().requires_grad_(True) for k, v in values.items()}
    l_ref = ref(leaves)
    g_ref = torch.autograd.grad(l_ref, list(leaves.values()))
    np.testing.assert_allclose(float(loss), float(l_ref.detach()), rtol=1e-5)
    for p, g in zip(paths, g_ref):
        np.testing.assert_allclose(grads[p].numpy(), g.numpy(), rtol=1e-4, atol=1e-6, err_msg=p)


def test_shard_config_matches_jax():
    fields = [(f.name, f.default) for f in dataclasses.fields(tpt.ShardConfig)]
    assert fields == [(f.name, f.default) for f in dataclasses.fields(JShardConfig)]
    for tiles, samples in ((1, 1), (4, 2), (3, 1)):
        assert (tpt.ShardConfig(tiles, samples).num_devices
                == JShardConfig(tiles, samples).num_devices == tiles * samples)
    with pytest.raises(dataclasses.FrozenInstanceError):
        tpt.ShardConfig().tiles = 2


@pytest.mark.parametrize("device,local_ranks,cards,backend,want", [
    ("cpu", 1, 1, None, "gloo"),
    ("cuda", 1, 0, None, "gloo"),
    ("cuda", 2, 1, None, "gloo"),
    ("cuda", 1, 1, None, "nccl"),
    ("cuda", 2, 2, None, "nccl"),
    ("cuda", 1, 1, "gloo", "gloo"),
], ids=["cpu", "no_card", "sharing_a_card", "own_card", "a_card_each", "explicit"])
def test_initialize_picks_the_back_end_from_the_rank_device(monkeypatch, device, local_ranks,
                                                           cards, backend, want):
    """NCCL for a rank on a card of its own; gloo on the CPU or where this
    host's ranks outnumber its cards (CUDA stubbed, the group's start
    recorded); an explicit back end as given."""
    calls = []
    monkeypatch.setattr(multihost.dist, "is_initialized", lambda: False)
    monkeypatch.setattr(multihost.dist, "init_process_group",
                        lambda backend, **kw: calls.append((backend, kw)))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: cards > 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    monkeypatch.setattr(torch.cuda, "set_device", lambda d: None)
    monkeypatch.setenv("LOCAL_WORLD_SIZE", str(local_ranks))
    monkeypatch.setenv("LOCAL_RANK", "1")
    multihost.initialize(backend, "file:///unused", 2, 1, device=device)
    assert [c[0] for c in calls] == [want]
    if want == "nccl":
        assert calls[0][1]["device_id"] == torch.device("cuda", 1 % cards)
