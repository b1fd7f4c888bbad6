"""Port parity: the differentiable render, its gradients and inverse rendering.

The scene is tests/test_diff.py's (a white plane and a red box under a
16x32 gradient sky, 12x12 pixels, 2 bounces), compiled by the JAX package
and carried across to the port leaf by leaf, so both packages trace the
same bytes.  The JAX side takes the plain loop through the Pallas kernel
in interpret mode (`intersector="mt_pallas"`) for frames and gradients,
and `diff.invert` (optax) for the optimiser.  Tolerances:

  * frames: rtol 1e-5 / atol 1e-6, the reference's own bound between its
    fused and plain loops (tests/test_mt_shade.py:256);
  * gradients against `jax.grad`: rtol 1e-3 / atol 1e-6 (the gathers'
    backward sums in another order in each framework);
  * finite differences: tests/test_diff.py's eps and tolerances;
  * the first 5 `invert` losses against optax's Adam: rtol 1e-4.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_pathtracer import diff as jdiff
from tpu_pathtracer.ops import trace as jtrace
from tpu_pathtracer.ops.intersect import replay_hit as j_replay_hit
from tpu_pathtracer.ops.mt_matmul import mt_intersect as j_mt_intersect
from tpu_pathtracer.scene import primitives
from tpu_pathtracer.scene.envmap import gradient_sky
from tpu_pathtracer.scene.host import Material, Mesh, Scene, rotation_x, translation
from tpu_pathtracer.scene.types import Camera as JCamera
from tpu_pathtracer.scene.types import RenderParams as JParams
import tpu_pathtracer_torch as tpt
from tpu_pathtracer_torch import diff as tdiff
from tpu_pathtracer_torch.ops import trace as ttrace
from tpu_pathtracer_torch.ops.intersect import Hit, replay_hit
from tpu_pathtracer_torch.scene.convert import leaves_to_numpy, scene_from_numpy, values_to_numpy

W = H = 12
KW = dict(width=W, height=H, aspect=1.0, samples_per_frame=1, max_bounces=2)
LOSS_KW = {k: KW[k] for k in ("width", "height", "aspect", "samples_per_frame", "max_bounces")}
CAM = dict(position=(0, 1, 4), look_at=(0, 0.5, 0), fov=45)
GRAD_PATHS = ["materials.color", "materials.emission_strength", "env.radiance", "camera.fov",
              "camera.position", "packed.tri_pos"]


def _jax_leaves(sd):
    return {f"{group}.{f.name}": np.asarray(getattr(getattr(sd, group), f.name))
            for group in ("triangles", "materials", "bvh", "links", "packed", "env")
            for f in dataclasses.fields(getattr(sd, group))}


@pytest.fixture(scope="module")
def scenes():
    """(JAX scene, port scene): tests/test_diff.py's scene."""
    red = Material(color=(0.8, 0.2, 0.2), roughness=1.0, metalness=0.0)
    white = Material(color=(0.9, 0.9, 0.9), roughness=0.6, metalness=0.3)
    sc = Scene()
    p, n, i = primitives.plane(4, 4)
    sc.add(Mesh(p, n, i, white, transform=rotation_x(-math.pi / 2)))
    p, n, i = primitives.box(0.8, 0.8, 0.8)
    sc.add(Mesh(p, n, i, red, transform=translation(0, 0.4, 0)))
    sc.set_environment(gradient_sky(16, 32))
    jsd = sc.compile()
    return jsd, scene_from_numpy(_jax_leaves(jsd), device="cpu")


def _jparams(frame=1):
    return JParams.create(JCamera.create(**CAM), frame=frame)


def _tparams(frame=1):
    return tpt.RenderParams.create(tpt.Camera.create(**CAM), frame=frame)


@pytest.fixture(scope="module")
def target(scenes):
    """The port's differentiable frame of the true scene."""
    return tdiff.render_frame_diff(scenes[1], _tparams(), **KW).detach()


# --- replay_hit ---------------------------------------------------------------


def test_replay_hit_values_and_vjp_match_jax():
    """Values and the vector-Jacobian product with respect to the vertex
    rows and the rays, on hit and miss lanes (misses contribute nothing
    and every gradient is finite)."""
    rng = np.random.default_rng(21)
    v0 = rng.uniform(-1, 1, (200, 3))
    e = rng.uniform(-0.3, 0.3, (200, 2, 3))
    tri = np.concatenate([v0, v0 + e[:, 0], v0 + e[:, 1]], axis=1).astype(np.float32)
    ro = rng.uniform(-1, 1, (400, 3)).astype(np.float32)
    rd = rng.normal(size=(400, 3))
    rd = (rd / np.linalg.norm(rd, axis=1, keepdims=True)).astype(np.float32)
    jh = j_mt_intersect(jnp.asarray(tri), jnp.asarray(ro), jnp.asarray(rd))
    hit = np.asarray(jh.hit)
    assert 50 < hit.sum() < 350  # both kinds of lane
    cot = [rng.normal(size=400).astype(np.float32) for _ in range(3)]

    def j_tuv(tp, o, d):
        h = j_replay_hit(tp, o, d, jh)
        return h.t, h.u, h.v

    j_out, vjp = jax.vjp(j_tuv, jnp.asarray(tri), jnp.asarray(ro), jnp.asarray(rd))
    j_grads = vjp(tuple(jnp.asarray(c) for c in cot))

    inputs = [torch.from_numpy(x).requires_grad_(True) for x in (tri, ro, rd)]
    th = Hit(*(torch.from_numpy(np.array(x)) for x in jh))
    h = replay_hit(*inputs, th)
    sum(o * torch.from_numpy(c) for o, c in zip((h.t, h.u, h.v), cot)).sum().backward()
    for a, b in zip((h.t, h.u, h.v), j_out):
        a, b = a.detach().numpy(), np.asarray(b)
        np.testing.assert_array_equal(a[~hit], b[~hit])  # INF / 0 on misses
        np.testing.assert_allclose(a[hit], b[hit], rtol=1e-5, atol=1e-6)
    for x, g in zip(inputs, j_grads):
        assert torch.isfinite(x.grad).all()
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(g), rtol=1e-4, atol=1e-5)
    assert (inputs[1].grad.numpy()[~hit] == 0).all() and (inputs[2].grad.numpy()[~hit] == 0).all()


# --- the plain loop and frames ------------------------------------------------


def test_trace_rays_matches_jax(scenes):
    """The plain loop on random rays with random seeds: the seed streams
    are bit-equal and the radiance agrees to rtol 1e-5 / atol 1e-6."""
    jsd, tsd = scenes
    rng = np.random.default_rng(3)
    ro = rng.uniform(-2, 2, (256, 3)).astype(np.float32)
    rd = rng.normal(size=(256, 3))
    rd = (rd / np.linalg.norm(rd, axis=1, keepdims=True)).astype(np.float32)
    seed = rng.integers(0, 2**31, 256).astype(np.uint32)
    inc_j, seed_j = jtrace.trace_rays(jsd, _jparams(), jnp.asarray(ro), jnp.asarray(rd),
                                      jnp.asarray(seed), max_bounces=3, intersector="mt_pallas")
    inc_t, seed_t = ttrace.trace_rays(tsd, _tparams(), torch.from_numpy(ro),
                                      torch.from_numpy(rd),
                                      torch.from_numpy(seed.astype(np.int64)), max_bounces=3)
    np.testing.assert_array_equal(seed_t.numpy().astype(np.uint32), np.asarray(seed_j))
    np.testing.assert_allclose(inc_t.numpy(), np.asarray(inc_j), rtol=1e-5, atol=1e-6)
    assert float(inc_t.abs().sum()) > 0


@pytest.mark.parametrize("kw", [dict(env_importance=True)], ids=["env_importance"])
def test_trace_rays_unported_options_raise(scenes, kw):
    """Env importance (which raised until it was ported) runs through the
    differentiable plain loop and matches JAX's: the seed streams bit-equal
    (two more draws on each miss), radiance to rtol 1e-5 / atol 1e-6."""
    jsd, tsd = scenes
    rng = np.random.default_rng(4)
    ro = rng.uniform(-2, 2, (256, 3)).astype(np.float32)
    rd = rng.normal(size=(256, 3))
    rd = (rd / np.linalg.norm(rd, axis=1, keepdims=True)).astype(np.float32)
    seed = rng.integers(0, 2**31, 256).astype(np.uint32)
    inc_j, seed_j = jtrace.trace_rays(jsd, _jparams(), jnp.asarray(ro), jnp.asarray(rd),
                                      jnp.asarray(seed), max_bounces=3, differentiable=True,
                                      intersector="mt_pallas", **kw)
    inc_t, seed_t = ttrace.trace_rays(tsd, _tparams(), torch.from_numpy(ro),
                                      torch.from_numpy(rd), torch.from_numpy(seed.astype(np.int64)),
                                      max_bounces=3, differentiable=True, **kw)
    np.testing.assert_array_equal(seed_t.numpy().astype(np.uint32), np.asarray(seed_j))
    np.testing.assert_allclose(inc_t.numpy(), np.asarray(inc_j), rtol=1e-5, atol=1e-6)
    assert float(inc_t.abs().sum()) > 0


def test_diff_frame_matches_jax_plain_loop(scenes, target):
    jsd, _ = scenes
    a = jtrace.render_frame(jsd, _jparams(), differentiable=True, intersector="mt_pallas", **KW)
    assert target.shape == (H, W, 3) and torch.isfinite(target).all()
    np.testing.assert_allclose(target.numpy(), np.asarray(a), rtol=1e-5, atol=1e-6)


def test_diff_frame_matches_fused_frame(scenes, target):
    """The differentiable path must not change the forward image
    (tests/test_diff.py::test_diff_forward_matches_nondiff)."""
    fused = ttrace.render_frame(scenes[1], _tparams(), **KW)
    np.testing.assert_allclose(fused.numpy(), target.numpy(), atol=1e-5, rtol=1e-5)


def test_diff_frame_is_the_same_under_every_cull(scenes, target, monkeypatch):
    """The three culling walks pick the same triangles, and the replay
    recomputes (t, u, v) from them, so the frames are equal."""
    for cull in ("list", "cond"):
        monkeypatch.setenv("TPT_CULL", cull)
        assert torch.equal(tdiff.render_frame_diff(scenes[1], _tparams(), **KW), target)


# --- gradients ----------------------------------------------------------------


def _grad_target(target):
    return 0.8 * torch.roll(target, 1, dims=0)  # away from the optimum, camera included


@pytest.fixture(scope="module")
def jax_grads(scenes, target):
    """One `jax.grad` over every compared leaf, through the Pallas kernel."""
    jsd, _ = scenes
    tgt = jnp.asarray(_grad_target(target).numpy())

    def loss_p(values):
        s, p = jdiff.insert(jsd, _jparams(), values)
        img = jtrace.render_frame(s, p, differentiable=True, intersector="mt_pallas", **KW)
        return jdiff.l2_image_loss(img, tgt)

    g = jax.grad(loss_p)(jdiff.extract(jsd, _jparams(), GRAD_PATHS))
    return {k: np.asarray(v) for k, v in g.items()}


@pytest.fixture(scope="module")
def port_grads(scenes, target):
    loss = tdiff.make_loss(_grad_target(target), **LOSS_KW)
    gs, gp = tdiff.grads(loss, scenes[1], _tparams())
    return {**leaves_to_numpy(gs), **leaves_to_numpy(gp)}


def test_grads_cover_every_float_leaf(scenes, port_grads):
    """Float leaves get a finite gradient of their own shape; integer
    leaves (material indices, `tri_perm`, the host frame number) get None."""
    values = {**leaves_to_numpy(scenes[1]), **leaves_to_numpy(_tparams())}
    assert set(port_grads) == set(values)
    for path, value in values.items():
        g = port_grads[path]
        if np.issubdtype(np.asarray(value).dtype, np.floating):
            assert g.shape == np.shape(value) and np.isfinite(g).all(), path
        else:
            assert g is None, path
    assert np.abs(port_grads["materials.color"]).max() > 0


@pytest.mark.parametrize("path", GRAD_PATHS)
def test_grads_match_jax(path, jax_grads, port_grads):
    got, want = port_grads[path], jax_grads[path]
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-6, err_msg=path)


def test_env_importance_grads_match_jax(scenes, target):
    """The gradient of the loss of `render_frame_diff(env_importance=True)`
    against `jax.grad` of the same loss, over the compared leaves, at the
    file's gradient tolerance (rtol 1e-3 / atol 1e-6)."""
    jsd, tsd = scenes
    tgt = _grad_target(target)
    jtgt = jnp.asarray(tgt.numpy())

    def jloss(values):
        s, p = jdiff.insert(jsd, _jparams(), values)
        img = jtrace.render_frame(s, p, differentiable=True, intersector="mt_pallas",
                                  env_importance=True, **KW)
        return jdiff.l2_image_loss(img, jtgt)

    want = jax.grad(jloss)(jdiff.extract(jsd, _jparams(), GRAD_PATHS))

    def loss(scene, params):
        return tdiff.l2_image_loss(
            tdiff.render_frame_diff(scene, params, env_importance=True, **LOSS_KW), tgt)

    gs, gp = tdiff.grads(loss, tsd, _tparams())
    got = {**leaves_to_numpy(gs), **leaves_to_numpy(gp)}
    for path in GRAD_PATHS:
        assert np.isfinite(got[path]).all(), path
        np.testing.assert_allclose(got[path], np.asarray(want[path]), rtol=1e-3, atol=1e-6,
                                   err_msg=path)
    assert np.abs(got["env.radiance"]).max() > 0


def _jax_tree_leaves(tree, prefix=""):
    """A JAX gradient tree (scene or params) as numpy arrays keyed by path."""
    out = {}
    for f in dataclasses.fields(tree):
        value = getattr(tree, f.name)
        if dataclasses.is_dataclass(value):
            out.update(_jax_tree_leaves(value, f"{prefix}{f.name}."))
        else:
            out[f"{prefix}{f.name}"] = np.asarray(value)
    return out


@pytest.mark.parametrize("intersector", ["bvh", "bvh8"])
def test_grads_through_bvh_walks_match_jax(scenes, target, intersector):
    """`diff.grads` with the triangles chosen by a BVH walk against
    `jax.grad` of the same loss, leaf by leaf over the whole scene and
    params: float leaves within rtol 1e-3 / atol 1e-6 (the BVH's float
    leaves, which only steer the detached walk, get zeros in both), integer
    leaves None where JAX gives float0."""
    jsd, tsd = scenes
    tgt = _grad_target(target)

    def jloss(s, p):
        img = jtrace.render_frame(s, p, differentiable=True, intersector=intersector, **KW)
        return jdiff.l2_image_loss(img, jnp.asarray(tgt.numpy()))

    jvalue, (jg_s, jg_p) = jax.value_and_grad(jloss, argnums=(0, 1), allow_int=True)(
        jsd, _jparams())
    loss = tdiff.make_loss(tgt, intersector=intersector, **LOSS_KW)
    np.testing.assert_allclose(float(loss(tsd, _tparams())), float(jvalue), rtol=1e-5)
    tg_s, tg_p = tdiff.grads(loss, tsd, _tparams())
    got = {**leaves_to_numpy(tg_s), **leaves_to_numpy(tg_p)}
    want = {**_jax_tree_leaves(jg_s), **_jax_tree_leaves(jg_p)}
    assert set(got) == set(want) and {"packed.nodes", "packed.fat_nodes", "bvh.node_min"} <= set(got)
    for path, g in got.items():
        if g is None:
            assert want[path].dtype == jax.dtypes.float0, path
            continue
        np.testing.assert_allclose(g, want[path], rtol=1e-3, atol=1e-6, err_msg=path)
    for path in ("packed.nodes", "packed.fat_nodes", "bvh.node_min", "links.node_max"):
        assert not got[path].any(), path
    assert np.abs(got["materials.color"]).max() > 0 and np.abs(got["env.radiance"]).max() > 0


def _fd_check(loss_p, values, path, idx, eps, atol, rtol):
    """Central finite difference on values[path].flat[idx] vs autograd
    (tests/test_diff.py::_fd_check)."""
    leaves = {k: v.detach().clone().requires_grad_(True) for k, v in values.items()}
    loss_p(leaves).backward()
    flat = values[path].detach().double().numpy().reshape(-1)
    shape = values[path].shape

    def eval_at(delta):
        v2 = flat.copy()
        v2[idx] += delta
        with torch.no_grad():
            return float(loss_p({**values, path: torch.from_numpy(
                v2.reshape(shape).astype(np.float32))}))

    fd = (eval_at(eps) - eval_at(-eps)) / (2 * eps)
    ad = float(leaves[path].grad.reshape(-1)[idx])
    assert math.isfinite(ad)
    assert abs(ad - fd) <= atol + rtol * abs(fd), (path, idx, ad, fd)
    return ad, fd


def _param_loss(scene, tgt, paths):
    loss = tdiff.make_loss(tgt, **LOSS_KW)
    return (tdiff.make_param_loss(loss, scene, _tparams(), paths),
            tdiff.extract(scene, _tparams(), paths))


def test_grad_material_color_fd(scenes, target):
    loss_p, values = _param_loss(scenes[1], target * 0.8, ["materials.color"])
    ad, _ = _fd_check(loss_p, values, "materials.color", 0, 1e-3, 1e-5, 5e-2)
    assert abs(ad) > 0


def test_grad_emission_fd(scenes, target):
    loss_p, values = _param_loss(scenes[1], target * 1.3, ["materials.emission_strength"])
    _fd_check(loss_p, values, "materials.emission_strength", 0, 1e-3, 1e-6, 5e-2)


def test_grad_env_radiance_fd(scenes, target):
    loss_p, values = _param_loss(scenes[1], target * 0.9, ["env.radiance"])
    leaves = {k: v.clone().requires_grad_(True) for k, v in values.items()}
    loss_p(leaves).backward()
    g = leaves["env.radiance"].grad.numpy()
    assert np.isfinite(g).all() and np.abs(g).max() > 0
    _fd_check(loss_p, values, "env.radiance", int(np.abs(g).reshape(-1).argmax()), 1e-2, 1e-6,
              5e-2)


def test_grad_camera_fd(scenes, target):
    loss_p, values = _param_loss(scenes[1], torch.roll(target, 1, dims=0), ["camera.fov"])
    _fd_check(loss_p, values, "camera.fov", 0, 1e-3, 5e-4, 2e-1)


# --- inverse rendering ----------------------------------------------------------


def _wrong_box(scene, color):
    """The scene with the box's material (index 1) set to `color`."""
    if isinstance(scene.materials.color, torch.Tensor):
        wrong = scene.materials.color.clone()
        wrong[1] = torch.tensor(color)
    else:
        wrong = scene.materials.color.at[1].set(jnp.array(color))
    return dataclasses.replace(scene, materials=dataclasses.replace(scene.materials, color=wrong))


def test_invert_losses_match_optax(scenes, target):
    """The first 5 steps of the port's Adam against optax's on the same
    problem: the losses agree to rtol 1e-4.  Each package fits its own
    render of the true scene: against the other's, the plane's color would
    see a roundoff-level gradient (~1e-8), which Adam's normalised step
    turns into a full learning-rate step."""
    jsd, tsd = scenes
    wrong = (0.2, 0.7, 0.4)
    jres = jdiff.invert(_wrong_box(jsd, wrong), _jparams(),
                        jdiff.render_frame_diff(jsd, _jparams(), **KW),
                        ["materials.color"], steps=5, learning_rate=5e-2, **LOSS_KW)
    tres = tdiff.invert(_wrong_box(tsd, wrong), _tparams(), target, ["materials.color"],
                        steps=5, learning_rate=5e-2, **LOSS_KW)
    assert len(tres.losses) == 5 and tres.final_loss == tres.losses[-1]
    np.testing.assert_allclose(tres.losses, jres.losses, rtol=1e-4)
    np.testing.assert_allclose(values_to_numpy(tres.values)["materials.color"],
                               np.asarray(jres.values["materials.color"]), rtol=1e-4, atol=1e-6)


def test_invert_recovers_material_color(scenes, target):
    """tests/test_diff.py::test_invert_recovers_material_color on the port."""
    tsd = scenes[1]
    res = tdiff.invert(_wrong_box(tsd, (0.2, 0.7, 0.4)), _tparams(), target,
                       ["materials.color"], steps=60, learning_rate=5e-2, **LOSS_KW)
    assert res.losses[-1] < res.losses[0] * 0.05, res.losses[::10]
    rec = res.values["materials.color"].numpy()
    true_color = tsd.materials.color.numpy()
    assert np.abs(rec[1] - true_color[1]).max() < 0.1, (rec[1], true_color[1])


def test_leaf_helpers_are_functional(scenes):
    """get_leaf / set_leaf / extract / insert name leaves by the JAX
    package's paths and leave their inputs unchanged."""
    tsd = scenes[1]
    params = _tparams()
    values = tdiff.extract(tsd, params, ["materials.color", "camera.fov", "env_intensity"])
    assert list(values) == ["materials.color", "camera.fov", "env_intensity"]
    assert values["camera.fov"] is tdiff.get_leaf(params, "camera.fov")
    s2, p2 = tdiff.insert(tsd, params, {"materials.color": values["materials.color"] * 0,
                                        "camera.fov": torch.tensor(30.0)})
    assert float(p2.camera.fov) == 30.0 and float(params.camera.fov) == 45.0
    assert float(s2.materials.color.abs().sum()) == 0.0 and float(tsd.materials.color.sum()) > 0
    assert s2.packed is tsd.packed and p2.env_rotation is params.env_rotation
    assert tdiff.set_leaf(params, "frame", 7).frame == 7 and params.frame == 1
