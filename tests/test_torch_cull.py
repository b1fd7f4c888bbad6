"""Port parity: the whole-scene MT wrapper's culling variants and options.

`mt_intersect_pallas2_phi` dispatches to the near-to-far ('nf'), list
('list') or in-kernel two-level ('cond') walk.  On the CPU each runs its
plain version, which is held here to the JAX Pallas kernels in interpret
mode on the soup of tests/test_mt_shade.py::test_pallas2_cull_modes_parity
(500 triangles, 900 rays, every 4th parked) at sub-treelets of 32, 64 and
128 triangles, with `assert_hit_parity`'s tolerances (equal hit masks and
triangles, t within rtol 5e-5, u/v within rtol 1e-3).  Miss lanes keep each
walk's initial t: -INF for parked lanes under 'nf', INF under 'list' and
'cond', as in JAX.

The option resolution (explicit argument, then TPT_CULL / TPT_SUB /
TPT_TILE_RAYS / TPT_SORT_BOUNCES / TPT_MXU_DETS, then the default) is held
to the JAX functions case by case, errors and their messages included.
The MXU-determinant variants are held to JAX in tests/test_torch_mxu.py.
The CUDA kernels themselves are compared with these plain versions in
tests/test_torch_cuda.py, on a machine with a card."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_pathtracer.ops import trace as jtrace
from tpu_pathtracer.ops.mt_matmul import mt_intersect as j_mt_intersect
from tpu_pathtracer.ops.mt_matmul import ray_features as j_ray_features
from tpu_pathtracer.ops.pallas import mt_shade as jshade
from tpu_pathtracer.ops.pallas.mt_intersect import _pad_to as j_pad_to
from tpu_pathtracer.ops.pallas.mt_intersect import treelet_boxes as j_treelet_boxes
import tpu_pathtracer as jpt
from tpu_pathtracer.scene.envmap import gradient_sky as j_gradient_sky
import tpu_pathtracer_torch as tpt
from tpu_pathtracer_torch.ops import trace as ttrace
from tpu_pathtracer_torch.ops.kernels import mt_shade
from tpu_pathtracer_torch.ops.mt_matmul import ray_features
from tpu_pathtracer_torch.ops.vecmath import INF
from tpu_pathtracer_torch.scene.envmap import gradient_sky


def assert_hit_parity(ha, hb, min_hits=30):
    """ha: JAX Hit; hb: port Hit (torch): tests/test_mt_shade.py's rule."""
    hb = [x.numpy() for x in hb]
    np.testing.assert_array_equal(hb[0], np.asarray(ha.hit))
    m = np.asarray(ha.hit)
    assert m.sum() >= min_hits
    np.testing.assert_array_equal(hb[2][m], np.asarray(ha.tri)[m])
    np.testing.assert_allclose(hb[1][m], np.asarray(ha.t)[m], rtol=5e-5, atol=1e-6)
    np.testing.assert_allclose(hb[3][m], np.asarray(ha.u)[m], rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(hb[4][m], np.asarray(ha.v)[m], rtol=1e-3, atol=1e-4)


@pytest.fixture(scope="module")
def soup():
    """tests/test_mt_shade.py::test_pallas2_cull_modes_parity's inputs."""
    rng = np.random.default_rng(11)
    v0 = rng.uniform(-1, 1, (500, 3))
    e = rng.uniform(-0.2, 0.2, (500, 2, 3))
    tri = np.concatenate([v0, v0 + e[:, 0], v0 + e[:, 1]], axis=1).astype(np.float32)
    ro = rng.uniform(-1, 1, (900, 3)).astype(np.float32)
    rd = rng.normal(size=(900, 3))
    rd = (rd / np.linalg.norm(rd, axis=1, keepdims=True)).astype(np.float32)
    park = np.arange(900) % 4 == 0
    ro = np.where(park[:, None], np.float32(1e30), ro).astype(np.float32)
    rd = np.where(park[:, None], np.float32(0.0), rd).astype(np.float32)
    return tri, ro, rd, park


@pytest.mark.parametrize("sub", [32, 64, 128])
@pytest.mark.parametrize("cull", ["nf", "list", "cond"])
def test_cull_plain_matches_pallas_interpret(soup, cull, sub):
    tri, ro, rd, park = soup
    phi_j = j_ray_features(jnp.asarray(ro), jnp.asarray(rd)).T
    ha = jshade.mt_intersect_pallas2_phi(jnp.asarray(tri), phi_j, interpret=True, cull=cull,
                                         sub=sub)
    phi_t = ray_features(torch.from_numpy(ro), torch.from_numpy(rd)).T.contiguous()
    hb = mt_shade.mt_intersect_pallas2_phi(torch.from_numpy(tri), phi_t, cull=cull, sub=sub)
    assert not hb.hit.numpy()[park].any()
    assert_hit_parity(ha, hb)
    # every miss lane keeps its walk's initial t, as in JAX
    miss = ~np.asarray(ha.hit)
    np.testing.assert_array_equal(hb.t.numpy()[miss], np.asarray(ha.t)[miss])
    want = -float(INF) if cull == "nf" else float(INF)
    assert (hb.t.numpy()[park] == np.float32(want)).all()


def test_ray_entry_point_and_oracle_agree(soup, monkeypatch):
    """`mt_intersect_pallas2(tri, ro, rd)` under TPT_CULL=list against the
    JAX entry point under the same setting and the XLA oracle."""
    tri, ro, rd, park = soup
    monkeypatch.setenv("TPT_CULL", "list")
    ha = jshade.mt_intersect_pallas2(jnp.asarray(tri), jnp.asarray(ro), jnp.asarray(rd),
                                     interpret=True)
    hb = mt_shade.mt_intersect_pallas2(torch.from_numpy(tri), torch.from_numpy(ro),
                                       torch.from_numpy(rd))
    assert_hit_parity(ha, hb)
    assert_hit_parity(j_mt_intersect(jnp.asarray(tri), jnp.asarray(ro), jnp.asarray(rd)), hb)
    hp = mt_shade.mt_intersect_pallas2_plain(torch.from_numpy(tri), torch.from_numpy(ro),
                                             torch.from_numpy(rd))
    assert all(torch.equal(a, b) for a, b in zip(hb, hp))
    assert (hb.t.numpy()[park] == np.float32(INF)).all()  # list: parked lanes start at INF


def _resolve_both(jfn, tfn, override, env_name, env, monkeypatch):
    """Each package's resolution of one option: (value or the exception's
    type and message) for JAX and for the port."""
    if env is None:
        monkeypatch.delenv(env_name, raising=False)
    else:
        monkeypatch.setenv(env_name, env)
    out = []
    for fn in (jfn, tfn):
        try:
            out.append(fn(override))
        except (ValueError, NotImplementedError) as exc:
            out.append((type(exc), str(exc)))
    return out


RESOLUTION_CASES = [
    # (option, override, environment value, expected)
    ("cull", None, None, "nf"),
    ("cull", None, "list", "list"),
    ("cull", None, "cond", "cond"),
    ("cull", "cond", "list", "cond"),
    ("cull", None, "bvh", ValueError),
    ("cull", "NF", None, ValueError),
    ("sub", None, None, 64),
    ("sub", None, "32", 32),
    ("sub", 128, "16", 128),
    ("sub", 8, None, 8),
    ("sub", None, "24", ValueError),   # a multiple of 8 that does not divide 128
    ("sub", 12, None, ValueError),
    ("sub", 256, None, ValueError),
    ("sub", 0, None, ValueError),
    ("tile_rays", None, None, 512),
    ("tile_rays", None, "256", 256),
    ("tile_rays", 384, "256", 384),
    ("tile_rays", None, "100", ValueError),
    ("tile_rays", 0, None, ValueError),
    ("tile_rays", -128, None, ValueError),
    ("sort_bounces", None, None, 2),
    ("sort_bounces", None, "0", 0),
    ("sort_bounces", 3, "1", 3),
    ("sort_bounces", None, "two", ValueError),
    ("mxu_dets", True, None, True),
    ("mxu_dets", None, "1", True),
    ("mxu_dets", None, "true", True),
    ("mxu_dets", False, None, False),
    ("mxu_dets", None, "0", False),
    ("mxu_dets", None, "false", False),
    ("sort_window", None, None, 32768),
    ("sort_window", None, "4096", 4096),
    ("sort_window", 256, "4096", 256),
    ("sort_window", 0, "4096", 0),
]
OPTIONS = {
    "cull": (jshade._cull_mode, mt_shade._cull_mode, "TPT_CULL"),
    "sub": (jshade._sub_tris, mt_shade._sub_tris, "TPT_SUB"),
    "tile_rays": (jshade._tile_rays, mt_shade._tile_rays, "TPT_TILE_RAYS"),
    "sort_bounces": (jtrace._sort_bounces, ttrace._sort_bounces, "TPT_SORT_BOUNCES"),
    "mxu_dets": (jshade._mxu_dets, mt_shade._mxu_dets, "TPT_MXU_DETS"),
    "sort_window": (jtrace._sort_window, ttrace._sort_window, "TPT_SORT_WINDOW"),
}


@pytest.mark.parametrize("option,override,env,expected", RESOLUTION_CASES,
                         ids=[f"{c[0]}-{c[1]}-{c[2]}" for c in RESOLUTION_CASES])
def test_option_resolution_matches_jax(option, override, env, expected, monkeypatch):
    jfn, tfn, env_name = OPTIONS[option]
    j, t = _resolve_both(jfn, tfn, override, env_name, env, monkeypatch)
    if expected is ValueError:
        assert isinstance(t, tuple) and t[0] is ValueError
        if option != "sort_bounces":  # int("two") words its own message
            assert t == j
    else:
        assert j == t == expected


def test_cond_takes_no_widening_and_no_dead_boxes():
    """'nf'/'list' widen the tile past 512 tiles; 'cond' keeps it.  'cond'
    takes its boxes straight from `treelet_boxes` over the padded rows (the
    padding pulls the last box toward the origin), as JAX does."""
    rng = np.random.default_rng(12)
    v0 = rng.uniform(-1, 1, (130, 3))
    tri = np.concatenate([v0, v0 + 0.1, v0 - 0.05], axis=1).astype(np.float32)  # pads to 256
    big = torch.zeros((10, 512 * 128 + 1))
    tt = torch.from_numpy(tri)
    assert mt_shade._prepare(tt, big, 128)[-1] == 256
    assert mt_shade._prepare_list(tt, big, 128, 32)[-1] == 256
    phi_pad, cols_rows, chunk_boxes, sub_boxes, tile_rays = mt_shade._prepare_cond(
        tt, big, 128, 32)
    assert tile_rays == 128 and phi_pad.shape == (10, 513 * 128)
    assert cols_rows.shape == (4 * 256, 10)
    padded = j_pad_to(jnp.asarray(tri), 256, 0)
    np.testing.assert_array_equal(chunk_boxes.numpy(), np.asarray(j_treelet_boxes(padded, 128)))
    np.testing.assert_array_equal(sub_boxes.numpy(), np.asarray(j_treelet_boxes(padded, 32)))
    assert (sub_boxes[-3:, :3] <= 0).all() and (sub_boxes[-3:, 3:6] >= 0).all()


def test_cond_walk_counts_cull_on_a_mesh():
    """Camera rays on the BVH-ordered default scene: the plain cond walk's
    chunk and sub tests skip work (random soups keep every box live), its
    walk counts are consistent, and its hits equal the nf walk's."""
    data = tpt.default_scene().compile(device="cpu")
    tri = data.packed.tri_pos
    cam = tpt.Camera.create(position=(0, 1, 4), look_at=(0, 0.5, 0), fov=45)
    xs, ys = ttrace.blocked_pixel_grid(32, 32)
    from tpu_pathtracer_torch.ops import camera as camera_ops

    o, d = camera_ops.camera_rays(cam, torch.stack([xs / 32.0, ys / 32.0], dim=-1), 1.0)
    phi_t = ttrace._ray_features_t(o.T.contiguous(), d.T.contiguous())
    stats = mt_shade.cond_walk_stats(tri, phi_t, tile_rays=128, sub=32)
    assert stats.shape == (8, 2)
    live, evaluated = (int(x) for x in stats.sum(dim=0))
    assert 0 < live < 16 * 8 and live <= evaluated < 4 * live
    hc = mt_shade.mt_intersect_cond_phi(tri, phi_t, tile_rays=128, sub=32)
    hn = mt_shade.mt_intersect_nf_phi(tri, phi_t, tile_rays=128, sub=32)
    assert int(hc.hit.sum()) > 500
    assert torch.equal(hc.hit, hn.hit) and torch.equal(hc.tri, hn.tri)
    assert torch.equal(hc.t[hc.hit], hn.t[hn.hit])


def test_render_options_read_the_environment(monkeypatch):
    """TPT_TILE_RAYS and TPT_SORT_BOUNCES reach render_frame (a bad value
    raises instead of being dropped)."""
    data = tpt.default_scene(gradient_sky(8, 16)).compile(device="cpu")
    params = tpt.RenderParams.create(tpt.Camera.create(), frame=1)
    kw = dict(width=8, height=8, aspect=1.0, max_bounces=1)
    monkeypatch.setenv("TPT_TILE_RAYS", "100")
    with pytest.raises(ValueError, match="tile_rays"):
        ttrace.render_frame(data, params, **kw)
    monkeypatch.setenv("TPT_TILE_RAYS", "128")
    monkeypatch.setenv("TPT_SORT_BOUNCES", "two")
    with pytest.raises(ValueError):
        ttrace.render_frame(data, params, **kw)
    monkeypatch.setenv("TPT_SORT_BOUNCES", "0")
    assert ttrace.render_frame(data, params, **kw).shape == (8, 8, 3)


def assert_images_close(a, b, mean_tol=1e-4, outlier_frac=0.01, outlier_tol=0.05):
    """tests/test_trace_golden.py::_assert_images_close."""
    diff = np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))
    outlier = diff.max(axis=-1) > outlier_tol
    assert outlier.mean() < outlier_frac, f"outlier fraction {outlier.mean():.4f}"
    agree = diff[~outlier].mean() if (~outlier).any() else 0.0
    assert agree < mean_tol, f"non-outlier mean abs diff {agree:.6f}"


def test_fused_frame_under_cond_matches_jax(monkeypatch):
    """A fused 16x16 frame with TPT_CULL=cond in both packages, by the
    outlier rule of tests/test_trace_golden.py."""
    monkeypatch.setenv("TPT_CULL", "cond")
    cam = dict(position=(0, 1, 4), look_at=(0, 0.5, 0), fov=45)
    kw = dict(width=16, height=16, aspect=1.0, samples_per_frame=1, max_bounces=3)
    a = jtrace.render_frame(jpt.default_scene(j_gradient_sky(8, 16)).compile(),
                            jpt.RenderParams.create(jpt.Camera.create(**cam), frame=2),
                            intersector="mt_pallas", **kw)
    b = ttrace.render_frame(tpt.default_scene(gradient_sky(8, 16)).compile(device="cpu"),
                            tpt.RenderParams.create(tpt.Camera.create(**cam), frame=2), **kw)
    assert b.shape == (16, 16, 3) and torch.isfinite(b).all()
    assert_images_close(np.asarray(a), b.numpy())
