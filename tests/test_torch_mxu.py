"""Port parity: the MXU-determinant variants of the whole-scene MT kernels
(kernel #5, `_mt_mxu_block`).

On the CPU each variant runs its plain version, which forms a sub-treelet's
determinants as one float32 matrix product, as the JAX kernels do under
`mxu_dets=True`.  Held here:

  * nf, list and cond at sub-treelets of 32, 64 and 128 against the JAX
    Pallas kernels in interpret mode with `mxu_dets=True`, on the soup of
    tests/test_torch_cull.py, with `assert_hit_parity`'s tolerances;
  * the MXU plain version against the FP32 plain version on the headline
    camera's rays at 64x64: the same hits and triangles except counted
    near-ties and edge lanes (`hit_agreement`);
  * a fused frame under TPT_MXU_DETS=1 against =0 by the outlier rule.

The CUDA kernels themselves are compared with these plain versions in
tests/test_torch_cuda.py, on a machine with a card."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_cull import assert_hit_parity, assert_images_close, soup  # noqa: F401
from tpu_pathtracer.ops.mt_matmul import ray_features as j_ray_features
from tpu_pathtracer.ops.pallas import mt_shade as jshade
import tpu_pathtracer_torch as tpt
from tpu_pathtracer_torch.ops import camera as camera_ops
from tpu_pathtracer_torch.ops import trace as ttrace
from tpu_pathtracer_torch.ops.kernels import mt_shade
from tpu_pathtracer_torch.ops.mt_matmul import ray_features
from tpu_pathtracer_torch.scene.envmap import gradient_sky


@pytest.mark.parametrize("sub", [32, 64, 128])
@pytest.mark.parametrize("cull", ["nf", "list", "cond"])
def test_mxu_plain_matches_pallas_interpret(soup, cull, sub):
    tri, ro, rd, park = soup
    phi_j = j_ray_features(jnp.asarray(ro), jnp.asarray(rd)).T
    ha = jshade.mt_intersect_pallas2_phi(jnp.asarray(tri), phi_j, interpret=True, cull=cull,
                                         sub=sub, mxu_dets=True)
    phi_t = ray_features(torch.from_numpy(ro), torch.from_numpy(rd)).T.contiguous()
    before = mt_shade.mt_intersect_nf_mxu_phi.launches
    hb = mt_shade.mt_intersect_pallas2_phi(torch.from_numpy(tri), phi_t, cull=cull, sub=sub,
                                           mxu_dets=True)
    assert mt_shade.mt_intersect_nf_mxu_phi.launches == before  # the CPU runs no kernel
    assert not hb.hit.numpy()[park].any()
    assert_hit_parity(ha, hb)
    miss = ~np.asarray(ha.hit)
    np.testing.assert_array_equal(hb.t.numpy()[miss], np.asarray(ha.t)[miss])


def _headline_phi(size=64):
    cam = tpt.Camera.create(position=(0, 1, 4), look_at=(0, 0.5, 0), fov=45)
    xs, ys = ttrace.blocked_pixel_grid(size, size)
    o, d = camera_ops.camera_rays(cam, torch.stack([xs / float(size), ys / float(size)], dim=-1),
                                  1.0)
    return ttrace._ray_features_t(o.T.contiguous(), d.T.contiguous())


@pytest.mark.parametrize("cull", ["nf", "cond"])
def test_mxu_plain_decides_like_fp32_on_camera_rays(cull):
    """The default scene's camera rays at 64x64: the MXU and FP32 plain
    versions agree on hit and triangle except on counted near-ties, edge
    or floor lanes, and on t, u and v within 1e-4 of the scale their sums
    are conditioned by (`hit_agreement`'s rule); cond's walk counts are
    equal."""
    tri = tpt.default_scene().compile(device="cpu").packed.tri_pos
    phi_t = _headline_phi()
    kernel, _ = mt_shade._ROUTES[cull, False]
    hm = mt_shade.mt_intersect_pallas2_phi(tri, phi_t, cull=cull, mxu_dets=True)
    hf = kernel(tri, phi_t)
    agree = mt_shade.hit_agreement(tri, phi_t, hm, hf)
    assert int(hm.hit.sum()) > 1500
    assert agree["ok"], agree
    if cull == "cond":
        torch.testing.assert_close(mt_shade.cond_walk_stats(tri, phi_t, mxu=True),
                                   mt_shade.cond_walk_stats(tri, phi_t), rtol=0, atol=0)


def test_hit_agreement_classifies_lanes():
    """A changed triangle with a near t is a near-tie; a lane that loses its
    hit is counted as 'other' unless it lies on the triangle's edge."""
    tri = tpt.default_scene().compile(device="cpu").packed.tri_pos
    phi_t = _headline_phi(32)
    h = mt_shade.mt_intersect_nf_phi_plain(tri, phi_t)
    assert mt_shade.hit_agreement(tri, phi_t, h, h)["differ"] == 0
    lane = int(h.hit.nonzero()[0])
    other = h._replace(hit=h.hit.clone(), tri=h.tri.clone(), t=h.t.clone())
    other.hit[lane], other.tri[lane] = False, -1
    got = mt_shade.hit_agreement(tri, phi_t, h, other)
    assert got["differ"] == 1 and got["near_ties"] == 0
    assert got["edges"] + got["other"] == 1
    tied = h._replace(tri=h.tri.clone(), t=h.t.clone())
    tied.tri[lane] = (int(h.tri[lane]) + 1) % tri.shape[0]
    tied.t[lane] = h.t[lane] * (1 + 2e-6)
    got = mt_shade.hit_agreement(tri, phi_t, h, tied)
    assert got["differ"] == 1 and got["near_ties"] == 1 and got["other"] == 0


def test_fused_frame_under_mxu_dets_matches_fp32(monkeypatch):
    """A fused 16x16 frame with TPT_MXU_DETS=1 against the same frame with
    =0, by the outlier rule of tests/test_trace_golden.py."""
    data = tpt.default_scene(gradient_sky(8, 16)).compile(device="cpu")
    params = tpt.RenderParams.create(
        tpt.Camera.create(position=(0, 1, 4), look_at=(0, 0.5, 0), fov=45), frame=2)
    kw = dict(width=16, height=16, aspect=1.0, max_bounces=3)
    frames = {}
    for flag in ("0", "1"):
        monkeypatch.setenv("TPT_MXU_DETS", flag)
        frames[flag] = ttrace.render_frame(data, params, **kw)
    assert torch.isfinite(frames["1"]).all()
    assert_images_close(frames["0"].numpy(), frames["1"].numpy())

