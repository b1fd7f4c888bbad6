"""Port parity: the blue-noise AA jitter.

  * `utils.bluenoise` is a copy of the JAX package's module: the tables
    are byte-equal for n in {8, 16, 64};
  * `apply_dof(aa_uniforms=...)`: the seed stream bit-equal to JAX's (the
    AA draws skipped), origins and directions within 1 ULP of 1.0
    (atol 2.4e-7);
  * a blue-noise frame against JAX's (the fused path, JAX's Pallas kernel
    in interpret mode, and the plain loop): the outlier rule of
    tests/test_trace_golden.py (under 1% of pixels may take another random
    branch, the rest within 1e-4 mean absolute difference);
  * `RenderConfig(blue_noise=True)` through the Renderer equals
    `render_frame` with the 64x64 table, bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu_pathtracer as jpt
from tpu_pathtracer.ops import camera as jcamera
from tpu_pathtracer.ops import trace as jtrace
from tpu_pathtracer.scene.envmap import gradient_sky as j_gradient_sky
from tpu_pathtracer.utils import bluenoise as jbluenoise
import tpu_pathtracer_torch as tpt
from tpu_pathtracer_torch.ops import camera
from tpu_pathtracer_torch.ops import trace as ttrace
from tpu_pathtracer_torch.scene.envmap import gradient_sky
from tpu_pathtracer_torch.utils import bluenoise

from test_torch_trace import assert_images_close

CAM = dict(position=(0, 1, 4), look_at=(0, 0.5, 0), fov=45, aperture=0.05, focal_distance=4.0)


@pytest.mark.parametrize("n", [8, 16, 64])
def test_blue_noise_table_is_byte_equal_to_jax(n):
    got, want = bluenoise.blue_noise_table(n), jbluenoise.blue_noise_table(n)
    assert got.dtype == want.dtype == np.float32 and got.shape == (n, n, 2)
    assert got.tobytes() == want.tobytes()
    for k in range(2):  # unique ranks in [0, 1)
        plane = np.sort(got[..., k].ravel())
        assert np.unique(plane).size == n * n and plane.min() >= 0 and plane.max() < 1


def test_apply_dof_with_aa_uniforms_matches_jax():
    rs = np.random.default_rng(7)
    r = 4096
    o = np.broadcast_to(np.float32([0, 1, 4]), (r, 3)).copy()
    d = rs.normal(size=(r, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    seed = rs.integers(0, 2**32, r).astype(np.uint32)
    aa = rs.random((r, 2)).astype(np.float32)
    res = np.float32([16, 16])
    js, jo, jd = jcamera.apply_dof(jnp.asarray(seed), jnp.asarray(o), jnp.asarray(d),
                                   jpt.Camera.create(**CAM), jnp.asarray(res),
                                   aa_uniforms=jnp.asarray(aa))
    ts, to, td = camera.apply_dof(torch.from_numpy(seed.astype(np.int64)), torch.from_numpy(o),
                                  torch.from_numpy(d), tpt.Camera.create(**CAM),
                                  torch.from_numpy(res), aa_uniforms=torch.from_numpy(aa))
    np.testing.assert_array_equal(ts.numpy().astype(np.uint32), np.asarray(js))
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=0, atol=2.4e-7)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=0, atol=2.4e-7)


@pytest.fixture(scope="module")
def scenes():
    return (jpt.default_scene(j_gradient_sky(8, 16)).compile(),
            tpt.default_scene(gradient_sky(8, 16)).compile(device="cpu"))


@pytest.mark.parametrize("differentiable", [False, True], ids=["fused", "plain"])
def test_blue_noise_frame_matches_jax(scenes, differentiable):
    """Frame 3 at 2 samples a pixel (R2 points 4 and 5), 16x16, 2 bounces,
    with a 16x16 table (so the fused path's blocked pixel order indexes it)."""
    jsd, tsd = scenes
    bn = bluenoise.blue_noise_table(16)
    kw = dict(width=16, height=16, aspect=1.0, samples_per_frame=2, max_bounces=2,
              differentiable=differentiable, blue_noise=bn)
    a = jtrace.render_frame(jsd, jpt.RenderParams.create(jpt.Camera.create(**CAM), frame=3),
                            intersector="mt_pallas", **kw)
    b = ttrace.render_frame(tsd, tpt.RenderParams.create(tpt.Camera.create(**CAM), frame=3), **kw)
    assert b.shape == (16, 16, 3) and torch.isfinite(b).all()
    assert_images_close(np.asarray(a), b.detach().numpy())
    plain = ttrace.render_frame(tsd, tpt.RenderParams.create(tpt.Camera.create(**CAM), frame=3),
                                **{**kw, "blue_noise": None})
    assert not torch.equal(b.detach(), plain.detach())  # the jitter changed


def test_renderer_blue_noise_config_renders_the_table():
    """RenderConfig.blue_noise builds the 64x64 table once per rebuild and
    renders what render_frame renders with it."""
    cfg = tpt.RenderConfig(width=16, height=16, frames=2, max_bounces=2, blue_noise=True)
    r = tpt.Renderer(tpt.default_scene(gradient_sky(8, 16)), tpt.Camera.create(**CAM), cfg,
                     tpt.PostConfig(denoise=False), device="cpu")
    r.reset()
    r.render()
    img = ttrace.render_frame(r.scene_data, tpt.RenderParams.create(r.camera, frame=1), width=16,
                              height=16, aspect=1.0, max_bounces=2,
                              blue_noise=bluenoise.blue_noise_table(64))
    assert torch.equal(r.accumulation, img)
    r.render_all()
    assert r.status == "idle" and torch.isfinite(r.accumulation).all()
    assert float(r.accumulation.max()) > 0
