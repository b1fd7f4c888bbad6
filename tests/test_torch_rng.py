"""Port parity: integer RNG streams and camera ray generation.

The same seeds and uvs, made with numpy, go through tpu_pathtracer (JAX, on
the CPU) and tpu_pathtracer_torch.  Integer seeds must agree bit for bit;
floats within 1e-6 (f32 transcendentals may differ by an ulp between XLA
and torch)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_pathtracer.ops import camera as jcamera
from tpu_pathtracer.ops import rng as jrng
from tpu_pathtracer.scene.types import Camera as JCamera
from tpu_pathtracer_torch.ops import camera as tcamera
from tpu_pathtracer_torch.ops import rng as trng
from tpu_pathtracer_torch.scene.types import Camera as TCamera

R = 4096


def _seeds(seed=0):
    return np.random.default_rng(seed).integers(0, 2**32, R, dtype=np.uint64).astype(np.uint32)


def _jax(x):
    return jnp.asarray(x)


def _torch_seed(s):
    return torch.from_numpy(s.astype(np.int64))


def _as_u32(t):
    return t.numpy().astype(np.uint32)


@pytest.mark.parametrize("frame", [1, 2, 719, 2**31 + 5])
def test_pixel_seed_bit_exact(frame):
    idx = np.arange(R, dtype=np.int32) * 37
    want = np.asarray(jrng.pixel_seed(_jax(idx), np.uint32(frame)))
    got = trng.pixel_seed(torch.from_numpy(idx), frame)
    np.testing.assert_array_equal(_as_u32(got), want)


def test_rand_bit_exact():
    s = _seeds(1)
    js, jt = _jax(s), torch.from_numpy(s.astype(np.int64))
    for _ in range(5):
        js, jv = jrng.rand(js)
        jt, tv = trng.rand(jt)
        np.testing.assert_array_equal(_as_u32(jt), np.asarray(js))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_rand_normal_seeds_exact_values_close():
    s = _seeds(2)
    js, jv = jrng.rand_normal(_jax(s))
    ts, tv = trng.rand_normal(_torch_seed(s))
    np.testing.assert_array_equal(_as_u32(ts), np.asarray(js))
    ok = np.isfinite(np.asarray(jv))
    np.testing.assert_allclose(tv.numpy()[ok], np.asarray(jv)[ok], rtol=1e-6, atol=1e-6)


def test_rand_point_in_circle_seeds_exact_values_close():
    s = _seeds(3)
    js, jv = jrng.rand_point_in_circle(_jax(s))
    ts, tv = trng.rand_point_in_circle(_torch_seed(s))
    np.testing.assert_array_equal(_as_u32(ts), np.asarray(js))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-6, atol=1e-6)


CAMERAS = [
    dict(position=(0, 1, 4), look_at=(0, 0.5, 0), fov=45),
    dict(position=(0, 3, 0), direction=(0, -1, 0), fov=60, aperture=0.2, focal_distance=3.0),
]


@pytest.mark.parametrize("cam", CAMERAS)
def test_camera_rays_close(cam):
    uv = np.random.default_rng(4).random((R, 2)).astype(np.float32)
    jo, jd = jcamera.camera_rays(JCamera.create(**cam), _jax(uv), jnp.float32(1.5))
    to, td = tcamera.camera_rays(TCamera.create(**cam), torch.from_numpy(uv), 1.5)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=1e-6)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=1e-6)


@pytest.mark.parametrize("cam", CAMERAS)
def test_apply_dof_seeds_exact_rays_close(cam):
    rng = np.random.default_rng(5)
    uv = rng.random((R, 2)).astype(np.float32)
    s = _seeds(6)
    res = np.array([64, 48], np.float32)
    jc, tc = JCamera.create(**cam), TCamera.create(**cam)
    jo, jd = jcamera.camera_rays(jc, _jax(uv), jnp.float32(4 / 3))
    to, td = tcamera.camera_rays(tc, torch.from_numpy(uv), 4 / 3)
    js, jo2, jd2 = jcamera.apply_dof(_jax(s), jo, jd, jc, _jax(res))
    ts, to2, td2 = tcamera.apply_dof(_torch_seed(s), to, td, tc, torch.from_numpy(res))
    np.testing.assert_array_equal(_as_u32(ts), np.asarray(js))
    np.testing.assert_allclose(to2.numpy(), np.asarray(jo2), atol=1e-6)
    np.testing.assert_allclose(td2.numpy(), np.asarray(jd2), atol=1e-6)


def test_rand_direction_and_vecmath_close():
    from tpu_pathtracer.ops import vecmath as jvec
    from tpu_pathtracer_torch.ops import vecmath as tvec

    s = _seeds(7)
    js, jv = jrng.rand_direction(_jax(s))
    ts, tv = trng.rand_direction(_torch_seed(s))
    np.testing.assert_array_equal(_as_u32(ts), np.asarray(js))
    ok = np.isfinite(np.asarray(jv)).all(axis=1)
    np.testing.assert_allclose(tv.numpy()[ok], np.asarray(jv)[ok], atol=1e-6)
    a = np.asarray(jv)[ok]
    b = np.random.default_rng(8).normal(size=a.shape).astype(np.float32)
    for name in ("dot", "cross", "reflect"):
        want = np.asarray(getattr(jvec, name)(jnp.asarray(a), jnp.asarray(b)))
        got = getattr(tvec, name)(torch.from_numpy(a), torch.from_numpy(b)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tvec.normalize(torch.from_numpy(b)).numpy(),
                               np.asarray(jvec.normalize(jnp.asarray(b))), atol=1e-6)
