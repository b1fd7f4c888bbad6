"""Port parity: the bilateral denoise (plain PyTorch) against the JAX package.

The same numpy image goes through `tpu_pathtracer.post.denoise.smart_denoise`
(jnp), the Pallas kernel in interpret mode where its shape rules allow, and
the port.  Tolerance atol 2e-5 / rtol 1e-4, as tests/test_pallas_denoise.py
holds the Pallas kernel to the jnp version (exp differs by an ulp between
XLA and torch)."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from tpu_pathtracer.ops.pallas.denoise import smart_denoise_pallas
from tpu_pathtracer.post.denoise import _taps as j_taps
from tpu_pathtracer.post.denoise import smart_denoise as j_smart_denoise
from tpu_pathtracer_torch.ops.kernels import denoise as kdenoise
from tpu_pathtracer_torch.post.denoise import smart_denoise, tap_table

TOL = dict(atol=2e-5, rtol=1e-4)


def _image(h, w, seed=0):
    return np.random.default_rng(seed).random((h, w, 3)).astype(np.float32)


@pytest.mark.parametrize("hw", [(16, 128), (32, 256), (20, 50)])
def test_plain_denoise_matches_jax(hw):
    img = _image(*hw)
    ref = np.asarray(j_smart_denoise(jnp.asarray(img)))
    out = smart_denoise(torch.from_numpy(img)).numpy()
    np.testing.assert_allclose(out, ref, **TOL)


@pytest.mark.parametrize("hw", [(16, 128), (32, 256)])
def test_plain_denoise_matches_pallas_interpret(hw):
    img = _image(*hw, seed=1)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(smart_denoise_pallas(jnp.asarray(img)))
    out = smart_denoise(torch.from_numpy(img)).numpy()
    np.testing.assert_allclose(out, ref, **TOL)


def test_wrapper_runs_plain_version_on_cpu():
    img = torch.from_numpy(_image(12, 20, seed=2))
    before = kdenoise.smart_denoise.launches
    out = kdenoise.smart_denoise(img)
    assert kdenoise.smart_denoise.launches == before  # no kernel on a CPU tensor
    assert torch.equal(out, smart_denoise(img))


def test_constant_image_is_fixed_point():
    out = smart_denoise(torch.full((16, 40, 3), 0.25)).numpy()
    np.testing.assert_allclose(out, 0.25, atol=1e-6)


def test_tap_table_matches_jax_taps():
    taps, range_scale = tap_table()
    jt = j_taps(5.0)
    assert taps.shape == (len(jt), 4) == (85, 4)
    for (ix, y0, fy, w), (dx, dy) in zip(taps, jt):
        assert ix == dx and y0 == np.floor(dy)
        assert fy == np.float32(dy - np.floor(dy)) and w > 0
    assert range_scale == np.float32(0.5 / 0.08**2)



def test_torch_device_taps_are_cached_and_equal_tap_table():
    """The kernels' tap table is built once per (sigma, k_sigma, threshold,
    device) and holds `tap_table`'s rows on the device and on the host."""
    kdenoise.device_taps.cache_clear()
    cpu = torch.device("cpu")
    for _ in range(3):
        got = kdenoise.device_taps(5.0, 1.0, 0.08, cpu)
    kdenoise.device_taps(3.0, 1.0, 0.08, cpu)
    info = kdenoise.device_taps.cache_info()
    assert info.misses == 2 and info.hits == 2
    taps, range_scale = tap_table()
    assert torch.equal(got.device, torch.from_numpy(taps)) and got.device.device == cpu
    assert np.array_equal(got.host, taps) and got.host.flags["C_CONTIGUOUS"]
    assert got.neg_range_scale == -float(range_scale) and got.radius == 5


def _tap_offsets(radius):
    """The integer rule csrc/denoise.cu `tap_offset` compiles the taps by:
    column dx holds isqrt(4 m) + 1 taps (m = r^2 - dx^2), tap j at row floor
    j - ceil(sqrt(m)), with a row fraction unless m is a perfect square."""
    out = []
    for dx in range(-radius, radius + 1):
        m = radius * radius - dx * dx
        s = math.isqrt(m)
        frac = s * s != m
        out += [(dx, j - (s + 1 if frac else s), frac) for j in range(math.isqrt(4 * m) + 1)]
    return out


@pytest.mark.parametrize("radius", range(0, 18))  # 17: the widest under the kernel's 1,024 taps
def test_torch_tap_offsets_follow_the_integer_rule(radius):
    taps, _ = tap_table(float(radius) if radius else 0.4, 1.0)
    assert len(taps) == len(_tap_offsets(radius)) <= 1024
    for (dx, y0, frac), row in zip(_tap_offsets(radius), taps):
        assert (int(row[0]), int(row[1]), bool(row[2] > 0)) == (dx, y0, frac)


@pytest.mark.parametrize("sigma,hw", [(3.0, (20, 50)), (5.0, (6, 10)), (3.0, (6, 10))])
def test_torch_plain_denoise_matches_jax_at_other_radii_and_small_images(sigma, hw):
    """A second radius (sigma 3: 31 taps), and an image smaller than the
    halo, where the wrap goes round more than once."""
    img = _image(*hw, seed=3)
    ref = np.asarray(j_smart_denoise(jnp.asarray(img), sigma=sigma))
    out = smart_denoise(torch.from_numpy(img), sigma=sigma).numpy()
    np.testing.assert_allclose(out, ref, **TOL)
