"""Port parity: the bilateral denoise (plain PyTorch) against the JAX package.

The same numpy image goes through `tpu_pathtracer.post.denoise.smart_denoise`
(jnp), the Pallas kernel in interpret mode where its shape rules allow, and
the port.  Tolerance atol 2e-5 / rtol 1e-4, as tests/test_pallas_denoise.py
holds the Pallas kernel to the jnp version (exp differs by an ulp between
XLA and torch)."""

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

