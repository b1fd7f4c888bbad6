"""Port parity: environment CDF importance sampling (`ops.envsample`).

The JAX package's sampler and the port's see the same tables (each
package builds them from the same radiance with the same float64 numpy
code) and the same seeds.  Tolerances:

  * seeds, texel indices and the nearest-texel lookup: bit-equal;
  * uv and pdf: within 1 ULP (`assert_array_max_ulp`, maxulp=1);
  * the estimator tests (the port alone, against the truth, as
    tests/test_envmap.py:101-150 hold the JAX sampler): E[L/pdf] of a
    constant environment within 1%; on a sun environment within 10% at
    500 samples and 1% at 32,000, and within 5% of the uniform estimator's
    truth at 60,000.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_pathtracer.ops import envsample as jenv
from tpu_pathtracer.scene.envmap import build_cdf_tables as j_build_cdf_tables
from tpu_pathtracer.scene.envmap import build_environment as j_build_environment
from tpu_pathtracer_torch.ops import envsample, rng
from tpu_pathtracer_torch.scene import sky
from tpu_pathtracer_torch.scene.envmap import build_cdf_tables, build_environment, gradient_sky
from tpu_pathtracer_torch.scene.types import EnvironmentMap

N_SEEDS = 4096


def _radiance(name):
    if name == "gradient":
        return gradient_sky(32, 64)
    if name == "sky":
        return sky.sun_sky(32, 64, **sky.parse_sky_spec("sky:elevation=30,azimuth=90,turbidity=3"))
    return np.random.default_rng(5).random((13, 37, 3)).astype(np.float32) ** 4  # odd sizes


ENVS = ["gradient", "sky", "odd"]


@pytest.fixture(scope="module", params=ENVS)
def envs(request):
    rad = _radiance(request.param)
    return j_build_environment(rad), build_environment(rad)


def _seeds():
    return (np.arange(N_SEEDS, dtype=np.uint32) * np.uint32(2654435761)
            + np.uint32(12345)).astype(np.uint32)


def test_importance_sample_matches_jax(envs):
    """4,096 seeds: the advanced seeds and the sampled texels bit-equal,
    uv and pdf within 1 ULP."""
    jenv_map, tenv_map = envs
    seed = _seeds()
    js, juv = jenv.env_importance_sample(jenv_map, jnp.asarray(seed))
    ts, tuv = envsample.env_importance_sample(tenv_map, torch.from_numpy(seed.astype(np.int64)))
    np.testing.assert_array_equal(ts.numpy().astype(np.uint32), np.asarray(js))
    np.testing.assert_array_max_ulp(tuv.numpy(), np.asarray(juv), maxulp=1)
    h, w = tenv_map.height, tenv_map.width
    for uv_t, uv_j, size in ((tuv[:, 1], juv[:, 1], h), (tuv[:, 0], juv[:, 0], w)):
        np.testing.assert_array_equal(np.floor(uv_t.numpy() * size).astype(np.int64),
                                      np.floor(np.asarray(uv_j) * size).astype(np.int64))
    np.testing.assert_array_max_ulp(envsample.env_pdf(tenv_map, tuv).numpy(),
                                    np.asarray(jenv.env_pdf(jenv_map, juv)), maxulp=1)
    assert (tuv.numpy() >= 0).all() and (tuv.numpy() < 1).all()


def test_invert_exclusive_cdf_matches_jax(envs):
    """The CDF inversion alone: texel index bit-equal, coordinate within
    1 ULP, on uniforms that include 0 and the CDF's own breakpoints."""
    jenv_map, tenv_map = envs
    marginal = tenv_map.marginal_cdf[:, 0]
    targets = np.concatenate([np.linspace(0.0, 0.999999, 1000, dtype=np.float32),
                              marginal.numpy()]).astype(np.float32)
    h = tenv_map.height
    ty, tv = envsample._invert_exclusive_cdf(lambda i: marginal[i], torch.from_numpy(targets), h)
    jm = jenv_map.marginal_cdf[:, 0]
    jy, jv = jenv._invert_exclusive_cdf(lambda i: jm[i], jnp.asarray(targets), h)
    np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))
    np.testing.assert_array_max_ulp(tv.numpy(), np.asarray(jv), maxulp=1)
    assert ty.dtype == torch.int64 and int(ty.min()) >= 0 and int(ty.max()) < h


def test_sample_nearest_matches_jax():
    rs = np.random.default_rng(11)
    img = rs.random((7, 9, 3)).astype(np.float32)
    uv = rs.uniform(-0.2, 1.2, (500, 2)).astype(np.float32)
    np.testing.assert_array_equal(
        envsample.sample_nearest(torch.from_numpy(img), torch.from_numpy(uv)).numpy(),
        np.asarray(jenv.sample_nearest(jnp.asarray(img), jnp.asarray(uv))))


@pytest.mark.parametrize("make", [
    lambda: build_environment(np.zeros((8, 16, 3), np.float32)),
    lambda: EnvironmentMap.black(),
], ids=["built", "black"])
def test_black_env_sampler_is_finite(make):
    """With no light every density is 0: the built tables are uniform there
    and the pdf is floored at EPSILON (the zero tables of
    `EnvironmentMap.black`), so L/pdf is 0, never inf or NaN."""
    env = make()
    seed = torch.from_numpy(_seeds().astype(np.int64))
    _, uv = envsample.env_importance_sample(env, seed)
    pdf = envsample.env_pdf(env, uv)
    patches = envsample.pack_env_patches(env.radiance)
    est = envsample.env_radiance_packed(patches, (env.height, env.width), uv) / pdf[:, None]
    assert torch.isfinite(uv).all() and torch.isfinite(pdf).all() and (pdf > 0).all()
    assert torch.isfinite(est).all() and float(est.abs().max()) == 0.0


def test_cdf_tables_match_jax_where_jax_is_finite():
    """An environment with unlit rows: the port's tables are the JAX
    package's byte for byte wherever those are finite, and finite (the
    uniform CDF) in the unlit rows, where the JAX package's are NaN."""
    rad = gradient_sky(16, 32)
    rad[3] = 0.0
    rad[-2:] = 0.0
    with np.errstate(invalid="ignore"):
        want = j_build_cdf_tables(rad)
    for got, ref in zip(build_cdf_tables(rad), want):
        finite = np.isfinite(ref)
        assert got.dtype == ref.dtype and np.isfinite(got).all()
        assert got[finite].tobytes() == ref[finite].tobytes()
    assert not np.isfinite(want[1]).all()  # the JAX package's conditional rows
    np.testing.assert_array_equal(build_cdf_tables(rad)[1][3], np.arange(32) / np.float32(32))


def _is_estimate(env, n, salt=12345):
    """Monte-Carlo estimate of E[L(uv)/pdf(uv)] under the CDF sampler."""
    seed = (torch.arange(n, dtype=torch.int64) * 2654435761 + salt) & 0xFFFFFFFF
    _, uv = envsample.env_importance_sample(env, seed)
    pdf = envsample.env_pdf(env, uv)
    return float((envsample.sample_bilinear(env.radiance, uv)[:, 0] / pdf).double().mean())


def test_importance_estimator_unbiased_constant_env():
    env = build_environment(np.full((24, 48, 3), 2.0, np.float32))
    est = _is_estimate(env, 60000)
    assert abs(est / 2.0 - 1.0) < 0.01, est


def test_importance_estimator_matches_quadrature_and_converges():
    rad = np.asarray(gradient_sky(24, 48), np.float32)
    env = build_environment(rad)
    truth = float(rad[..., 0].mean())
    errs = [abs(_is_estimate(env, n) / truth - 1.0) for n in (500, 32000)]
    assert errs[0] < 0.1, (errs, truth)
    assert errs[-1] < 0.01, (errs, truth)


def test_importance_matches_uniform_estimator_in_expectation():
    rad = np.asarray(gradient_sky(24, 48), np.float32)
    env = build_environment(rad)
    truth = float(rad[..., 0].mean())
    est_is = _is_estimate(env, 60000)
    seed = (torch.arange(60000, dtype=torch.int64) * 2654435761 + 777) & 0xFFFFFFFF
    s, r1 = rng.rand(seed)
    _, r2 = rng.rand(s)
    est_uni = float(envsample.sample_bilinear(env.radiance, torch.stack([r2, r1], dim=-1))[:, 0]
                    .double().mean())
    assert abs(est_is / truth - 1.0) < 0.05, (est_is, truth)
    assert abs(est_uni / truth - 1.0) < 0.05, (est_uni, truth)
    assert abs(est_is - est_uni) / truth < 0.08


def test_importance_sampling_prefers_bright_texels():
    env = build_environment(gradient_sky(32, 64))
    _, uv = envsample.env_importance_sample(env, torch.arange(1 << 13, dtype=torch.int64))
    uv = uv.numpy()
    near = (np.abs(uv[:, 0] - 0.25) < 0.1) & (np.abs(uv[:, 1] - 0.3) < 0.1)
    assert near.mean() > 0.04  # uniform would give 0.04; the sun pulls it up
