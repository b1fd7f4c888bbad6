"""Procedural sun-sky environment maps (Preetham analytic daylight model):
the port's copy of `tpu_pathtracer.scene.sky` (numpy only), with the same
output to the byte.

The reference ships three captured 1k equirect HDRIs as selectable
environments (reference: src/main.ts:29-33, public/static/env/*.hdr). We
cannot (and should not) vendor binary captures, so the framework generates
physically-plausible daylight environments instead: the Preetham et al.
"A Practical Analytic Model for Daylight" sky with an explicit sun disc,
emitted in the exact equirect orientation the tracer samples
(ops/envsample.env_uv_from_ray: row 0 = zenith, u = atan2(x,z)/2pi + 0.5).

Output is linear-sRGB radiance (H, W, 3) float32, directly usable as
`Scene.set_environment(...)` input or exportable with io.hdr.write_hdr.
"""

from __future__ import annotations

import numpy as np

# CIE Yxy -> XYZ -> linear sRGB (D65)
_XYZ_TO_SRGB = np.array(
    [
        [3.2404542, -1.5371385, -0.4985314],
        [-0.9692660, 1.8760108, 0.0415560],
        [0.0556434, -0.2040259, 1.0572252],
    ],
    np.float64,
)

# Perez coefficient rows (A..E) as linear functions of turbidity T:
# value = c0 * T + c1   (Preetham et al. 1999, appendix A.2)
_PEREZ_Y = np.array(
    [
        [0.1787, -1.4630],
        [-0.3554, 0.4275],
        [-0.0227, 5.3251],
        [0.1206, -2.5771],
        [-0.0670, 0.3703],
    ]
)
_PEREZ_X = np.array(
    [
        [-0.0193, -0.2592],
        [-0.0665, 0.0008],
        [-0.0004, 0.2125],
        [-0.0641, -0.8989],
        [-0.0033, 0.0452],
    ]
)
_PEREZ_YC = np.array(
    [
        [-0.0167, -0.2608],
        [-0.0950, 0.0092],
        [-0.0079, 0.2102],
        [-0.0441, -1.6537],
        [-0.0109, 0.0529],
    ]
)

# Zenith chromaticity polynomials (theta_s^3..1, columns T^2, T, 1).
_ZENITH_X = np.array(
    [
        [0.00166, -0.02903, 0.11693],
        [-0.00375, 0.06377, -0.21196],
        [0.00209, -0.03202, 0.06052],
        [0.0, 0.00394, 0.25886],
    ]
)
_ZENITH_Y = np.array(
    [
        [0.00275, -0.04214, 0.15346],
        [-0.00610, 0.08970, -0.26756],
        [0.00317, -0.04153, 0.06670],
        [0.0, 0.00516, 0.26688],
    ]
)


def _perez(theta_cos: np.ndarray, gamma: np.ndarray, coeffs: np.ndarray):
    a, b, c, d, e = coeffs
    cos_t = np.maximum(theta_cos, 1e-3)
    return (1.0 + a * np.exp(b / cos_t)) * (
        1.0 + c * np.exp(d * gamma) + e * np.cos(gamma) ** 2
    )


def _zenith_chroma(poly: np.ndarray, theta_s: float, t: float) -> float:
    tv = np.array([t * t, t, 1.0])
    sv = np.array([theta_s**3, theta_s**2, theta_s, 1.0])
    return float(sv @ poly @ tv)


def sun_sky(
    height: int = 512,
    width: int = 1024,
    sun_elevation: float = 30.0,
    sun_azimuth: float = 90.0,
    turbidity: float = 3.0,
    intensity: float = 1.0,
    sun_intensity: float = 400.0,
    ground_albedo=(0.30, 0.25, 0.20),
) -> np.ndarray:
    """Preetham daylight equirect environment.

    sun_elevation / sun_azimuth in degrees (azimuth 0 = +Z, 90 = +X, matching
    phi = atan2(x, z)); turbidity 2 (clear) .. 10 (hazy); `sun_intensity`
    scales the explicit sun disc relative to the sky dome.  Luminance is
    normalized so the zenith is ~1.0 before `intensity`.
    """
    t = float(np.clip(turbidity, 1.2, 12.0))
    elev_s = np.deg2rad(np.clip(sun_elevation, 0.5, 89.5))
    theta_s = np.pi / 2 - elev_s  # sun zenith angle
    phi_s = np.deg2rad(sun_azimuth)

    # pixel-center direction grid (row 0 = zenith; see envsample.py)
    v = (np.arange(height) + 0.5) / height
    u = (np.arange(width) + 0.5) / width
    theta = v * np.pi  # zenith angle of the texel direction
    phi = (u - 0.5) * 2.0 * np.pi
    sin_t, cos_t = np.sin(theta)[:, None], np.cos(theta)[:, None]
    dirs = np.stack(
        [
            np.broadcast_to(sin_t * np.sin(phi)[None, :], (height, width)),
            np.broadcast_to(cos_t, (height, width)),
            np.broadcast_to(sin_t * np.cos(phi)[None, :], (height, width)),
        ],
        axis=-1,
    )
    sun_dir = np.array(
        [np.cos(elev_s) * np.sin(phi_s), np.sin(elev_s), np.cos(elev_s) * np.cos(phi_s)]
    )
    cos_gamma = np.clip(dirs @ sun_dir, -1.0, 1.0)
    gamma = np.arccos(cos_gamma)

    # Perez coefficients and zenith values
    coeff_y = _PEREZ_Y @ [t, 1.0]
    coeff_x = _PEREZ_X @ [t, 1.0]
    coeff_yc = _PEREZ_YC @ [t, 1.0]

    chi = (4.0 / 9.0 - t / 120.0) * (np.pi - 2.0 * theta_s)
    yz = (4.0453 * t - 4.9710) * np.tan(chi) - 0.2155 * t + 2.4192  # kcd/m^2
    yz = max(yz, 1e-3)
    xz = _zenith_chroma(_ZENITH_X, theta_s, t)
    yz_c = _zenith_chroma(_ZENITH_Y, theta_s, t)

    cos_theta = np.broadcast_to(cos_t, (height, width))
    above = cos_theta > 0.0
    # clamp sky evaluation to the horizon; below-horizon handled separately
    cos_eval = np.maximum(cos_theta, 1e-3)

    def sky_ratio(coeffs, zenith_val):
        f = _perez(cos_eval, gamma, coeffs)
        f0 = _perez(np.array(1.0), np.array(theta_s), coeffs)
        return zenith_val * f / f0

    lum = sky_ratio(coeff_y, yz) / yz  # normalized: zenith ~ 1
    cx = sky_ratio(coeff_x, xz)
    cy = sky_ratio(coeff_yc, yz_c)
    cy = np.maximum(cy, 1e-4)

    big_x = lum / cy * cx
    big_z = lum / cy * (1.0 - cx - cy)
    xyz = np.stack([big_x, lum, big_z], axis=-1)
    rgb = np.maximum(xyz @ _XYZ_TO_SRGB.T, 0.0)

    # explicit sun disc (angular radius ~0.2665 deg) with soft limb.  The
    # disc is widened to at least one texel so it stays resolvable at any
    # map resolution (energy is conserved by scaling radiance with the
    # solid-angle ratio of the true disc to the widened one).
    sun_r = np.deg2rad(0.2665)
    texel = np.pi / height
    eff_r = max(sun_r, texel)
    energy = (sun_r / eff_r) ** 2
    disc = np.clip((eff_r * 1.6 - gamma) / (eff_r * 1.2), 0.0, 1.0)
    sun_rgb = np.array([1.0, 0.965, 0.92]) * sun_intensity * energy
    rgb = rgb + disc[..., None] ** 2 * sun_rgb * above[..., None]

    # below the horizon: albedo-tinted copy of the horizon-band radiance
    horizon_row = np.argmax(np.cos(theta) <= 0.0)
    horizon_rgb = rgb[max(horizon_row - 1, 0)]  # (W, 3) just above horizon
    albedo = np.asarray(ground_albedo, np.float64)
    fade = np.clip(-cos_theta, 0.0, 1.0)[..., None]  # 0 at horizon, 1 at nadir
    ground = horizon_rgb[None, :, :] * albedo * (1.0 - 0.7 * fade)
    rgb = np.where(above[..., None], rgb, ground)

    return (rgb * intensity).astype(np.float32)


def parse_sky_spec(spec: str) -> dict:
    """Parse 'sky' or 'sky:elevation=30,azimuth=90,turbidity=3,intensity=1'
    into sun_sky kwargs (the CLI/--env and viewer env-select syntax)."""
    kwargs = {}
    if ":" in spec:
        _, _, rest = spec.partition(":")
        alias = {"elevation": "sun_elevation", "azimuth": "sun_azimuth",
                 "elev": "sun_elevation", "azim": "sun_azimuth"}
        for part in filter(None, rest.split(",")):
            k, _, val = part.partition("=")
            k = k.strip()
            kwargs[alias.get(k, k)] = float(val)
    return kwargs
