"""Environment-map CDF construction (host side, numpy) and the analytic sky.

The port of `tpu_pathtracer.scene.envmap`: the same float64 numpy build of
the reference's CPU CDF tables (reference: src/renderer.ts:159-266), stored
as f32 tensors on the requested device.
"""

from __future__ import annotations

import numpy as np
import torch

from .types import EnvironmentMap


def build_cdf_tables(radiance: np.ndarray):
    """Returns (marginal_cdf, conditional_cdf, pdf, sample_pdf), each (H, W) f32."""
    rad = np.asarray(radiance, np.float64)
    h, w = rad.shape[0], rad.shape[1]

    lum = 0.2126 * rad[..., 0] + 0.7152 * rad[..., 1] + 0.0722 * rad[..., 2]

    theta = (np.arange(h, dtype=np.float64) + 0.5) / h * np.pi
    weighted = lum * np.sin(theta)[:, None]

    row_totals = weighted.sum(axis=1)
    total = row_totals.sum()
    # An environment with no light (or a row without any) has no density
    # to invert: it gets the uniform CDF there, where the JAX package's
    # tables hold NaN (0/0), so that the importance sampler stays finite.
    # Every other table is the JAX package's, byte for byte.
    norm_rows = row_totals / total if total > 0 else np.full(h, 1.0 / h)
    marginal = np.concatenate([[0.0], np.cumsum(norm_rows)[:-1]])
    marginal_2d = np.broadcast_to(marginal[:, None], (h, w))

    lum_row_totals = lum.sum(axis=1, keepdims=True)
    lit = lum_row_totals > 0
    col_norm = np.where(lit, lum / np.where(lit, lum_row_totals, 1.0), 1.0 / w)
    conditional = np.concatenate(
        [np.zeros((h, 1)), np.cumsum(col_norm, axis=1)[:, :-1]], axis=1
    )

    # True uv-measure density of the sampler that inverts these CDFs.
    sample_pdf = norm_rows[:, None] * col_norm * (h * w)

    return (
        marginal_2d.astype(np.float32),
        conditional.astype(np.float32),
        weighted.astype(np.float32),
        sample_pdf.astype(np.float32),
    )


def build_environment(radiance: np.ndarray, device="cpu") -> EnvironmentMap:
    """Radiance + CDF tables as an `EnvironmentMap` on `device`; accepts any
    (H, W, >=3) float array."""
    rad = np.asarray(radiance, np.float32)
    if rad.ndim != 3 or rad.shape[2] < 3:
        raise ValueError(f"environment radiance must be (H, W, 3), got {rad.shape}")
    rad = np.ascontiguousarray(rad[..., :3])
    marginal, conditional, pdf, sample_pdf = build_cdf_tables(rad)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return EnvironmentMap(
        radiance=t(rad),
        marginal_cdf=t(marginal),
        conditional_cdf=t(conditional),
        pdf=t(pdf),
        sample_pdf=t(sample_pdf),
    )


def gradient_sky(height: int = 512, width: int = 1024, horizon=(1.0, 0.9, 0.7),
                 zenith=(0.2, 0.4, 0.9), ground=(0.15, 0.12, 0.1),
                 intensity: float = 1.0) -> np.ndarray:
    """Simple analytic sky with a bright sun blob (numpy, (H, W, 3) f32)."""
    v = (np.arange(height, dtype=np.float32) + 0.5) / height  # 0 = top (zenith)
    elev = np.cos(v * np.pi)  # 1 at top, -1 at bottom
    up = np.clip(elev, 0.0, 1.0)[:, None]  # (H, 1)
    down = np.clip(-elev, 0.0, 1.0)[:, None]
    horizon_w = 1.0 - up - down
    col = (
        up * np.asarray(zenith, np.float32)[None, :]
        + down * np.asarray(ground, np.float32)[None, :]
        + horizon_w * np.asarray(horizon, np.float32)[None, :]
    )  # (H, 3)
    img = np.broadcast_to(col[:, None, :], (height, width, 3)).copy()
    u = (np.arange(width, dtype=np.float32) + 0.5) / width
    sun = np.exp(-(((u - 0.25) * 24.0) ** 2))[None, :, None] * np.exp(
        -(((v - 0.3) * 12.0) ** 2)
    )[:, None, None]
    img += sun * np.asarray([40.0, 36.0, 30.0], np.float32)
    return (img * intensity).astype(np.float32)
