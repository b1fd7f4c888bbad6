"""Bilateral "smart denoise": the wrapper around the CUDA kernel
(csrc/denoise.cu) and its plain PyTorch version.

Replaces the TPU kernel `_denoise_kernel` of tpu_pathtracer/ops/pallas/denoise.py.
`smart_denoise` launches the kernel for a CUDA tensor (counting the launch
in `smart_denoise.launches`) and runs `smart_denoise_plain`, the port of
post/denoise.py, for a CPU tensor.  Both read the same tap table; the
kernel's copy is built once per (sigma, k_sigma, threshold, device)
(`device_taps`), so a display pays no host rebuild and no copy.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from ...post.denoise import smart_denoise as smart_denoise_plain
from ...post.denoise import tap_table

__all__ = ["smart_denoise", "smart_denoise_plain"]


class Taps(NamedTuple):
    """A tap table as the kernels read it."""

    device: torch.Tensor  # (n, 4) f32 on the kernel's device
    host: np.ndarray  # the same (n, 4) f32 rows in host memory
    neg_range_scale: float  # -range_scale: a tap weighs exp(dist2 * this) * weight
    radius: int  # bound of every tap's column offset and rows y0, y0 + 1


@functools.lru_cache(maxsize=16)
def device_taps(sigma: float, k_sigma: float, threshold: float, device: torch.device) -> Taps:
    """`tap_table(sigma, k_sigma, threshold)` on `device`, built once per key."""
    host, range_scale = tap_table(sigma, k_sigma, threshold)
    host = np.ascontiguousarray(host, dtype=np.float32)
    rows = np.concatenate([host[:, 1], host[:, 1] + (host[:, 2] > 0)])
    radius = int(max(np.abs(host[:, 0]).max(), np.abs(rows).max()))
    return Taps(torch.from_numpy(host).to(device), host, -float(range_scale), radius)


def _prepare(img, sigma, k_sigma, threshold):
    if img.dtype != torch.float32 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"denoise kernel takes (H, W, 3) f32, got {tuple(img.shape)} {img.dtype}")
    img = img.contiguous()
    return img, torch.empty_like(img), device_taps(float(sigma), float(k_sigma),
                                                   float(threshold), img.device)


def _launch(img, out, taps: Taps) -> None:
    """Launch `tpt_denoise` on the current stream, reading `img` and
    writing `out` (both contiguous (H, W, 3) f32)."""
    from ... import _build

    lib = _build.load()
    h, w = img.shape[0], img.shape[1]
    ptr = [ctypes.c_void_p(x.data_ptr()) for x in (img, out, taps.device)]
    stream = ctypes.c_void_p(torch.cuda.current_stream(img.device).cuda_stream)
    n, scale = taps.host.shape[0], ctypes.c_float(taps.neg_range_scale)
    err = lib.tpt_denoise(*ptr, ctypes.c_void_p(taps.host.ctypes.data), n, taps.radius, h, w,
                          scale, stream)
    if err:
        raise RuntimeError(f"tpt_denoise launch failed: {_build.error_string(err)}")


def smart_denoise(img, sigma: float = 5.0, k_sigma: float = 1.0, threshold: float = 0.08):
    """img: (H, W, 3) f32 -> (H, W, 3) f32; any H and W."""
    if img.device.type == "cpu":
        return smart_denoise_plain(img, sigma, k_sigma, threshold)
    if img.device.type != "cuda":
        raise NotImplementedError(f"no denoise kernel for device {img.device}")
    img, out, taps = _prepare(img, sigma, k_sigma, threshold)
    smart_denoise.launches += 1
    _launch(img, out, taps)
    return out


smart_denoise.launches = 0

