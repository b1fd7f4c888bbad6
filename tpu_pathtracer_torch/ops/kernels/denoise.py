"""Bilateral "smart denoise": the wrapper around the CUDA kernel
(csrc/denoise.cu) and its plain PyTorch version.

Replaces the TPU kernel `_denoise_kernel` of tpu_pathtracer/ops/pallas/denoise.py.
`smart_denoise` launches the kernel for a CUDA tensor (counting the launch
in `smart_denoise.launches`) and runs `smart_denoise_plain`, the port of
post/denoise.py, for a CPU tensor.  Both read the same tap table.
"""

from __future__ import annotations

import ctypes

import torch

from ...post.denoise import smart_denoise as smart_denoise_plain
from ...post.denoise import tap_table

__all__ = ["smart_denoise", "smart_denoise_plain"]


def smart_denoise(img, sigma: float = 5.0, k_sigma: float = 1.0, threshold: float = 0.08):
    """img: (H, W, 3) f32 -> (H, W, 3) f32; any H and W."""
    if img.device.type == "cpu":
        return smart_denoise_plain(img, sigma, k_sigma, threshold)
    if img.device.type != "cuda":
        raise NotImplementedError(f"no denoise kernel for device {img.device}")
    from ... import _build

    if img.dtype != torch.float32 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"denoise kernel takes (H, W, 3) f32, got {tuple(img.shape)} {img.dtype}")
    img = img.contiguous()
    taps_np, range_scale = tap_table(sigma, k_sigma, threshold)
    taps = torch.from_numpy(taps_np).to(img.device)
    out = torch.empty_like(img)
    lib = _build.load()
    smart_denoise.launches += 1
    err = lib.tpt_denoise(
        ctypes.c_void_p(img.data_ptr()), ctypes.c_void_p(out.data_ptr()),
        ctypes.c_void_p(taps.data_ptr()), taps.shape[0], img.shape[0], img.shape[1],
        -float(range_scale), ctypes.c_void_p(torch.cuda.current_stream(img.device).cuda_stream),
    )
    if err:
        raise RuntimeError(f"denoise kernel launch failed: {_build.error_string(err)}")
    return out


smart_denoise.launches = 0
