"""Bilinear display upscale (the resolution-scaling half of the fullscreen
pass; reference: src/passes/shaders/fullscreen.wgsl:47).  The port of
`tpu_pathtracer.post.resize`: display pixel centre (X+0.5)/W samples the
render image bilinearly with clamped edges."""

from __future__ import annotations

import torch

from ..ops.envsample import sample_bilinear


def bilinear_resize(img, height: int, width: int):
    """img (h, w, C) -> (height, width, C)."""
    if img.shape[0] == height and img.shape[1] == width:
        return img
    xs = (torch.arange(width, dtype=torch.float32, device=img.device) + 0.5) / width
    ys = (torch.arange(height, dtype=torch.float32, device=img.device) + 0.5) / height
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    return sample_bilinear(img, torch.stack([gx, gy], dim=-1))
