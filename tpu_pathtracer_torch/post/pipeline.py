"""The full post pipeline: upscale -> denoise -> tonemap (the reference's
fullscreen pass, src/passes/fullscreen.ts + fullscreen.wgsl:110-132)."""

from __future__ import annotations

from ..config import PostConfig
from ..ops.kernels.denoise import smart_denoise
from .resize import bilinear_resize
from .tonemap import tonemap


def postprocess(img, config: PostConfig, display_height: int | None = None,
                display_width: int | None = None):
    """img: (h, w, 3) linear radiance -> display-ready (H, W, 3) in [0, 1].

    Order matches the reference fragment shader: upscale first, then
    denoise at display resolution, then tonemap (see
    `tpu_pathtracer.post.pipeline.postprocess` for the edge semantics).
    `smart_denoise` launches the denoise kernel for a CUDA image and runs
    its plain version for a CPU one."""
    out = img
    if display_height is not None and display_width is not None:
        out = bilinear_resize(out, display_height, display_width)
    if config.denoise:
        out = smart_denoise(out, sigma=config.denoise_sigma, k_sigma=config.denoise_k_sigma,
                            threshold=config.denoise_threshold)
    return tonemap(out, config.tonemap)
