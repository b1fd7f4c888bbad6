"""Post-processing: upscale, denoise, tone-map."""

from .pipeline import postprocess

__all__ = ["postprocess"]
