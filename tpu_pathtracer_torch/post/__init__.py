"""Post-processing: upscale, denoise, tone-map."""

from .tonemap import aces_tonemap, reinhard_tonemap, tonemap
from .denoise import smart_denoise
from .resize import bilinear_resize
from .pipeline import postprocess

__all__ = [
    "aces_tonemap",
    "reinhard_tonemap",
    "tonemap",
    "smart_denoise",
    "bilinear_resize",
    "postprocess",
]
