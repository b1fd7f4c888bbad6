"""Differentiable rendering and inverse rendering on torch autograd: the
port of `tpu_pathtracer.diff`."""

from .api import (
    extract,
    get_leaf,
    grads,
    insert,
    l2_image_loss,
    make_loss,
    make_param_loss,
    render_frame_diff,
    set_leaf,
)
from .invert import InvertResult, invert

# the leaf helpers stay importable here; `__all__` is JAX's (which keeps them in diff.api)
__all__ = [
    "InvertResult",
    "extract",
    "grads",
    "insert",
    "invert",
    "l2_image_loss",
    "make_loss",
    "make_param_loss",
    "render_frame_diff",
]
