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

__all__ = [
    "InvertResult",
    "extract",
    "get_leaf",
    "grads",
    "insert",
    "invert",
    "l2_image_loss",
    "make_loss",
    "make_param_loss",
    "render_frame_diff",
    "set_leaf",
]
