"""Utility helpers: orbit camera controller, blue noise, the checked render."""

from .orbit import OrbitCamera
from .bluenoise import blue_noise
from .debug import assert_finite_render, checked_render_frame

__all__ = ["OrbitCamera", "assert_finite_render", "blue_noise", "checked_render_frame"]
