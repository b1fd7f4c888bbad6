"""accel layer of the port (see the package docstring)."""

from .bvh import build_bvh_flat

__all__ = ["build_bvh_flat"]
