"""Scene/image IO of the port: PNG, Radiance HDR (RGBE), glTF/GLB import
and export (Draco through `io.draco`)."""

from .gltf import GLTFError, load_gltf, normalize_meshes
from .hdr import read_hdr, write_hdr
from .image import read_png, to_uint8, write_png

__all__ = [
    "GLTFError",
    "load_gltf",
    "normalize_meshes",
    "read_hdr",
    "read_png",
    "to_uint8",
    "write_hdr",
    "write_png",
]
