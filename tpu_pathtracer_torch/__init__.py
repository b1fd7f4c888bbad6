"""tpu_pathtracer_torch: the PyTorch and CUDA port of tpu_pathtracer.

The package mirrors `tpu_pathtracer`'s layout and names.  It imports torch
and numpy, never JAX: the JAX package is the reference it is tested
against, side by side, in tests/test_torch_*.py.  The hot kernels are
hand-written CUDA C++ for Hopper (csrc/), built with nvcc at first use
(`_build.py`); a CPU tensor runs each kernel's plain PyTorch version.
"""

from .config import PostConfig, RenderConfig, ShardConfig, Tonemap
from .render.renderer import Renderer
from .scene.host import Material, Mesh, Scene, default_scene
from .scene.types import (
    Camera,
    EnvironmentMap,
    FlatBVH,
    Materials,
    RenderParams,
    SceneData,
    Triangles,
)

__version__ = "0.1.0"

__all__ = [
    "Camera",
    "EnvironmentMap",
    "FlatBVH",
    "Material",
    "Materials",
    "Mesh",
    "PostConfig",
    "RenderConfig",
    "RenderParams",
    "Renderer",
    "Scene",
    "SceneData",
    "ShardConfig",
    "Tonemap",
    "Triangles",
    "default_scene",
]
