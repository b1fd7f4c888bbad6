"""What the loops' correctness checks share: the reference scene, built
from the same arrays the program gets, and the precisions of the controls.
Each loop's own comparison is its module's `check` (`loops/`)."""

from __future__ import annotations

import torch

from . import scenes
from .reference import tracer

DTYPES = {"bfloat16": torch.bfloat16}  # the controls: a precision below float32


def reference_scene(config: dict, device, dtype):
    tris, table = scenes.world_triangles(config)
    return tracer.build_scene(tris, table, scenes.environment(config), device=device, dtype=dtype)
