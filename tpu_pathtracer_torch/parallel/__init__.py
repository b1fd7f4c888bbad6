"""The sharding layer on torch.distributed: the port of
`tpu_pathtracer.parallel` (row bands over 'tiles', the sample budget over
'samples', one rank per mesh position)."""

from .mesh import AXIS_SAMPLES, AXIS_TILES, make_mesh, single_device_mesh
from .diffshard import invert_sharded, make_sharded_value_and_grad, target_sharding
from .sharded import (
    acc_sharding,
    make_sharded_frame_step,
    make_sharded_render_all,
    zeros_acc,
)

__all__ = [
    "AXIS_SAMPLES",
    "invert_sharded",
    "make_sharded_value_and_grad",
    "target_sharding",
    "AXIS_TILES",
    "acc_sharding",
    "make_mesh",
    "make_sharded_frame_step",
    "make_sharded_render_all",
    "single_device_mesh",
    "zeros_acc",
]
