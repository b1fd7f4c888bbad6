"""Configuration surface of the port: the same frozen dataclasses as
`tpu_pathtracer.config`, field for field, so that a configuration moves
between the two packages unchanged.
"""

from __future__ import annotations

import dataclasses
import enum


class Tonemap(enum.IntEnum):
    """Tone-mapping operator (reference: src/passes/shaders/fullscreen.wgsl:5-7)."""

    NONE = 0
    ACES = 1
    REINHARD = 2


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Shape-defining render settings.

    Defaults follow the reference: 64 frames x 1 spp progressive budget,
    4 bounces, scaling factor 1.  `intersector` accepts 'auto' (the
    near-to-far MT kernel up to 8,192 padded triangles, the streamed one up
    to 262,144, the fat-leaf BVH walk above), 'mt_pallas', 'mt_stream',
    'mt' (the all-pairs MT oracle), 'bvh' and 'bvh8'
    (`ops.trace.resolve_intersector`).  `blue_noise` jitters AA by a
    64x64 blue-noise table (`ops.trace.render_frame`); `sort_window` is
    the binning sort's window (None: TPT_SORT_WINDOW, then 32768; 0: one
    global sort; `ops.trace._sort_window`).  `tile_rays` is the MT
    kernels' ray-tile width (positive multiple of 128, default 512);
    `sort_bounces` is how many leading bounces re-bin the ray state
    (default 2).
    """

    width: int = 256
    height: int = 256
    scaling_factor: float = 1.0
    frames: int = 64
    samples_per_frame: int = 1
    max_bounces: int = 4
    seed: int = 123456789  # SEED constant, raytrace.wgsl:1
    accumulate: bool = True
    intersector: str = "auto"
    blue_noise: bool = False
    sort_bounces: int | None = None
    tile_rays: int | None = None
    sort_window: int | None = None

    @property
    def scaled_width(self) -> int:
        # Reference floors the scaled size (src/renderer.ts:310-320).
        return max(1, int(self.width * self.scaling_factor))

    @property
    def scaled_height(self) -> int:
        return max(1, int(self.height * self.scaling_factor))

    @property
    def total_spp(self) -> int:
        return self.frames * self.samples_per_frame


@dataclasses.dataclass(frozen=True)
class PostConfig:
    """Post-processing (fullscreen pass) settings: the reference's
    hard-coded `denoise(tex, uv, 5.0, 1.0, 0.08)` (fullscreen.wgsl:118)."""

    denoise: bool = True
    tonemap: Tonemap = Tonemap.ACES
    denoise_sigma: float = 5.0
    denoise_k_sigma: float = 1.0
    denoise_threshold: float = 0.08


@dataclasses.dataclass(frozen=True)
class ShardConfig:
    """Mesh layout of the sharded render and training steps (`parallel/`):
    image rows shard over `tiles` ranks, the per-frame sample budget over
    `samples` ranks, whose radiance is averaged by an all-reduce."""

    tiles: int = 1
    samples: int = 1

    @property
    def num_devices(self) -> int:
        return self.tiles * self.samples
