"""The Renderer orchestrator: progressive frame loop, state machine, events.

The port of `tpu_pathtracer.render.renderer.Renderer` (the reference
Renderer's public contract, src/renderer.ts:20-533):

  * progressive state machine `idle | sampling | paused` with
    start/pause/reset and a 1-based frame counter whose overflow past
    `frames` flips to idle and emits 'complete';
  * `render()` advances at most one progressive frame; the accumulated
    image persists and can be displayed while paused;
  * events reset/start/pause/progress/complete, `progress = frame /
    (frames + 1)`;
  * the device scene is recompiled only when `scene.needs_update` is set.

Everything lives on the `device` the constructor is given, the card unless
the caller asks for the CPU.  `RenderConfig.intersector` chooses the
intersector as `ops.trace.resolve_intersector` does: 'auto' takes the MT
kernels up to 262,144 padded triangles and the fat-leaf BVH walk ('bvh8')
above.  Not ported yet (ROADMAP.md): sharding (`shard`), env importance
sampling, per-pass timing meters and checkpoints (`save_state` /
`load_state`).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..config import PostConfig, RenderConfig
from ..ops.trace import accumulate, render_frame, resolve_intersector
from ..post.pipeline import postprocess
from ..scene.host import Scene
from ..scene.types import Camera, RenderParams, SceneData

Event = str  # 'reset' | 'start' | 'pause' | 'progress' | 'complete'


def make_frame_step(width: int, height: int, aspect: float, samples_per_frame: int,
                    max_bounces: int, accumulate_frames: bool, intersector: str = "auto",
                    sort_bounces=None, tile_rays=None):
    """The progressive step: render one frame and fold it into `acc` in place
    (the JAX step donates its accumulator, so nothing else holds it)."""

    def step(scene: SceneData, params: RenderParams, acc: torch.Tensor) -> torch.Tensor:
        frame_img = render_frame(
            scene, params, width=width, height=height, aspect=aspect,
            samples_per_frame=samples_per_frame, max_bounces=max_bounces,
            intersector=intersector, sort_bounces=sort_bounces, tile_rays=tile_rays,
        )
        return accumulate(acc, frame_img, params.frame, enabled=accumulate_frames, out=acc)

    return step


class Renderer:
    def __init__(
        self,
        scene: Scene,
        camera: Camera,
        config: RenderConfig = RenderConfig(),
        post: PostConfig = PostConfig(),
        *,
        device="cuda",
        env_importance: bool = False,
        enable_timing: bool = False,
        shard=None,
    ) -> None:
        if env_importance:
            raise NotImplementedError("env importance sampling is not ported yet (ROADMAP.md)")
        if enable_timing:
            raise NotImplementedError("per-pass timing is not ported yet (ROADMAP.md)")
        if shard is not None:
            raise NotImplementedError("sharded rendering is not ported yet (ROADMAP.md)")
        self.device = torch.device(device)
        self.scene = scene
        self.camera = camera.to(self.device)
        self._config = config
        self.post = post
        self.status: str = "idle"
        self._frame: int = 1
        self.env_intensity: float = 1.0
        self.env_rotation: float = 0.0
        self._listeners: Dict[Event, List[Callable]] = {}
        self._scene_data: Optional[SceneData] = None
        self._rebuild()

    # ------------------------------------------------------------- config

    @property
    def config(self) -> RenderConfig:
        return self._config

    @config.setter
    def config(self, value: RenderConfig) -> None:
        self._config = value
        self._rebuild()
        self.reset()

    def _rebuild(self) -> None:
        c = self._config
        if c.blue_noise:
            raise NotImplementedError("blue-noise AA jitter is not ported yet (ROADMAP.md)")
        if c.sort_window:
            raise NotImplementedError("windowed binning sort is not ported yet (ROADMAP.md)")
        resolve_intersector(c.intersector, 0)  # rejects unknown names
        self._step = make_frame_step(
            c.scaled_width, c.scaled_height, aspect=c.width / c.height,
            samples_per_frame=c.samples_per_frame, max_bounces=c.max_bounces,
            accumulate_frames=c.accumulate, intersector=c.intersector,
            sort_bounces=c.sort_bounces, tile_rays=c.tile_rays,
        )
        self._acc = self._zero_acc()

    def _zero_acc(self) -> torch.Tensor:
        c = self._config
        return torch.zeros((c.scaled_height, c.scaled_width, 3), dtype=torch.float32,
                           device=self.device)

    # ------------------------------------------------------------- events

    def on(self, event: Event, callback: Callable) -> Callable:
        self._listeners.setdefault(event, []).append(callback)
        return lambda: self._listeners[event].remove(callback)

    def emit(self, event: Event, *args) -> None:
        for cb in list(self._listeners.get(event, [])):
            cb(*args)

    # ------------------------------------------------------------- state

    @property
    def frame(self) -> int:
        return self._frame

    @frame.setter
    def frame(self, value: int) -> None:
        self._frame = value
        if self._frame > self._config.frames:
            self.status = "idle"
            self.emit("complete")

    @property
    def progress(self) -> float:
        return self._frame / (self._config.frames + 1)

    @property
    def samples(self) -> int:
        """Accumulated samples per pixel so far ((frame-1) * spp)."""
        return (self._frame - 1) * self._config.samples_per_frame

    def start(self) -> None:
        if self.status != "sampling":
            self.status = "sampling"
            self.emit("start")

    def pause(self) -> None:
        if self.status == "sampling":
            self.status = "paused"
            self.emit("pause")

    def reset(self, *, keep_paused: bool = False) -> None:
        self._acc = self._zero_acc()
        self._frame = 1
        self.emit("reset")
        if not (keep_paused and self.status == "paused"):
            self.status = "sampling"
            self.emit("start")

    # ------------------------------------------------------------- render

    def _compile_scene(self) -> None:
        if self._scene_data is None or self.scene.needs_update:
            self._scene_data = self.scene.compile(device=self.device)

    @property
    def scene_data(self) -> SceneData:
        self._compile_scene()
        return self._scene_data

    def _params(self) -> RenderParams:
        return RenderParams.create(self.camera, frame=self._frame,
                                   env_intensity=self.env_intensity,
                                   env_rotation=self.env_rotation)

    def render(self) -> None:
        """Advance one progressive frame (the reference's per-rAF render())."""
        self._compile_scene()
        if not (self.status == "sampling" and self._frame <= self._config.frames):
            return
        self._step(self._scene_data, self._params(), self._acc)
        self.frame = self._frame + 1
        self.emit("progress", self.progress)

    def render_all(self) -> torch.Tensor:
        """Run the full progressive budget; returns the raw accumulation."""
        if self.status == "idle":
            self.reset()
        while self.status == "sampling" and self._frame <= self._config.frames:
            self.render()
        return self.accumulation

    # ------------------------------------------------------------- output

    @property
    def accumulation(self) -> torch.Tensor:
        """Raw accumulated radiance at render resolution (h, w, 3)."""
        return self._acc

    def display(self) -> torch.Tensor:
        """Post-processed display image at full resolution (upscale ->
        denoise -> tonemap)."""
        c = self._config
        return postprocess(self._acc, self.post, c.height, c.width)

    def screenshot(self, path: str) -> None:
        """Save the display image as PNG (reference: canvas.toDataURL)."""
        from ..io.image import write_png

        write_png(path, np.asarray(self.display().cpu()), flip_vertical=True)
