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
  * per-pass timing meters (raytrace / accumulate / fullscreen) with
    `enable_timing`, timed on the device (`render.timing.PassTimer`);
  * checkpoints: `save_state` / `load_state` write and read the JAX
    package's npz (acc, frame, frames, spp, with its dtypes), so a render
    saved by one package resumes in the other; `render_all` can save one
    every N frames;
  * the device scene is recompiled only when `scene.needs_update` is set.

Everything lives on the `device` the constructor is given, the card unless
the caller asks for the CPU.  `RenderConfig.intersector` chooses the
intersector as `ops.trace.resolve_intersector` does: 'auto' takes the MT
kernels up to 262,144 padded triangles and the fat-leaf BVH walk ('bvh8')
above.  `env_importance` (or `set_env_importance`) samples the environment
by its CDFs, and `RenderConfig.blue_noise` jitters AA by a 64x64
blue-noise table; either rebuilds the passes.

`shard=ShardConfig(tiles, samples)` renders on a (tiles, samples) mesh of
`torch.distributed` ranks (`parallel/`): every rank of the mesh runs the
same Renderer calls, holds its band of the accumulation and renders its
band of each frame (bit-equal to the unsharded frame over the tiles; the
sample shards averaged).  `accumulation`, `display`, `screenshot`,
`save_state` and `load_state` work on the whole image (assembled by an
all-reduce, so every rank of the mesh must call them together); only rank
0 writes files.  With `shard=None` or one rank the render is unsharded, as
in JAX; a mesh larger than the process group raises.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..config import PostConfig, RenderConfig
from ..ops.trace import accumulate as accumulate_op
from ..ops.trace import render_frame, resolve_intersector
from ..post.pipeline import postprocess
from ..scene.host import Scene
from ..scene.types import Camera, RenderParams, SceneData
from ..utils.bluenoise import blue_noise_table
from .timing import PassTimer

Event = str  # 'reset' | 'start' | 'pause' | 'progress' | 'complete'


def make_passes(width: int, height: int, aspect: float, samples_per_frame: int,
                max_bounces: int, accumulate: bool, env_importance: bool = False,
                intersector: str = "auto", blue_noise=None, sort_bounces=None,
                tile_rays=None, sort_window=None):
    """The progressive frame's two passes: raytrace (scene, params) -> frame
    image, and accumulate (acc, image, frame) -> acc, folding the image into
    `acc` in place (the JAX step donates its accumulator, so nothing else
    holds it).  The parameters are `make_frame_step`'s."""

    def raytrace(scene: SceneData, params: RenderParams) -> torch.Tensor:
        return render_frame(
            scene, params, width=width, height=height, aspect=aspect,
            samples_per_frame=samples_per_frame, max_bounces=max_bounces,
            env_importance=env_importance, intersector=intersector, blue_noise=blue_noise,
            sort_bounces=sort_bounces, tile_rays=tile_rays, sort_window=sort_window,
        )

    def accumulate_pass(acc: torch.Tensor, img: torch.Tensor, frame: int) -> torch.Tensor:
        return accumulate_op(acc, img, frame, enabled=accumulate, out=acc)

    return raytrace, accumulate_pass


def make_frame_step(width: int, height: int, aspect: float, samples_per_frame: int,
                    max_bounces: int, accumulate: bool, env_importance: bool = False,
                    intersector: str = "auto", blue_noise=None, sort_bounces=None,
                    tile_rays=None, sort_window=None):
    """The progressive step, with the JAX package's parameters: render one
    frame and fold it into `acc` in place (`make_passes` run back to
    back)."""
    raytrace, accumulate_pass = make_passes(
        width, height, aspect, samples_per_frame, max_bounces, accumulate, env_importance,
        intersector, blue_noise, sort_bounces, tile_rays, sort_window)

    def step(scene: SceneData, params: RenderParams, acc: torch.Tensor) -> torch.Tensor:
        return accumulate_pass(acc, raytrace(scene, params), params.frame)

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
        self.device = torch.device(device)
        self.shard = shard
        self._mesh = None
        if shard is not None and shard.num_devices > 1:
            from ..parallel.mesh import make_mesh

            self._mesh = make_mesh(tiles=shard.tiles, samples=shard.samples, device=self.device)
            if not self._mesh.in_mesh:
                raise ValueError(f"rank {self._mesh.rank} is outside the "
                                 f"{shard.tiles}x{shard.samples} mesh")
            self.device = self._mesh.device
        self.scene = scene
        self.camera = camera.to(self.device)
        self._config = config
        self.post = post
        self.env_importance = bool(env_importance)
        self.enable_timing = bool(enable_timing)
        self.status: str = "idle"
        self._frame: int = 1
        self.env_intensity: float = 1.0
        self.env_rotation: float = 0.0
        self.timings: Dict[str, PassTimer] = {
            name: PassTimer(name, self.device) for name in ("raytrace", "accumulate", "fullscreen")
        }
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
        resolve_intersector(c.intersector, 0)  # rejects unknown names
        bn = None
        if c.blue_noise:
            bn = torch.from_numpy(blue_noise_table(64)).to(self.device)
        if self._mesh is not None:
            from ..parallel.sharded import make_sharded_passes

            # JAX's sharded step takes no sort_bounces, tile_rays or
            # sort_window: the environment's TPT_* settings apply
            self._raytrace, self._accumulate = make_sharded_passes(
                self._mesh, width=c.scaled_width, height=c.scaled_height,
                aspect=c.width / c.height, samples_per_frame=c.samples_per_frame,
                max_bounces=c.max_bounces, accumulate=c.accumulate,
                env_importance=self.env_importance, intersector=c.intersector, blue_noise=bn)
        else:
            self._raytrace, self._accumulate = make_passes(
                c.scaled_width, c.scaled_height, aspect=c.width / c.height,
                samples_per_frame=c.samples_per_frame, max_bounces=c.max_bounces,
                accumulate=c.accumulate, env_importance=self.env_importance,
                intersector=c.intersector, blue_noise=bn, sort_bounces=c.sort_bounces,
                tile_rays=c.tile_rays, sort_window=c.sort_window,
            )
        self._timed_warm = False
        self._acc = self._zero_acc()

    def _zero_acc(self) -> torch.Tensor:
        c = self._config
        if self._mesh is not None:
            from ..parallel.sharded import zeros_acc

            return zeros_acc(self._mesh, c.scaled_height, c.scaled_width)
        return torch.zeros((c.scaled_height, c.scaled_width, 3), dtype=torch.float32,
                           device=self.device)

    # convenience setters mirroring the reference UI's bindings; each resets
    # the progressive render as the reference does.
    def set_option(self, **kwargs) -> None:
        cfg_fields = {f.name for f in dataclasses.fields(RenderConfig)}
        cfg_updates = {k: v for k, v in kwargs.items() if k in cfg_fields}
        if cfg_updates:
            self.config = dataclasses.replace(self._config, **cfg_updates)
        post_fields = {f.name for f in dataclasses.fields(PostConfig)}
        post_updates = {k: v for k, v in kwargs.items() if k in post_fields}
        if post_updates:
            self.post = dataclasses.replace(self.post, **post_updates)
        for k in set(kwargs) - set(cfg_updates) - set(post_updates):
            if k in ("env_intensity", "env_rotation"):
                setattr(self, k, float(kwargs[k]))
                self.reset()
            else:
                raise AttributeError(f"unknown option {k}")

    def set_env_importance(self, enabled: bool) -> None:
        """Toggle env CDF importance sampling; a change rebuilds the passes
        (and clears the accumulation), as the JAX package's does."""
        enabled = bool(enabled)
        if enabled != self.env_importance:
            self.env_importance = enabled
            self._rebuild()

    def set_timing(self, enabled: bool) -> None:
        """Toggle the per-pass timing meters."""
        self.enable_timing = bool(enabled)

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
        self._render_frames(1)

    def _render_frames(self, n: int) -> None:
        """Advance up to `n` progressive frames, then emit one progress event."""
        self._compile_scene()
        if not (self.status == "sampling" and self._frame <= self._config.frames):
            return
        for _ in range(min(n, self._config.frames - self._frame + 1)):
            params = self._params()
            if self.enable_timing:
                if not self._timed_warm:
                    # One untimed run first, so that the rolling averages hold
                    # steady-state numbers (the first launch builds the kernels);
                    # its result is dropped, the accumulation is untouched.
                    accumulate_op(self._acc, self._raytrace(self._scene_data, params),
                                  params.frame, enabled=self._config.accumulate)
                    self._timed_warm = True
                img = self.timings["raytrace"].time_device(self._raytrace, self._scene_data,
                                                           params)
                self.timings["accumulate"].time_device(self._accumulate, self._acc, img,
                                                       params.frame)
            else:
                self._accumulate(self._acc, self._raytrace(self._scene_data, params),
                                 params.frame)
            self.frame = self._frame + 1
        self.emit("progress", self.progress)

    def render_all(self, *, checkpoint_path: Optional[str] = None,
                   checkpoint_every: int = 0) -> torch.Tensor:
        """Run the full progressive budget; returns the raw accumulation.
        With `checkpoint_path` and `checkpoint_every=N` the state is saved
        every N frames and at the end, so a render that is stopped resumes
        from its last checkpoint through `load_state`.  Sharded (and not
        timed), progress events and checkpoints come after chunks of
        min(remaining, checkpoint_every or 32) frames, JAX's sharded
        schedule; the frames of a chunk still run one by one."""
        if self.status == "idle":
            self.reset()
        sharded = self._mesh is not None and not self.enable_timing
        chunk = (checkpoint_every or 32) if sharded else 1
        while self.status == "sampling" and self._frame <= self._config.frames:
            self._render_frames(chunk)
            if checkpoint_path and checkpoint_every and (
                    sharded or (self._frame - 1) % checkpoint_every == 0):
                self.save_state(checkpoint_path)
        if checkpoint_path and checkpoint_every:
            self.save_state(checkpoint_path)
        return self.accumulation

    # ------------------------------------------------------------- output

    @property
    def accumulation(self) -> torch.Tensor:
        """Raw accumulated radiance at render resolution (h, w, 3); sharded,
        the whole image assembled from the ranks' bands."""
        if self._mesh is not None:
            from ..parallel.sharded import assemble

            return assemble(self._mesh, self._acc, self._config.scaled_height)
        return self._acc

    @property
    def _writes_files(self) -> bool:
        return self._mesh is None or self._mesh.rank == 0

    def display(self) -> torch.Tensor:
        """Post-processed display image at full resolution (upscale ->
        denoise -> tonemap)."""
        c = self._config

        def run():
            return postprocess(self.accumulation, self.post, c.height, c.width)

        if self.enable_timing:
            return self.timings["fullscreen"].time_device(run)
        return run()

    def screenshot(self, path: str) -> None:
        """Save the display image as PNG (reference: canvas.toDataURL)."""
        from ..io.image import write_png

        img = self.display()
        if self._writes_files:
            write_png(path, np.asarray(img.cpu()), flip_vertical=True)

    # ------------------------------------------------------------- resume

    def save_state(self, path: str) -> None:
        """Checkpoint the progressive render (accumulation and frame
        counter) as the JAX package's npz: acc (h, w, 3) float32, frame,
        frames and spp as integers."""
        acc = self.accumulation.detach().cpu().numpy()
        if self._writes_files:
            np.savez(path, acc=acc, frame=self._frame, frames=self._config.frames,
                     spp=self._config.samples_per_frame)

    def load_state(self, path: str) -> None:
        data = np.load(path)
        acc = np.ascontiguousarray(data["acc"], np.float32)
        if self._mesh is not None:
            from ..parallel.sharded import acc_sharding

            acc = np.ascontiguousarray(acc[acc_sharding(self._mesh, acc.shape[0])])
        self._acc = torch.from_numpy(acc).to(self.device)
        self._frame = int(data["frame"])
        self.status = "sampling" if self._frame <= self._config.frames else "idle"
