"""Viewer session: owns the Renderer + orbit rig + background render loop.

The port of `tpu_pathtracer.viewer.session`, the server-side equivalent of
the reference's main.ts wiring — the PARAMS object and every Tweakpane
binding (src/main.ts:83-356), the rAF render loop (src/main.ts:387-400),
OrbitControls-reset-on-change (src/main.ts:366-371), scene/env import
(src/main.ts:209-301) and the screenshot path (src/main.ts:351-356) —
re-expressed as a thread-safe state machine over the port's Renderer, on
the `device` the session is given (the card unless the caller asks for
the CPU).  The loop waits for each frame on that device, and starts no
frame while a request waits for the session's lock; `stop()` joins it
within `STOP_TIMEOUT_S`.  An exception ends the loop, and `state()` (so
GET /state) and `stop()` raise it.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import os
import tempfile
import threading
import time
from typing import Dict, Optional

import numpy as np
import torch

from ..config import PostConfig, RenderConfig, ShardConfig, Tonemap
from ..render.renderer import Renderer
from ..render.timing import RollingAverage
from ..scene.envmap import gradient_sky
from ..scene.host import Scene, default_scene
from ..utils.orbit import OrbitCamera

STOP_TIMEOUT_S = 30.0

# Control surface with the reference UI's exact ranges (SURVEY.md §2 row 1;
# src/main.ts:167-349).  The page renders its panel from this spec.
PARAM_SPEC = [
    {"name": "scale", "kind": "select", "options": [0.1, 0.25, 0.5, 0.75, 1.0],
     "label": "Scale"},                                        # main.ts:167-178
    {"name": "frames", "kind": "range", "min": 2, "max": 2048, "step": 1,
     "label": "Frames"},                                       # main.ts:181
    {"name": "spp", "kind": "range", "min": 1, "max": 16, "step": 1,
     "label": "Samples / frame"},                              # main.ts:188
    {"name": "bounces", "kind": "range", "min": 0, "max": 10, "step": 1,
     "label": "Max bounces"},                                  # main.ts:195
    {"name": "accumulate", "kind": "bool", "label": "Accumulate"},
    {"name": "scene", "kind": "select", "options": ["default", "torus-knot"],
     "label": "Scene"},
    {"name": "env", "kind": "select",
     "options": ["gradient", "sky", "sky:elevation=10,turbidity=5",
                 "sky:elevation=60,turbidity=2", "black"],
     "label": "Environment"},                                  # main.ts:209-219
    {"name": "env_intensity", "kind": "range", "min": 0.0, "max": 4.0,
     "step": 0.01, "label": "Env intensity"},                  # main.ts:224
    {"name": "env_rotation", "kind": "range", "min": -180.0, "max": 180.0,
     "step": 1.0, "label": "Env rotation °"},                  # main.ts:233-237
    {"name": "env_importance", "kind": "bool", "label": "Env importance"},
    {"name": "fov", "kind": "range", "min": 10.0, "max": 120.0, "step": 1.0,
     "label": "FOV"},                                          # main.ts:315-319
    {"name": "focal_distance", "kind": "range", "min": 0.1, "max": 10.0,
     "step": 0.01, "label": "Focal distance"},                 # main.ts:323
    {"name": "aperture", "kind": "range", "min": 0.0, "max": 0.5,
     "step": 0.001, "label": "Aperture"},                      # main.ts:327
    {"name": "denoise", "kind": "bool", "label": "Denoise"},   # main.ts:334
    {"name": "tonemap", "kind": "select", "options": ["none", "aces", "reinhard"],
     "label": "Tonemap"},                                      # main.ts:337-349
    {"name": "timing", "kind": "bool", "label": "Per-pass timing"},
    {"name": "intersector", "kind": "select",
     "options": ["auto", "mt", "mt_pallas", "mt_stream", "bvh", "bvh8"], "label": "Intersector"},
    {"name": "blue_noise", "kind": "bool", "label": "Blue-noise AA"},
]


def _build_scene(name: str, env: np.ndarray) -> Scene:
    if name == "default":
        scene = default_scene(env)
    elif name == "torus-knot":
        from ..scene import primitives
        from ..scene.host import Material, Mesh, translation

        white = Material(color=(1.0, 1.0, 1.0), roughness=1.0, metalness=0.02,
                         specular_color=(1.0, 1.0, 1.0))
        gold = Material(color=(0.9, 0.7, 0.2), roughness=0.25, metalness=0.9,
                        specular_color=(1.0, 0.85, 0.5))
        scene = Scene()
        p, n, idx = primitives.plane(5.0, 5.0)
        scene.add(Mesh(p, n, idx, white,
                       transform=_rot_x(-math.pi / 2)))
        p, n, idx = primitives.torus_knot(0.45, 0.16, 128, 24)
        scene.add(Mesh(p, n, idx, gold, transform=translation(0.0, 0.7, 0.0)))
        scene.set_environment(env)
    else:
        raise ValueError(f"unknown scene {name!r}")
    return scene


def _rot_x(a: float) -> np.ndarray:
    from ..scene.host import rotation_x

    return rotation_x(a)


class ViewerSession:
    """Thread-safe interactive render session."""

    def __init__(
        self,
        width: int = 512,
        height: int = 512,
        config: Optional[RenderConfig] = None,
        post: Optional[PostConfig] = None,
        scene: Optional[Scene] = None,
        orbit: Optional[OrbitCamera] = None,
        shard: Optional[ShardConfig] = None,
        device="cuda",
    ) -> None:
        self.lock = threading.RLock()
        self._env_name = "gradient"
        self._scene_name = "default"
        self._env = gradient_sky(512, 1024)
        cfg = config or RenderConfig(width=width, height=height,
                                     scaling_factor=0.25)
        if scene is None:
            scene = _build_scene(self._scene_name, self._env)
        else:
            self._scene_name = "custom"
            scene.set_environment(self._env)
        self.orbit = orbit or OrbitCamera(target=(0.0, 0.5, 0.0), radius=4.0,
                                          azimuth=0.0, elevation=0.24,
                                          fov=45.0)
        self.renderer = Renderer(scene, self.orbit.camera(device), cfg,
                                 post or PostConfig(), device=device, shard=shard)
        self._scene_stats = self._compute_scene_stats(scene)

        # One monotonic version per distinct display image: bumped on every
        # rendered frame and on any post/param change.
        self.version = 0
        self.frame_ms = RollingAverage(30)  # fps meter (main.ts:94-97)
        self._png_cache: tuple[int, bytes] = (-1, b"")
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.loop_error: Optional[BaseException] = None
        self._queued = 0  # callers waiting for `lock` (see `_turn`)
        self._queue_lock = threading.Lock()

    # ----------------------------------------------------------- lifecycle

    def start(self) -> None:
        if self._thread is None:
            self._stop.clear()
            self.renderer.reset()
            self._thread = threading.Thread(target=self._loop, daemon=True,
                                            name="viewer-render-loop")
            self._thread.start()

    def stop(self) -> None:
        """Stop the loop and join it; raises RuntimeError if it outlives
        STOP_TIMEOUT_S or ended on an exception."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=STOP_TIMEOUT_S)
            if self._thread.is_alive():
                raise RuntimeError(f"viewer render loop still running {STOP_TIMEOUT_S} s "
                                   "after stop()")
            self._thread = None
        self._raise_loop_error()

    def _raise_loop_error(self) -> None:
        if self.loop_error is not None:
            raise RuntimeError(f"the viewer render loop failed: {self.loop_error!r}") \
                from self.loop_error

    def _loop(self) -> None:
        """The rAF-loop equivalent (main.ts:387-400), server-side."""
        try:
            while not self._stop.is_set():
                if self._queued:  # a request waits for the lock: it goes first
                    time.sleep(0.001)
                    continue
                did_work = False
                with self.lock:
                    r = self.renderer
                    if r.status == "sampling" and r.frame <= r.config.frames:
                        t0 = time.perf_counter()
                        r.render()
                        if r.device.type == "cuda":
                            torch.cuda.synchronize(r.device)
                        self.frame_ms.add_sample((time.perf_counter() - t0) * 1e3)
                        self.version += 1
                        did_work = True
                if not did_work:
                    time.sleep(0.03)
        except Exception as e:  # the loop ends; state() and stop() raise it
            self.loop_error = e

    @contextlib.contextmanager
    def _turn(self):
        """`lock`, for a caller other than the render loop.  The loop takes
        the lock again as soon as a frame ends, so a caller that only
        waited on it could wait several frames; the loop instead starts no
        frame while one is queued here."""
        with self._queue_lock:
            self._queued += 1
        try:
            with self.lock:
                yield
        finally:
            with self._queue_lock:
                self._queued -= 1

    # ----------------------------------------------------------- queries

    def _compute_scene_stats(self, scene: Scene) -> Dict[str, int]:
        # The console.table scene-compile stats (raytrace.ts:528-532).
        out = scene.gather_triangles()
        n_tris = int(out[0].shape[0])
        materials = out[-1]
        return {"triangles": n_tris, "materials": len(materials),
                "bvh_nodes": max(0, 2 * n_tris - 1)}

    def state(self) -> Dict:
        self._raise_loop_error()
        r = self.renderer
        c = r.config
        timings = {name: round(t.value, 1) for name, t in r.timings.items()}
        fm = self.frame_ms.value
        return {
            "status": r.status,
            "frame": r.frame,
            "frames": c.frames,
            "samples": r.samples,
            "progress": round(r.progress, 4),
            "version": self.version,
            "frame_ms": round(fm, 2),
            "fps": round(1000.0 / fm, 1) if fm > 0 else 0.0,
            "timings_us": timings,
            "timing_enabled": bool(r.enable_timing),
            "scene_stats": self._scene_stats,
            "params": self.params(),
            "resolution": {"width": c.width, "height": c.height,
                           "scaled_width": c.scaled_width,
                           "scaled_height": c.scaled_height},
        }

    def params(self) -> Dict:
        r = self.renderer
        c = r.config
        return {
            "scale": c.scaling_factor,
            "frames": c.frames,
            "spp": c.samples_per_frame,
            "bounces": c.max_bounces,
            "accumulate": c.accumulate,
            "scene": self._scene_name,
            "env": self._env_name,
            "env_intensity": r.env_intensity,
            "env_rotation": round(math.degrees(r.env_rotation), 2),
            "env_importance": r.env_importance,
            "fov": self.orbit.fov,
            "focal_distance": self.orbit.focal_distance,
            "aperture": self.orbit.aperture,
            "denoise": r.post.denoise,
            "tonemap": Tonemap(r.post.tonemap).name.lower(),
            "timing": r.enable_timing,
            "intersector": c.intersector,
            "blue_noise": c.blue_noise,
        }

    def frame_png(self) -> tuple[int, bytes]:
        """(version, png bytes) of the current display image, cached."""
        from ..io.image import encode_png

        with self._turn():
            v = self.version
            if self._png_cache[0] == v:
                return self._png_cache
            img = self.renderer.display().cpu().numpy()
            png = encode_png(img, flip_vertical=True)
            self._png_cache = (v, png)
            return self._png_cache

    # ----------------------------------------------------------- mutation

    def apply_params(self, updates: Dict) -> None:
        """Apply a partial PARAMS update (a Tweakpane binding change)."""
        with self._turn():
            r = self.renderer
            cfg_map = {"scale": "scaling_factor", "frames": "frames",
                       "spp": "samples_per_frame", "bounces": "max_bounces",
                       "accumulate": "accumulate", "intersector": "intersector",
                       "blue_noise": "blue_noise"}
            cfg_updates = {cfg_map[k]: updates[k] for k in cfg_map
                           if k in updates}
            if cfg_updates:
                r.set_option(**cfg_updates)

            post_updates = {}
            if "denoise" in updates:
                post_updates["denoise"] = bool(updates["denoise"])
            if "tonemap" in updates:
                post_updates["tonemap"] = Tonemap[str(updates["tonemap"]).upper()]
            if post_updates:
                r.post = dataclasses.replace(r.post, **post_updates)

            if "env_intensity" in updates:
                r.env_intensity = float(updates["env_intensity"])
                r.reset()
            if "env_rotation" in updates:
                r.env_rotation = math.radians(float(updates["env_rotation"]))
                r.reset()
            if "env_importance" in updates:
                r.set_env_importance(bool(updates["env_importance"]))
                r.reset()
            if "timing" in updates:
                r.set_timing(bool(updates["timing"]))

            cam_updates = {k: float(updates[k]) for k in
                           ("fov", "focal_distance", "aperture") if k in updates}
            if cam_updates:
                self.orbit = dataclasses.replace(self.orbit, **cam_updates)
                r.camera = self.orbit.camera(r.device)
                r.reset()

            if "scene" in updates:
                self.set_scene(str(updates["scene"]))
            if "env" in updates:
                self.set_env(str(updates["env"]))
            self.version += 1

    def apply_camera(self, op: Dict) -> None:
        """Orbit-controls op: rotate/zoom/pan → new camera + reset
        (main.ts:366-371)."""
        with self._turn():
            o = self.orbit
            if "rotate" in op:
                da, de = op["rotate"]
                o = o.rotate(float(da), float(de))
            if "zoom" in op:
                o = o.zoom(float(op["zoom"]))
            if "pan" in op:
                dx, dy = op["pan"]
                o = o.pan(float(dx), float(dy))
            self.orbit = o
            self.renderer.camera = o.camera(self.renderer.device)
            self.renderer.reset()
            self.version += 1

    def control(self, action: str) -> None:
        with self._turn():
            if action == "start":
                self.renderer.start()
            elif action == "pause":
                self.renderer.pause()
            elif action == "reset":
                self.renderer.reset()
            else:
                raise ValueError(f"unknown action {action!r}")
            self.version += 1

    # ----------------------------------------------------------- assets

    def set_scene(self, name: str) -> None:
        with self._turn():
            scene = _build_scene(name, self._env)
            self._scene_name = name
            self.renderer.scene = scene
            self._scene_stats = self._compute_scene_stats(scene)
            self.renderer.reset()
            self.version += 1

    def set_env(self, name: str) -> None:
        with self._turn():
            if name == "gradient":
                self._env = gradient_sky(512, 1024)
            elif name == "black":
                self._env = np.zeros((8, 16, 3), np.float32)
            elif name == "sky" or name.startswith("sky:"):
                from ..scene.sky import parse_sky_spec, sun_sky

                self._env = sun_sky(512, 1024, **parse_sky_spec(name))
            else:
                raise ValueError(f"unknown env {name!r}")
            self._env_name = name
            self.renderer.scene.set_environment(self._env)
            self.renderer.reset()
            self.version += 1

    def load_scene_glb(self, data: bytes, name: str = "imported") -> None:
        """glTF import with unit-scale normalization (main.ts:246-302)."""
        from ..io.gltf import load_gltf, normalize_meshes

        with tempfile.NamedTemporaryFile(suffix=".glb", delete=False) as f:
            f.write(data)
            path = f.name
        try:
            meshes = normalize_meshes(load_gltf(path))
        finally:
            os.unlink(path)
        with self._turn():
            scene = Scene()
            for m in meshes:
                scene.add(m)
            scene.set_environment(self._env)
            self._scene_name = name
            self.renderer.scene = scene
            self._scene_stats = self._compute_scene_stats(scene)
            self.renderer.reset()
            self.version += 1

    def load_env_hdr(self, data: bytes, name: str = "imported") -> None:
        from ..io.hdr import read_hdr

        with tempfile.NamedTemporaryFile(suffix=".hdr", delete=False) as f:
            f.write(data)
            path = f.name
        try:
            env = read_hdr(path)
        finally:
            os.unlink(path)
        with self._turn():
            self._env = np.asarray(env, np.float32)
            self._env_name = name
            self.renderer.scene.set_environment(self._env)
            self.renderer.reset()
            self.version += 1
