"""Structured JSONL metrics: the observability spine (the port of
`tpu_pathtracer.render.metrics`, record for record).

The reference surfaces metrics live in its UI (fps graph, per-pass µs,
progress string; src/main.ts:94-138) and through a renderer event bus
(src/renderer.ts:446-468).  The headless equivalent is a JSONL stream: one
record per event with timestamps, frame counters, throughput, and per-pass
timings — machine-parseable for dashboards and regression tracking.
"""

from __future__ import annotations

import json
import sys
import time
from typing import IO, Optional


class MetricsLogger:
    """Subscribes to a Renderer's event bus and emits JSONL records.

    Events mirrored from the reference bus: reset/start/pause/progress/
    complete; `progress` records add frame/spp/instantaneous throughput.
    """

    def __init__(self, renderer, stream: Optional[IO] = None,
                 path: Optional[str] = None) -> None:
        self.renderer = renderer
        if path is not None:
            self._file = open(path, "a")
            self.stream = self._file
        else:
            self._file = None
            self.stream = stream if stream is not None else sys.stderr
        self._t0 = time.time()
        self._last_frame_t = None
        self._unsubs = [
            renderer.on("reset", lambda *a: self._emit("reset")),
            renderer.on("start", lambda *a: self._emit("start")),
            renderer.on("pause", lambda *a: self._emit("pause")),
            renderer.on("progress", self._on_progress),
            renderer.on("complete", lambda *a: self._emit("complete")),
        ]

    def _emit(self, event: str, **extra) -> None:
        rec = {
            "ts": round(time.time() - self._t0, 4),
            "event": event,
            "frame": self.renderer.frame,
            "status": self.renderer.status,
        }
        rec.update(extra)
        self.stream.write(json.dumps(rec) + "\n")
        self.stream.flush()

    def _on_progress(self, progress: float) -> None:
        now = time.time()
        extra = {
            "progress": round(progress, 4),
            "spp": self.renderer.samples,
        }
        c = self.renderer.config
        if self._last_frame_t is not None:
            dt = now - self._last_frame_t
            if dt > 0:
                rays = (c.scaled_width * c.scaled_height
                        * c.samples_per_frame * c.max_bounces)
                extra["frame_ms"] = round(dt * 1e3, 3)
                extra["rays_per_s"] = round(rays / dt)
        self._last_frame_t = now
        timings = {
            name: round(t.value, 1)
            for name, t in self.renderer.timings.items()
            if t.value > 0
        }
        if timings:
            extra["pass_us"] = timings
        self._emit("progress", **extra)

    def close(self) -> None:
        for unsub in self._unsubs:
            try:
                unsub()
            except ValueError:
                pass
        if self._file is not None:
            self._file.close()
