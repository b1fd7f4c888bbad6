"""Spans and the device trace of a traced run (`--trace 1`).

With tracing off every span is a no-op.  With it on, the window runs under
the profiler, which records the device's activity; each span records its
host interval, and a span asked to be timed also CUDA events around its
work.  After the window, `summary()` reduces the trace to what the
per-layer readers read.
"""

from __future__ import annotations

import bisect
import contextlib
import dataclasses
import time

from . import stats

@dataclasses.dataclass
class DeviceOp:
    name: str
    start_us: float
    end_us: float
    kind: str  # "kernel", "memcpy" or "memset"


@dataclasses.dataclass
class Trace:
    """A traced window, reduced: `ops` the device activity inside it,
    `busy_s` the union of their intervals, `window_s` the window's host
    length, `spans` {name: [(start_us, end_us)]} the harness's host spans,
    `timed_ms` {name: [ms]} the CUDA-event lengths of timed spans."""

    ops: list
    busy_s: float
    window_s: float
    window_us: tuple
    spans: dict
    timed_ms: dict

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the idle time of
        the device summed by the host span it fell in, largest first."""
        by_op: dict = {}
        for op in self.ops:
            by_op[op.name[:160]] = by_op.get(op.name[:160], 0.0) + (op.end_us - op.start_us) / 1e6
        idle: dict = {}
        spans = sorted((s, e, n) for n, ivs in self.spans.items() if n != "window" for s, e in ivs)
        starts = [s for s, _, _ in spans]
        for s, e in stats.gaps([(o.start_us, o.end_us) for o in self.ops], *self.window_us):
            mid = 0.5 * (s + e)  # named by the innermost span that holds it
            name = "other"
            i = bisect.bisect_right(starts, mid) - 1
            for j in range(i, max(i - 4, -1), -1):  # spans nest at most a few deep
                if spans[j][1] >= mid:
                    name = spans[j][2]
                    break
            idle[name] = idle.get(name, 0.0) + (e - s) / 1e6
        order = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]
        return {"device_ops": order(by_op), "idle_gaps": order(idle)}


def _kind(name: str) -> str:
    low = name.lower()
    if low.startswith("memcpy"):
        return "memcpy"
    if low.startswith("memset"):
        return "memset"
    return "kernel"


class Tracer:
    """Spans for the window; the device trace around it when `enabled`.

    The trace is the profiler's device activity alone (kernels, copies,
    fills: CUPTI through kineto), so the host pays no cost a torch
    operation.  Host spans are read from the wall clock the trace's
    timestamps are in (Unix time); a timed span also records CUDA events."""

    def __init__(self, enabled: bool, cuda: bool):
        self.enabled = enabled
        self.cuda = cuda
        self._prof = None
        self._result = None
        self._events: dict = {}
        self._spans: list = []
        self.active = False

    def __enter__(self):
        if self.enabled:
            import torch
            from torch.autograd import profiler

            if self.cuda:
                torch.cuda.synchronize()
            self._prof = profiler.profile(use_kineto=True, use_cpu=not self.cuda,
                                          use_device="cuda" if self.cuda else None)
            self._prof.__enter__()
            self.active = True
        return self

    def __exit__(self, *exc):
        self.active = False
        if self._prof is not None:
            import torch

            if self.cuda:
                torch.cuda.synchronize()
            # the raw events: the profiler's own parse into FunctionEvents
            # costs minutes for a window of frames
            self._result = torch.autograd._disable_profiler()
        return False

    def span(self, name: str, timed: bool = False):
        """A host span (and, if `timed`, CUDA events) while the profiler runs;
        a no-op otherwise."""
        if not self.active:
            return contextlib.nullcontext()
        return self._span(name, timed)

    @contextlib.contextmanager
    def _span(self, name, timed):
        import torch

        start_ns = time.time_ns()
        if timed and self.cuda:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            yield
            end.record()
            self._events.setdefault(name, []).append((start, end))
        else:
            yield
        self._spans.append((name, start_ns / 1e3, time.time_ns() / 1e3))

    def summary(self) -> Trace:
        """Reduce the trace of the window (the span named "window")."""
        from torch.autograd import DeviceType

        spans: dict = {}
        for name, start, end in self._spans:
            spans.setdefault(name, []).append((start, end))
        window = spans["window"][0]
        ops = []
        for evt in self._result.events():
            if evt.device_type() != DeviceType.CUDA:
                continue
            start = evt.start_ns() / 1e3
            end = start + evt.duration_ns() / 1e3
            if end > max(start, window[0]) and start < window[1]:
                ops.append(DeviceOp(evt.name(), start, end, _kind(evt.name())))
        busy = stats.covered([(o.start_us, o.end_us) for o in ops], *window) / 1e6
        timed = {name: [s.elapsed_time(e) for s, e in pairs] for name, pairs in self._events.items()}
        return Trace(ops, busy, (window[1] - window[0]) / 1e6, window, spans, timed)
