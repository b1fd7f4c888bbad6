"""Spans and counters of the frame path: the port's one in-program recorder.

The recorder records exactly while a torch profiler records in the calling
thread (`torch.autograd._profiler_enabled()`).  It starts afresh at the
first record of a profiling session that follows a record tried with no
profiler running (any frame rendered between two profiled windows is one);
two sessions with no such call between them share one record.  So a
profiled run (`cli render --profile`, a benchmark's traced window) carries
the frame path's spans and counters, and every other run pays one check and
a shared null context a span: no tensor is allocated and no walk is handed
a stats buffer.  Spans and counts are kept in memory, at most
`MAX_RECORDS` of each; the recorder serves one thread at a time.

  * `span(name)`: a context manager; a span records its name, its start
    and end (microseconds on `time.time_ns()`, the Unix clock of the
    profiler's device events), the index of the span open around it
    (-1: none), and a frame id: that of the `frame` span open around it,
    else of the last `frame` span begun (-1: none).  `span(name,
    timed=True)` also records CUDA events around the block (`DeviceTiming`,
    the port's one maker of timing events), read when the spans are;
  * `spanned(name)`: a decorator putting each call in such a span;
  * `sync(n)`: a `sync` span around a block that makes the host wait for
    the device `n` times (a host read of a device value, a copy from host
    memory to the card), adding `n` to the counter `syncs`;
  * `count(name, n, scale)`: adds `scale * n` to a counter; `n` is a host
    integer or a device tensor, summed on its device only when the
    counters are read (`counters()`), so a count adds no host wait;
  * `ints(device, size)`: a zeroed int32 slice of a preallocated buffer,
    for a kernel's stats, or None when the recorder is off or full;
  * `recorded()`, `counters()`: the spans (`Span`) and counts (`Count`) of
    the session; `write_jsonl(path)` writes both, one a line.
"""

from __future__ import annotations

import contextlib
import functools
import json
import time
from typing import NamedTuple

import torch

MAX_RECORDS = 1 << 19  # spans, and counts, kept a session
BUFFER_INTS = 1 << 22  # int32 a stats buffer (16 MB); a session allocates at most MAX_BUFFERS
MAX_BUFFERS = 8

_profiling = torch.autograd._profiler_enabled


class Span(NamedTuple):
    name: str
    start_us: float
    end_us: float
    parent: int  # index of the span open around this one, -1 for none
    frame: int  # frame id, -1 before the first frame
    device_ms: float | None  # CUDA-event milliseconds of a timed span


class Count(NamedTuple):
    name: str
    t_us: float
    frame: int
    value: int


class DeviceTiming:
    """CUDA events on `device`'s current stream (the current device's if
    None): `start` recorded when made, `end` by `stop()`; `ms()` waits for
    `end` and returns the milliseconds between the two."""

    __slots__ = ("stream", "start", "end")

    def __init__(self, device=None):
        self.stream = torch.cuda.current_stream(device)
        self.start = torch.cuda.Event(enable_timing=True)
        self.end = torch.cuda.Event(enable_timing=True)
        self.start.record(self.stream)

    def stop(self) -> None:
        self.end.record(self.stream)

    def ms(self) -> float:
        self.end.synchronize()
        return self.start.elapsed_time(self.end)


@contextlib.contextmanager
def device_timed(device=None):
    """`DeviceTiming` around the work enqueued inside the block."""
    timing = DeviceTiming(device)
    yield timing
    timing.stop()


class _Recorder:
    def __init__(self):
        self.live = False
        self.clear()

    def clear(self) -> None:
        self.spans: list = []  # [name, start_ns, end_ns, parent, frame, DeviceTiming | None]
        self.open: list = []  # indices of the open spans, innermost last
        self.counts: list = []  # [name, t_ns, frame, n (int or tensor), scale]
        self.frame = -1
        self.frames = 0
        self.buffers: dict = {}  # device -> [buffer, ints used]
        self.n_buffers = 0

    def begin(self) -> None:
        """A record while the profiler runs: the first since one was tried
        without it drops the last session's records."""
        if not self.live:
            self.clear()
            self.live = True

    def enter(self, name: str, timed: bool, device):
        self.begin()
        if len(self.spans) >= MAX_RECORDS:
            return -1
        if name == "frame":
            self.frame = self.frames
            self.frames += 1
        index = len(self.spans)
        parent = self.open[-1] if self.open else -1
        self.spans.append([name, time.time_ns(), 0, parent, self.frame,
                           DeviceTiming(device) if timed else None])
        self.open.append(index)
        return index

    def leave(self, index: int) -> None:
        if index < 0 or not self.open or self.open[-1] != index:
            return  # dropped, or begun before this session
        self.open.pop()
        entry = self.spans[index]
        if entry[5] is not None:
            entry[5].stop()
        entry[2] = time.time_ns()

    def add(self, name: str, n, scale: int) -> None:
        self.begin()
        if len(self.counts) < MAX_RECORDS:
            self.counts.append([name, time.time_ns(), self.frame, n, scale])

    def ints(self, device, size: int):
        self.begin()
        slot = self.buffers.get(device)
        if slot is None or slot[1] + size > slot[0].numel():
            if self.n_buffers >= MAX_BUFFERS:
                return None
            self.n_buffers += 1
            slot = self.buffers[device] = [
                torch.zeros((max(BUFFER_INTS, size),), dtype=torch.int32, device=device), 0]
        buf, used = slot
        slot[1] = used + size
        return buf[used:used + size]


_REC = _Recorder()


class _Scope:
    """An open span of the recorder."""

    __slots__ = ("name", "timed", "device", "index")

    def __init__(self, name, timed, device):
        self.name, self.timed, self.device = name, timed, device

    def __enter__(self):
        self.index = _REC.enter(self.name, self.timed, self.device)
        return self

    def __exit__(self, *exc):
        _REC.leave(self.index)
        return False


_OFF = contextlib.nullcontext()


def span(name: str, timed: bool = False, device=None):
    """A span named `name` while the recorder is on; `timed` adds CUDA
    events on `device` (a CUDA device) around the block."""
    if not _profiling():
        _REC.live = False
        return _OFF
    return _Scope(name, timed, device)


def spanned(name: str):
    """A decorator: each call of the function inside a span named `name`."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return call
    return wrap


def sync(n: int = 1):
    """A `sync` span around a block that makes the host wait for the device
    `n` times, counted in `syncs`; nothing for n = 0."""
    if n and _profiling():
        _REC.add("syncs", n, 1)
        return _Scope("sync", False, None)
    if n:
        _REC.live = False
    return _OFF


def count(name: str, n=1, scale: int = 1) -> None:
    """Add `scale * n` to the counter `name` (`n` a host integer or a
    device tensor, summed when the counters are read)."""
    if not _profiling():
        _REC.live = False
        return
    _REC.add(name, n, scale)


def ints(device, size: int):
    """A zeroed (size,) int32 slice of a preallocated buffer on `device`
    while the recorder is on and has room; else None."""
    if not _profiling():
        _REC.live = False
        return None
    return _REC.ints(torch.device(device), size)


def recorded() -> list:
    """The session's spans, in the order they began (`Span`); a span still
    open ends now.  A timed span's CUDA events are read here, once."""
    out = []
    for entry in _REC.spans:
        name, start, end, parent, frame, timing = entry
        if isinstance(timing, DeviceTiming):
            timing = timing.ms() if end else None
            if end:
                entry[5] = timing
        out.append(Span(name, start / 1e3, (end or time.time_ns()) / 1e3, parent, frame, timing))
    return out


def counters() -> list:
    """The session's counts (`Count`); device tensors are summed here, with
    one host read a device."""
    by_device: dict = {}
    for c in _REC.counts:
        if isinstance(c[3], torch.Tensor):
            by_device.setdefault(c[3].device, []).append(c)
    for group in by_device.values():
        sums = torch.stack([c[3].sum(dtype=torch.int64) for c in group]).tolist()
        for c, total in zip(group, sums):
            c[3] = total
    if by_device:
        _REC.buffers.clear()
    return [Count(name, t / 1e3, frame, n * scale) for name, t, frame, n, scale in _REC.counts]


def totals(counts=None) -> dict:
    """{counter: its total} over `counts` (default: the session's)."""
    out: dict = {}
    for c in counters() if counts is None else counts:
        out[c.name] = out.get(c.name, 0) + c.value
    return out


def write_jsonl(path) -> None:
    """The session's spans, one a line (name, parent, frame, start_us and
    end_us on the device trace's clock, device_ms where timed), then one
    line a counter with its total."""
    with open(path, "w") as f:
        for s in recorded():
            line = {"name": s.name, "parent": s.parent, "frame": s.frame,
                    "start_us": s.start_us, "end_us": s.end_us}
            if s.device_ms is not None:
                line["device_ms"] = s.device_ms
            f.write(json.dumps(line) + "\n")
        for name, value in totals().items():
            f.write(json.dumps({"counter": name, "value": value}) + "\n")
