"""The program's own spans and counters in the traced window, as the
readers of the `program_span` and `program_counter` metrics read them.

The program records them (`tpu_pathtracer_torch.utils.spans`) while the
profiler of a traced run records, on the clock of the device trace.  A
reader keeps the spans and counts that lie inside `trace.window_us`.  A
span's self time is its length less the lengths of its child spans.  A
program without the recorder, or a window without such records, gives
None: the metric is left out."""

from __future__ import annotations


def recorder():
    """The program's recorder module, or None if the program has none."""
    try:
        from tpu_pathtracer_torch.utils import spans
    except ImportError:
        return None
    return spans


def spans_in(trace):
    """[(span, self time in us)] of the recorded spans inside the window,
    or None without the recorder."""
    rec = recorder()
    if rec is None:
        return None
    recorded = rec.recorded()
    children = [0.0] * len(recorded)
    for s in recorded:
        if s.parent >= 0:
            children[s.parent] += s.end_us - s.start_us
    w0, w1 = trace.window_us
    return [(s, s.end_us - s.start_us - c) for s, c in zip(recorded, children)
            if w0 <= s.start_us and s.end_us <= w1]


def self_ms(trace, name: str):
    """Milliseconds of self time of the spans named `name` in the window."""
    got = [us for s, us in spans_in(trace) or () if s.name == name]
    return sum(got) / 1e3 if got else None


def total_ms(trace, name: str):
    """Milliseconds of the spans named `name` in the window, their child
    spans included."""
    got = [s.end_us - s.start_us for s, _ in spans_in(trace) or () if s.name == name]
    return sum(got) / 1e3 if got else None


def device_ms(trace, name: str):
    """CUDA-event milliseconds of the timed spans named `name` in the
    window."""
    got = [s.device_ms for s, _ in spans_in(trace) or ()
           if s.name == name and s.device_ms is not None]
    return sum(got) if got else None


def counter(trace, name: str):
    """The total of the counter `name` over the counts made in the window."""
    rec = recorder()
    if rec is None:
        return None
    w0, w1 = trace.window_us
    got = [c.value for c in rec.counters() if c.name == name and w0 <= c.t_us <= w1]
    return sum(got) if got else None


def per(value, n):
    """`value` over `n` (frames or steps), or None if either is missing."""
    if value is None or not n:
        return None
    return value / n
