"""Milliseconds of `backward()` an optimiser step, by CUDA events around it
in each step of the traced window (autograd layer)."""


def read(trace, counts):
    spans = trace.timed_ms.get("backward")
    if not spans:
        return None
    return sum(spans) / len(spans)
