"""Milliseconds of `display()` and the readback of its image, by CUDA
events around both in each frame of the traced window (post layer)."""


def read(trace, counts):
    spans = trace.timed_ms.get("display")
    if not spans:
        return None
    return sum(spans) / len(spans)
