"""Milliseconds a frame in which the device was busy: the union of the
intervals of every device operation in the traced window, over the frames."""


def read(trace, counts):
    if not counts.get("frames") or not trace.ops:
        return None
    return 1e3 * trace.busy_s / counts["frames"]
