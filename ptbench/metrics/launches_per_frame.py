"""Device kernels launched a frame in the traced window (frame layer: host
dispatch)."""


def read(trace, counts):
    kernels = sum(1 for op in trace.ops if op.kind == "kernel")
    if not counts.get("frames") or not kernels:
        return None
    return kernels / counts["frames"]
