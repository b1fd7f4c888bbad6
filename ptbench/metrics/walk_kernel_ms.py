"""Milliseconds a frame of the MT walk kernels (csrc/nf_walk.cu,
stream_walk.cu, cond_walk.cu, mxu_walk.cu, r2_walk.cu, mt_shade.cu), by
their names in the device trace."""

import re

WALKS = re.compile(r"\b(nf|stream|cond|mxu|r2)_walk_kernel\b|\bmt_(list|cond|r2)_kernel\b"
                   r"|\bmxu_cond_kernel\b")


def read(trace, counts):
    walks = [op for op in trace.ops if op.kind == "kernel" and WALKS.search(op.name)]
    if not counts.get("frames") or not walks:
        return None
    return sum(op.end_us - op.start_us for op in walks) / 1e3 / counts["frames"]
