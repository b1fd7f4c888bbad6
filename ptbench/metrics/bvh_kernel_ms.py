"""Milliseconds a frame of the fat-leaf BVH walk kernel (csrc/fat_walk.cu),
by its name in the device trace: the bvh walk layer's device time alone
(bvh walk layer)."""

import re

WALK = re.compile(r"\bfat_walk_kernel\b")


def read(trace, counts):
    walks = [op for op in trace.ops if op.kind == "kernel" and WALK.search(op.name)]
    if not counts.get("frames") or not walks:
        return None
    return sum(op.end_us - op.start_us for op in walks) / 1e3 / counts["frames"]
