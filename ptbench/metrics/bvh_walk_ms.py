"""Host milliseconds a frame inside the fat-leaf BVH walk (`bvh8`,
`_bvh_fat_intersect_impl`: its steps, host reads and compactions): the
program's `walk.fat` spans with their children over the frames of the
traced window (bvh walk layer)."""

from ptbench import program_spans


def read(trace, counts):
    return program_spans.per(program_spans.total_ms(trace, "walk.fat"), counts.get("frames"))
