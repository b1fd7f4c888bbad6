"""Steps of the fat-leaf BVH walk a frame (each step one lockstep round of
torch launches over the lanes it holds): the program's counter
`walk.fat.steps` over the frames of the traced window (bvh walk layer)."""

from ptbench import program_spans


def read(trace, counts):
    return program_spans.per(program_spans.counter(trace, "walk.fat.steps"),
                             counts.get("frames"))
