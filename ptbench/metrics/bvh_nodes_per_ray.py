"""Node rows the fat-leaf BVH walk visits a ray handed to it: the program's
counter `walk.fat.nodes` (rows that walking lanes gathered, summed on the
device) over `walk.fat.rays`, in the traced window: the work the
traversal does (bvh walk layer)."""

from ptbench import program_spans


def read(trace, counts):
    return program_spans.per(program_spans.counter(trace, "walk.fat.nodes"),
                             program_spans.counter(trace, "walk.fat.rays"))
