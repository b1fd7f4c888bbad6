"""Ray-triangle pairs the MT walks evaluate a ray handed to them: the
program's counter `walk.pairs` (the evaluated subs of each tile, from the
kernels' own walk counts, times the triangles a sub and the lanes a tile)
over `walk.lanes`, in the traced window: the work the cull leaves (walk
kernels layer)."""

from ptbench import program_spans


def read(trace, counts):
    return program_spans.per(program_spans.counter(trace, "walk.pairs"),
                             program_spans.counter(trace, "walk.lanes"))
