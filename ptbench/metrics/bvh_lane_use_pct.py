"""Percent of the lanes the fat-leaf BVH walk steps that still walk: 100 x
the program's counter `walk.fat.nodes` over `walk.fat.lane_steps` (the
lanes held, summed over the steps), in the traced window: what the walk's
compaction rule leaves to lockstep (bvh walk layer)."""

from ptbench import program_spans


def read(trace, counts):
    share = program_spans.per(program_spans.counter(trace, "walk.fat.nodes"),
                              program_spans.counter(trace, "walk.fat.lane_steps"))
    return None if share is None else 100.0 * share
