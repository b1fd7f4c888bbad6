"""Host milliseconds a frame of the walks' precull (`_precull_live_subs`:
the slab tests of every ray against every sub or super box, the per-tile
reduction and sort): the self time of the program's `walk.precull` spans
over the frames of the traced window (walk wrappers layer)."""

from ptbench import program_spans


def read(trace, counts):
    return program_spans.per(program_spans.self_ms(trace, "walk.precull"), counts.get("frames"))
