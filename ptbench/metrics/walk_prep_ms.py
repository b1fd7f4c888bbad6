"""Host milliseconds a frame that the MT walk wrappers spend preparing the
walks: the self time of the program's `walk.prep` spans (padding,
coefficient packing, treelet boxes, the walk-table repack; the precull and
the copies that wait for the card are spans of their own) over the frames
of the traced window (walk wrappers layer)."""

from ptbench import program_spans


def read(trace, counts):
    return program_spans.per(program_spans.self_ms(trace, "walk.prep"), counts.get("frames"))
