"""Host waits on the card a frame: the program's counter `syncs` (one for
each wait inside a `sync` span) over the frames of the traced window
(frame layer)."""

from ptbench import program_spans


def read(trace, counts):
    return program_spans.per(program_spans.counter(trace, "syncs"), counts.get("frames"))
