"""Host milliseconds a frame blocked on the card: the self time of the
program's `sync` spans (the bounce loops' reads of `active.any()`, and the
copies from host memory that wait for the stream) over the frames of the
traced window (frame layer)."""

from ptbench import program_spans


def read(trace, counts):
    return program_spans.per(program_spans.self_ms(trace, "sync"), counts.get("frames"))
