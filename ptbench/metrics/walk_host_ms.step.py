"""Host milliseconds an optimiser step inside the program's `walk` spans
(the intersector calls of the forward's bounces, their preparation,
precull and launch included) over the steps of the traced window (walk
wrappers layer)."""

from ptbench import program_spans


def read(trace, counts):
    return program_spans.per(program_spans.total_ms(trace, "walk"), counts.get("steps"))
